"""PHM downstream feed-forward head predicting a real-valued vector.

Counterpart of phc_gnn_tpu/nn/downstream.py: PHM layers ``affine_<i>``
(input -> hidden... -> n * target_dim), each hidden one followed by
``norm_<i>`` and the activation, closed by a RealTransformer.  Eval mode:
dropout is the identity.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from phc_gnn_torch.nn.activations import get_activation
from phc_gnn_torch.nn.norm import PHMNorm
from phc_gnn_torch.nn.phm_linear import PHMLinear, RealTransformer

__all__ = ["PHMDownstreamNet"]


class PHMDownstreamNet(nn.Module):
    """Hypercomplex FFN -> real output
    (reference: phc/hypercomplex/downstream.py:19-130)."""

    def __init__(self, in_features: int, hidden_layers: Sequence[int],
                 out_features: int, phm_dim: int, activation: str = "relu",
                 bias: bool = True, norm: Optional[str] = None,
                 w_init: str = "phm", c_init: str = "standard",
                 learn_phm: bool = True, real_trafo: str = "linear",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        n = phm_dim
        sizes = [in_features] + list(hidden_layers) + [n * out_features]
        self.num_layers = len(sizes) - 1
        self.act = get_activation(activation)
        self.has_norm = norm not in (None, "None")
        for i in range(self.num_layers):
            self.add_module(f"affine_{i}", PHMLinear(
                sizes[i], sizes[i + 1], n, bias, w_init, c_init, learn_phm,
                generator))
            if i < self.num_layers - 1 and self.has_norm:
                self.add_module(f"norm_{i}", PHMNorm(sizes[i + 1], n, norm))
        self.real_trafo = RealTransformer(real_trafo, n * out_features, n,
                                          bias=True, generator=generator)

    def forward(self, x: torch.Tensor, training: bool = False,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"affine_{i}")(x)
            if i < self.num_layers - 1:  # hidden layers only
                if self.has_norm:
                    x = getattr(self, f"norm_{i}")(x, training=training,
                                                   mask=mask)
                x = self.act(x)
        return self.real_trafo(x)
