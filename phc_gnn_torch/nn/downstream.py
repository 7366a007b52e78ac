"""PHM downstream feed-forward head predicting a real-valued vector.

Counterpart of phc_gnn_tpu/nn/downstream.py: PHM layers ``affine_<i>``
(input -> hidden... -> n * target_dim), each hidden one followed by
``norm_<i>``, the activation and, in training, dropout (downstream.py:55-69),
closed by a RealTransformer.  Under a bf16 ``dtype`` the PHM layers run in
bf16 and the RealTransformer takes their output cast to float32
(downstream.py:72).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
from torch import nn

from phc_gnn_torch.nn.activations import get_activation
from phc_gnn_torch.nn.dropout import phm_dropout
from phc_gnn_torch.nn.norm import PHMNorm
from phc_gnn_torch.nn.phm_linear import PHMLinear, RealTransformer
from phc_gnn_torch.ops.segment_sum import upcast

__all__ = ["PHMDownstreamNet"]


class PHMDownstreamNet(nn.Module):
    """Hypercomplex FFN -> real output
    (reference: phc/hypercomplex/downstream.py:19-130)."""

    def __init__(self, in_features: int, hidden_layers: Sequence[int],
                 out_features: int, phm_dim: int, activation: str = "relu",
                 bias: bool = True, norm: Optional[str] = None,
                 w_init: str = "phm", c_init: str = "standard",
                 learn_phm: bool = True, real_trafo: str = "linear",
                 dropout: Union[float, Sequence[float]] = 0.1,
                 same_dropout: bool = False,
                 generator: Optional[torch.Generator] = None,
                 shared_rule: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        n = phm_dim
        self.dropout = ([float(dropout)] * len(hidden_layers)
                        if isinstance(dropout, (int, float))
                        else [float(p) for p in dropout])
        if len(self.dropout) != len(hidden_layers):
            raise ValueError("dropout needs one rate per hidden layer")
        self.phm_dim = n
        self.same_dropout = same_dropout
        sizes = [in_features] + list(hidden_layers) + [n * out_features]
        self.num_layers = len(sizes) - 1
        self.act = get_activation(activation)
        self.has_norm = norm not in (None, "None")
        for i in range(self.num_layers):
            self.add_module(f"affine_{i}", PHMLinear(
                sizes[i], sizes[i + 1], n, bias, w_init, c_init, learn_phm,
                generator, shared_rule, dtype))
            if i < self.num_layers - 1 and self.has_norm:
                self.add_module(f"norm_{i}", PHMNorm(sizes[i + 1], n, norm))
        self.real_trafo = RealTransformer(real_trafo, n * out_features, n,
                                          bias=True, generator=generator)

    def forward(self, x: torch.Tensor, training: bool = False,
                mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                phm_rule: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``generator`` draws the dropout masks in training; ``phm_rule``
        is the network's shared rule (``shared_rule``)."""
        for i in range(self.num_layers):
            x = getattr(self, f"affine_{i}")(x, phm_rule)
            if i < self.num_layers - 1:  # hidden layers only
                if self.has_norm:
                    x = getattr(self, f"norm_{i}")(x, training=training,
                                                   mask=mask)
                x = self.act(x)
                x = phm_dropout(x, self.dropout[i], self.phm_dim, generator,
                                training=training, same=self.same_dropout)
        return self.real_trafo(upcast(x))
