"""Hypercomplex batch normalization with explicit running stats.

Counterpart of phc_gnn_tpu/nn/norm.py for ``naive-batch-norm``: n independent
BatchNorms, one per component, i.e. one BN per (component, feature) pair on
the input viewed as ``[N, n, d]``.  Parameters ``scale``/``bias`` and buffers
``mean``/``var`` have the feature shape ``(n, d)``.

The eval path normalises with the running mean and var (norm.py:130-132).
The training path, with its masked batch statistics, comes with the fused
batch-norm kernels (D and E) in the training slice of the port.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

__all__ = ["PHMNorm"]

_TRAINING_TODO = ("training-mode batch norm is not ported yet: it lands with "
                  "the fused batch-norm kernels D and E in the training slice "
                  "(ROADMAP.md, section 1, item 6)")


class _BatchNorm(nn.Module):
    """BN core over the leading batch axis; feature shape = input.shape[1:]."""

    def __init__(self, feat_shape: Tuple[int, ...], eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("mean", torch.zeros(feat_shape))
        self.register_buffer("var", torch.ones(feat_shape))
        self.scale = nn.Parameter(torch.ones(feat_shape))
        self.bias = nn.Parameter(torch.zeros(feat_shape))

    def forward(self, x: torch.Tensor, training: bool = False,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if training:
            raise NotImplementedError(_TRAINING_TODO)
        return (x - self.mean) * torch.rsqrt(self.var + self.eps) \
            * self.scale + self.bias


class PHMNorm(nn.Module):
    """Norm dispatch on ``norm_type``; ``num_features`` is the flat size
    ``n * d``."""

    def __init__(self, num_features: int, phm_dim: int,
                 norm_type: str = "naive-batch-norm", eps: float = 1e-5):
        super().__init__()
        if norm_type != "naive-batch-norm":
            raise NotImplementedError(
                f"norm_type {norm_type!r} is not ported yet (ROADMAP.md, "
                f"section 1, item 10)")
        self.phm_dim = phm_dim
        self.bn = _BatchNorm((phm_dim, num_features // phm_dim), eps)

    def forward(self, x: torch.Tensor, training: bool = False,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        xs = x.reshape(x.shape[0], self.phm_dim, -1)
        return self.bn(xs, training=training, mask=mask).reshape(x.shape)
