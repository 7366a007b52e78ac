"""Hypercomplex batch normalization with explicit running stats.

Counterpart of phc_gnn_tpu/nn/norm.py for ``naive-batch-norm``: n independent
BatchNorms, one per component, i.e. one BN per (component, feature) pair on
the input viewed as ``[N, n, d]``.  Parameters ``scale``/``bias`` and buffers
``mean``/``var`` have the feature shape ``(n, d)``.

The eval path normalises with the running mean and var (norm.py:130-132).
The training path (norm.py:78-129) normalises with the masked batch
statistics through the fused batch-norm kernels (``ops/fused_bn.py``), the
input ``[N, n, d]`` passed flat as ``[N, n*d]``, with JAX's size gate
(norm.py:92-95): the single-block pair D and E while the input's f32 bytes
are at most ``fused_bn.FUSED_BN_VMEM_LIMIT``, the row-blocked family F and G
above it (pcba's [4096, 2, 256]).  It updates the running stats in place as
torch's BatchNorm1d does:
``mean += 0.1 * (mu - mean)`` and ``var += 0.1 * (var_u - var)``
with the UNBIASED batch variance ``var_u = sigma^2 * cnt / max(cnt - 1, 1)``
(norm.py:12-19, :124-129).  ``cnt`` stays on the device: no host sync.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from phc_gnn_torch.ops import fused_bn

__all__ = ["PHMNorm"]

_MOMENTUM = 0.1  # torch BatchNorm1d's, as JAX's _BatchNorm uses it


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
        if not training:
            return (x - self.mean) * torch.rsqrt(self.var + self.eps) \
                * self.scale + self.bias
        if mask is None:
            mask = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
        kernel = (fused_bn.fused_masked_bn
                  if x.numel() * 4 <= fused_bn.FUSED_BN_VMEM_LIMIT
                  else fused_bn.fused_masked_bn_blocked)
        y, mean, var = kernel(
            x.reshape(x.shape[0], -1), mask, self.scale.reshape(-1),
            self.bias.reshape(-1), self.eps)
        with torch.no_grad():
            cnt = mask.sum(dtype=torch.float32).clamp_min(1.0)
            var_u = var * (cnt / (cnt - 1.0).clamp_min(1.0))
            self.mean.lerp_(mean.view(self.mean.shape), _MOMENTUM)
            self.var.lerp_(var_u.view(self.var.shape), _MOMENTUM)
        return y.view(x.shape)


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
