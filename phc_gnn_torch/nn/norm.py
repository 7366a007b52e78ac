"""Hypercomplex batch normalization with explicit running stats.

Counterpart of phc_gnn_tpu/nn/norm.py, dispatched by ``PHMNorm`` on
``norm_type`` (norm.py:136-180):

- ``naive-batch-norm``: n independent BatchNorms, one per component, i.e.
  one BN per (component, feature) pair on the input viewed as ``[N, n, d]``;
  parameters ``scale``/``bias`` and buffers ``mean``/``var`` of shape
  ``(n, d)``;
- ``naive-naive-batch-norm``: one BatchNorm over the flat ``n*d`` vector,
  the same ``_BatchNorm`` with feature shape ``(n*d,)``;
- ``q-batch-norm`` (phm_dim 4 only): ``QuaternionWhiteningNorm``
  (norm.py:216-345), held as ``qbn``.

``_BatchNorm``: the eval path normalises with the running mean and var
(norm.py:130-132).  The training path (norm.py:78-129) normalises with the
masked batch statistics through the fused batch-norm kernels
(``ops/fused_bn.py``), the input passed flat as ``[N, n*d]``, with JAX's size
gate (norm.py:92-95): the cluster pair D and E while the input's f32
bytes are at most ``fused_bn.FUSED_BN_VMEM_LIMIT``, the row-blocked family F
and G above it (pcba's [4096, 2, 256]).  It updates the running stats in
place as torch's BatchNorm1d does:
``mean += 0.1 * (mu - mean)`` and ``var += 0.1 * (var_u - var)``
with the UNBIASED batch variance ``var_u = sigma^2 * cnt / max(cnt - 1, 1)``
(norm.py:12-19, :124-129).  ``cnt`` stays on the device: no host sync.

``QuaternionWhiteningNorm`` whitens each feature's 4-vector: training goes
through ``ops/fused_whitening.py::fused_whitening`` (kernels J, K and, in the
backward, L and M), then ``mean += 0.1 * (mu - mean)`` and
``cov += 0.1 * (Sigma - cov)`` with the BIASED batch covariance; the running
cov starts as all ones (norm.py:248-255, :295-298), Gamma as 0.5 I, beta as
0.  Eval whitens with the running stats (norm.py:301-345) through
``fused_whitening.eval_whitening``: one launch of kernel K that factors
``cov + eps I`` in its prologue and whitens; it is differentiable in the input,
Gamma and beta, as JAX's eval path is (the frozen variants of L and M).
Neither path syncs with the host, so the eval forward can be captured in a
CUDA graph.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from phc_gnn_torch.ops import fused_bn, fused_whitening

__all__ = ["PHMNorm", "QuaternionWhiteningNorm"]

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


class QuaternionWhiteningNorm(nn.Module):
    """Quaternion whitening batch norm of ``d`` features ('q-batch-norm'):
    the input is ``[N, 4d]`` component-major or ``[N, 4, d]``, and the
    output has the input's shape.  Parameters ``gamma`` (4, 4, d) and
    ``beta`` (4, d), buffers ``mean`` (4, d) and ``cov`` (4, 4, d), named as
    the flax module's."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        d = num_features
        self.eps = eps
        self.register_buffer("mean", torch.zeros(4, d))
        self.register_buffer("cov", torch.ones(4, 4, d))
        self.gamma = nn.Parameter(
            (0.5 * torch.eye(4))[..., None].expand(4, 4, d).contiguous())
        self.beta = nn.Parameter(torch.zeros(4, d))

    def forward(self, x: torch.Tensor, training: bool = False,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        flat = x.reshape(x.shape[0], -1)
        if training:
            y, mean, cov = fused_whitening.fused_whitening(
                flat, mask, self.gamma, self.beta, self.eps)
            with torch.no_grad():
                self.mean.lerp_(mean, _MOMENTUM)
                self.cov.lerp_(cov, _MOMENTUM)
            return y.view(x.shape)
        return fused_whitening.eval_whitening(
            flat, self.mean, self.cov, self.gamma, self.beta,
            self.eps).view(x.shape)


class PHMNorm(nn.Module):
    """Norm dispatch on ``norm_type``; ``num_features`` is the flat size
    ``n * d``."""

    def __init__(self, num_features: int, phm_dim: int,
                 norm_type: str = "naive-batch-norm", eps: float = 1e-5):
        super().__init__()
        self.norm_type = norm_type
        if norm_type == "q-batch-norm":
            if phm_dim != 4:
                raise ValueError(f"q-batch-norm requires phm_dim=4, got "
                                 f"{phm_dim}")
            self.qbn = QuaternionWhiteningNorm(num_features // 4, eps)
        elif norm_type == "naive-batch-norm":
            self.bn = _BatchNorm((phm_dim, num_features // phm_dim), eps)
        elif norm_type == "naive-naive-batch-norm":
            self.bn = _BatchNorm((num_features,), eps)
        else:
            raise ValueError(f"unknown norm_type {norm_type!r}")

    def forward(self, x: torch.Tensor, training: bool = False,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.norm_type == "q-batch-norm":
            return self.qbn(x, training=training, mask=mask)
        return self.bn(x.reshape((x.shape[0],) + self.bn.mean.shape),
                       training=training, mask=mask).reshape(x.shape)
