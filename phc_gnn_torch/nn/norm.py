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
Gamma and beta, as JAX's eval path is (one launch backward: the frozen
variant of L, writing dx in its sweep, or of M where only dx is needed).
Neither path syncs with the host, so the eval forward can be captured in a
CUDA graph.

``stat_axis`` (a mesh axis name, set by ``PHCGNN(node_axis=...)`` on the
norms of its layers) takes the training statistics over the node shards of
that axis: the masked count and sums are ``psum``-ed (``parallel.mesh``,
differentiable: its backward sums the cotangents over the shards, as JAX's
psum transposes to a psum), so every shard normalises with the statistics
of the whole batch.  As in JAX (norm.py:83-121, :284-321: the kernels only
where ``stat_axis`` is None) that path is the inline formula, two passes
for the naive norms and the component-slice whitening with its closed-form
Cholesky, not kernels D-G or J-M.

Under the model's bf16 ``compute_dtype`` every norm computes in float32, as
JAX's do (norm.py:58-59, :133, :243, :299, :345): the input is upcast, the
float32 kernels run unchanged, and the output is cast back to the input's
dtype; the gradient reaching the input is cast the same way.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Tuple

import torch
from torch import nn

from phc_gnn_torch.ops import fused_bn, fused_whitening
from phc_gnn_torch.ops.segment_sum import upcast
from phc_gnn_torch.parallel import mesh

__all__ = ["PHMNorm", "QuaternionWhiteningNorm", "frozen_running_stats"]

_MOMENTUM = 0.1  # torch BatchNorm1d's, as JAX's _BatchNorm uses it


_STATE = threading.local()


@contextlib.contextmanager
def frozen_running_stats():
    """Inside the block, training-mode norms normalise with their batch
    statistics as always but leave their running statistics as they are:
    the recompute of a rematerialized layer (``PHCGNN(remat=True)``), whose
    forward already updated them once, as JAX's ``nn.remat`` keeps one
    update.  Thread-local: the recompute runs in the backward's thread."""
    before = getattr(_STATE, "frozen", False)
    _STATE.frozen = True
    try:
        yield
    finally:
        _STATE.frozen = before


def _update_stats() -> bool:
    return not getattr(_STATE, "frozen", False)


class _BatchNorm(nn.Module):
    """BN core over the leading batch axis; feature shape = input.shape[1:]."""

    def __init__(self, feat_shape: Tuple[int, ...], eps: float = 1e-5,
                 stat_axis: Optional[str] = None):
        super().__init__()
        self.eps = eps
        self.stat_axis = stat_axis
        self.register_buffer("mean", torch.zeros(feat_shape))
        self.register_buffer("var", torch.ones(feat_shape))
        self.scale = nn.Parameter(torch.ones(feat_shape))
        self.bias = nn.Parameter(torch.zeros(feat_shape))

    def forward(self, x: torch.Tensor, training: bool = False,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        in_dtype = x.dtype
        x = upcast(x)
        if not training:
            return ((x - self.mean) * torch.rsqrt(self.var + self.eps)
                    * self.scale + self.bias).to(in_dtype)
        if mask is None:
            mask = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
        if self.stat_axis is not None:
            return self._cross_shard(x, mask).to(in_dtype)
        kernel = (fused_bn.fused_masked_bn
                  if x.numel() * 4 <= fused_bn.FUSED_BN_VMEM_LIMIT
                  else fused_bn.fused_masked_bn_blocked)
        y, mean, var = kernel(
            x.reshape(x.shape[0], -1), mask, self.scale.reshape(-1),
            self.bias.reshape(-1), self.eps)
        self._update(mean, var, mask.sum(dtype=torch.float32).clamp_min(1.0))
        return y.view(x.shape).to(in_dtype)

    def _cross_shard(self, x, mask):
        """The training forward over the node shards of ``stat_axis``: the
        two-pass masked mean and biased var of the whole batch
        (norm.py:96-121)."""
        ax = mesh.axis(self.stat_axis)
        m = mask.reshape((-1,) + (1,) * (x.ndim - 1)).to(x.dtype)
        cnt = mesh.all_reduce(m.sum(), ax).clamp_min(1.0)
        mean = mesh.psum((x * m).sum(0), ax) / cnt
        xc = (x - mean) * m
        var = mesh.psum((xc * xc).sum(0), ax) / cnt
        self._update(mean.detach(), var.detach(), cnt)
        return (x - mean) * torch.rsqrt(var + self.eps) * self.scale + self.bias

    def _update(self, mean, var, cnt):
        """The running stats' step toward the batch's ``mean`` and the
        unbiased ``var`` of ``cnt`` rows, unless frozen."""
        if _update_stats():
            with torch.no_grad():
                var_u = var * (cnt / (cnt - 1.0).clamp_min(1.0))
                self.mean.lerp_(mean.view(self.mean.shape), _MOMENTUM)
                self.var.lerp_(var_u.view(self.var.shape), _MOMENTUM)


class QuaternionWhiteningNorm(nn.Module):
    """Quaternion whitening batch norm of ``d`` features ('q-batch-norm'):
    the input is ``[N, 4d]`` component-major or ``[N, 4, d]``, and the
    output has the input's shape.  Parameters ``gamma`` (4, 4, d) and
    ``beta`` (4, d), buffers ``mean`` (4, d) and ``cov`` (4, 4, d), named as
    the flax module's."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 stat_axis: Optional[str] = None):
        super().__init__()
        d = num_features
        self.eps = eps
        self.stat_axis = stat_axis
        self.register_buffer("mean", torch.zeros(4, d))
        self.register_buffer("cov", torch.ones(4, 4, d))
        self.gamma = nn.Parameter(
            (0.5 * torch.eye(4))[..., None].expand(4, 4, d).contiguous())
        self.beta = nn.Parameter(torch.zeros(4, d))

    def forward(self, x: torch.Tensor, training: bool = False,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        in_dtype = x.dtype
        flat = upcast(x.reshape(x.shape[0], -1))
        if training and self.stat_axis is not None:
            return self._cross_shard(flat, mask).view(x.shape).to(in_dtype)
        if training:
            y, mean, cov = fused_whitening.fused_whitening(
                flat, mask, self.gamma, self.beta, self.eps)
            if _update_stats():
                with torch.no_grad():
                    self.mean.lerp_(mean, _MOMENTUM)
                    self.cov.lerp_(cov, _MOMENTUM)
            return y.view(x.shape).to(in_dtype)
        return fused_whitening.eval_whitening(
            flat, self.mean, self.cov, self.gamma, self.beta,
            self.eps).view(x.shape).to(in_dtype)

    def _cross_shard(self, x, mask):
        """The training forward over the node shards of ``stat_axis``
        (norm.py:284-321): the masked means and biased covariance of the
        whole batch from psum-ed component-slice sums, the closed-form
        Cholesky of ``cov + eps I``, ``z = L^{-1} (x - mean)`` and
        ``y = Gamma z + beta`` on every row."""
        ax = mesh.axis(self.stat_axis)
        fw = fused_whitening
        c = fw._slices(x)
        if mask is None:
            mask = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
        m = mask[:, None].to(x.dtype)
        cnt = mesh.all_reduce(m.sum(), ax).clamp_min(1.0)
        mean = mesh.psum(torch.stack([(ck * m).sum(0) for ck in c]), ax) / cnt
        cm = [(ck - mu) * m for ck, mu in zip(c, mean)]
        pairs = [(j, k) for j in range(4) for k in range(j, 4)]
        sums = mesh.psum(torch.stack([(cm[j] * cm[k]).sum(0)
                                      for j, k in pairs]), ax) / cnt
        cov = dict(zip(pairs, sums))
        if _update_stats():
            with torch.no_grad():
                self.mean.lerp_(mean, _MOMENTUM)
                self.cov.lerp_(fw._stack_cov(cov), _MOMENTUM)
        lf = fw._chol_fields(cov, self.eps)
        zs = fw._fwd_subst(lf, [ck - mu for ck, mu in zip(c, mean)],
                           fw._inv_diag(lf))
        return torch.cat([sum(self.gamma[cc, k] * zs[k] for k in range(4))
                          + self.beta[cc] for cc in range(4)], dim=1)


class PHMNorm(nn.Module):
    """Norm dispatch on ``norm_type``; ``num_features`` is the flat size
    ``n * d``."""

    def __init__(self, num_features: int, phm_dim: int,
                 norm_type: str = "naive-batch-norm", eps: float = 1e-5,
                 stat_axis: Optional[str] = None):
        super().__init__()
        self.norm_type = norm_type
        if norm_type == "q-batch-norm":
            if phm_dim != 4:
                raise ValueError(f"q-batch-norm requires phm_dim=4, got "
                                 f"{phm_dim}")
            self.qbn = QuaternionWhiteningNorm(num_features // 4, eps,
                                               stat_axis)
        elif norm_type == "naive-batch-norm":
            self.bn = _BatchNorm((phm_dim, num_features // phm_dim), eps,
                                 stat_axis)
        elif norm_type == "naive-naive-batch-norm":
            self.bn = _BatchNorm((num_features,), eps, stat_axis)
        else:
            raise ValueError(f"unknown norm_type {norm_type!r}")

    def forward(self, x: torch.Tensor, training: bool = False,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.norm_type == "q-batch-norm":
            return self.qbn(x, training=training, mask=mask)
        return self.bn(x.reshape((x.shape[0],) + self.bn.mean.shape),
                       training=training, mask=mask).reshape(x.shape)
