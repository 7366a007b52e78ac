"""Masked batch norm in training mode: the statistics, the normalised output
and the analytic backward.

Hopper kernels (``csrc/fused_bn.cu``), each beside its plain PyTorch version
with the same masking semantics.  The pair for inputs up to
``FUSED_BN_VMEM_LIMIT``, one launch of a grid of thread-block clusters each
(a cluster owns a slab of columns, its CTAs split the rows and meet through
distributed shared memory; ``bn_plan`` computes the launch):

- ``bn_forward`` replaces ``_bn_fwd_kernel`` (phc_gnn_tpu/ops/fused_bn.py:50):
  over the rows where ``mask`` holds, the mean and the biased, centred
  variance of every column, then ``y = (x - mean) * rsqrt(var + eps) * scale
  + bias`` on EVERY row;
- ``bn_backward`` replaces ``_bn_bwd_kernel`` (:64): ``dbias = sum g`` and
  ``dscale = sum g * xhat`` over ALL rows, and ``dx = scale * r * (g - m *
  (dbias + xhat * dscale) / cnt)``, where only the row's own mask gates the
  statistics term (:18-22).

The row-blocked pair, for inputs past ``FUSED_BN_VMEM_LIMIT``, computes the
same function (the TPU needs it only for VMEM): the same cluster kernels on
the same plan, whose passes take in the elementwise work that JAX leaves to
XLA beside its Pallas kernels, counted apart:

- ``bn_forward_blocked`` replaces ``_bn_stats_blocked_kernel`` (:162), whose
  row blocks JAX combines with Chan's formula, and the normalise beside it
  (:282-286);
- ``bn_backward_blocked`` replaces ``_bn_bwd_sums_blocked_kernel`` (:202),
  ``sum g`` and ``sum g * xhat`` over ALL rows, and the dx beside it
  (:295-302).

``cnt = max(sum mask, 1)``, so an all-masked input gives finite outputs.
``fused_masked_bn`` (D, E) and ``fused_masked_bn_blocked`` (F, G) are
``autograd.Function``s that return ``(y, mean, var)``; mean and var are
detached, as in JAX (:105-110): they feed the running statistics, never a
gradient.

``FUSED_BN_VMEM_LIMIT`` is JAX's size gate between the two families
(:43): the TPU needs it for VMEM, and the port keeps the same gate so that
both packages run the same kernel family at each shape (``nn/norm.py``).

A wrapper runs the plain version for tensors on the CPU.  For CUDA tensors it
launches its kernel or raises; it never falls back.  ``<wrapper>.launches``
counts the launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from phc_gnn_torch.ops import _build

__all__ = ["FUSED_BN_VMEM_LIMIT", "BnPlan", "bn_plan", "bn_forward",
           "bn_forward_plain", "bn_backward", "bn_backward_plain",
           "fused_masked_bn", "bn_forward_blocked", "bn_forward_blocked_plain",
           "bn_backward_blocked", "bn_backward_blocked_plain",
           "bn_stats_blocked_plain", "bn_normalize_plain",
           "bn_bwd_sums_blocked_plain", "bn_dx_plain",
           "fused_masked_bn_blocked"]

# bytes of x up to which training BN takes the cluster pair (D, E);
# above it, the row-blocked family (phc_gnn_tpu/ops/fused_bn.py:43)
FUSED_BN_VMEM_LIMIT = 3_500_000

# the launch plan (csrc/fused_bn.cu holds the same constants)
BN_SLAB_COLS = 16           # columns a cluster owns: 64 bytes a row
BN_MAX_CLUSTER = 8          # CTAs a cluster, the portable limit
BN_MIN_ROWS = 256           # a cluster grows only while each CTA keeps these
BN_TILE_BYTES = 200 * 1024  # dynamic shared memory a CTA, at most
BN_STATIC_SMEM = 4096       # the reductions' static shared memory, at most
_SMS = 132                  # H100 SXM


class BnPlan(NamedTuple):
    """The launch of D, E, F or G: ``grid`` CTAs in clusters of ``cluster``,
    one cluster a slab of ``slab_cols`` columns; the CTA of rank r owns the
    rows ``[r * rows_per_cta, min(n, (r + 1) * rows_per_cta))`` and walks
    them in chunks of ``chunk_rows`` staged in ``smem_bytes`` of dynamic
    shared memory (the slab's rows of each tensor, then their mask bytes)."""
    slab_cols: int
    cluster: int
    rows_per_cta: int
    chunk_rows: int
    smem_bytes: int
    grid: int


@functools.lru_cache(maxsize=256)
def bn_plan(n: int, d: int, tensors: int = 1) -> BnPlan:
    """The launch plan of the forward (``tensors=1``: x staged) or the
    backward (2: x and g) at ``[n, d]``: enough clusters to fill the card's
    132 SMs, but no CTA under ``BN_MIN_ROWS`` rows while the cluster is
    above 1, and every CTA's rows in shared memory where they fit in
    ``BN_TILE_BYTES``."""
    slabs = max(1, -(-d // BN_SLAB_COLS))
    cluster = max(1, min(BN_MAX_CLUSTER, -(-_SMS // slabs),
                         -(-n // BN_MIN_ROWS)))
    rows = -(-n // cluster)
    row_bytes = BN_SLAB_COLS * 4 * tensors + 1  # the slab's floats, a mask byte
    chunk = max(1, min(rows, BN_TILE_BYTES // row_bytes))
    return BnPlan(BN_SLAB_COLS, cluster, rows, chunk,
                  -(-chunk * row_bytes // 16) * 16, slabs * cluster)


_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_F32 = ctypes.c_float
_typed_lib = None


def _lib():
    global _typed_lib
    if _typed_lib is None:
        lib = _build.load("fused_bn")
        lib.fused_bn_forward_f32.argtypes = [
            _P, _P, _P, _P, _F32, _P, _P, _P] + [_I64] * 7 + [_P]
        lib.fused_bn_forward_f32.restype = ctypes.c_int
        lib.fused_bn_backward_f32.argtypes = [
            _P, _P, _P, _P, _P, _F32, _P, _P, _P, _P] + [_I64] * 7 + [_P]
        lib.fused_bn_backward_f32.restype = ctypes.c_int
        lib.bn_max_active_clusters.argtypes = [_I64] * 3 + [
            ctypes.POINTER(ctypes.c_int)]
        lib.bn_max_active_clusters.restype = ctypes.c_int
        _typed_lib = lib
    return _typed_lib


def _max_active_clusters(plan: BnPlan, tensors: int) -> int:
    """How many clusters of ``plan`` the current CUDA device holds at once
    for the forward (``tensors=1``) or the backward (2)
    (``cudaOccupancyMaxActiveClusters``); a grid of more clusters runs in
    waves.  A check of the plan for the card's tests; no path calls it."""
    out = ctypes.c_int()
    err = _lib().bn_max_active_clusters(tensors, plan.cluster,
                                        plan.smem_bytes, ctypes.byref(out))
    _build.check_launch("bn_max_active_clusters", err)
    return out.value


# ------------------------------------------------------------ plain versions

def _count(mask):
    return mask.sum(dtype=torch.float32).clamp_min(1.0)


def bn_stats_blocked_plain(x, mask):
    """``(mean [D], var [D], cnt [1])`` over the live rows: the mean, then
    the centred, biased variance (two passes, never E[x^2] - E[x]^2).  The
    kernel's row blocks and Chan combine give the same to rounding."""
    m = mask[:, None]
    cnt = _count(mask)
    mean = torch.where(m, x, 0.0).sum(0) / cnt
    xc = torch.where(m, x - mean, 0.0)
    return mean, (xc * xc).sum(0) / cnt, cnt.reshape(1)


def bn_normalize_plain(x, mean, var, scale, bias, eps: float):
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def bn_bwd_sums_blocked_plain(x, g, mean, var, eps: float):
    """``(sum g [D], sum g * xhat [D])`` over ALL rows."""
    xhat = (x - mean) * torch.rsqrt(var + eps)
    return g.sum(0), (g * xhat).sum(0)


def bn_dx_plain(x, mask, g, scale, mean, var, eps: float, sum_g, sum_gx, cnt):
    r = torch.rsqrt(var + eps)
    xhat = (x - mean) * r
    stats = torch.where(mask[:, None], (sum_g + xhat * sum_gx) / cnt, 0.0)
    return scale * r * (g - stats)


def bn_forward_plain(x, mask, scale, bias, eps: float):
    mean, var, _ = bn_stats_blocked_plain(x, mask)
    return bn_normalize_plain(x, mean, var, scale, bias, eps), mean, var


def bn_backward_plain(x, mask, scale, mean, var, eps: float, g):
    sum_g, sum_gx = bn_bwd_sums_blocked_plain(x, g, mean, var, eps)
    dx = bn_dx_plain(x, mask, g, scale, mean, var, eps, sum_g, sum_gx,
                     _count(mask))
    return dx, sum_gx, sum_g


# both families compute the same function: F with its normalise is D's, G
# with its dx is E's
bn_forward_blocked_plain = bn_forward_plain
bn_backward_blocked_plain = bn_backward_plain


# ------------------------------------------------------------------ wrappers

def _check(x, mask, vectors, g=None):
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"the batch-norm kernels run on CPU or CUDA tensors, "
                         f"got {dev}")
    if x.dtype != torch.float32 or x.ndim != 2:
        raise TypeError(f"x must be a 2-D float32 tensor, got {x.dtype} "
                        f"{tuple(x.shape)}")
    tensors = [("x", x), ("mask", mask)] + list(vectors)
    if mask.dtype != torch.bool or mask.shape != x.shape[:1]:
        raise TypeError(f"mask must be bool [{x.shape[0]}], got "
                        f"{mask.dtype} {tuple(mask.shape)}")
    if g is not None:
        if g.dtype != torch.float32 or g.shape != x.shape:
            raise TypeError(f"g must be float32 {tuple(x.shape)}, got "
                            f"{g.dtype} {tuple(g.shape)}")
        tensors.append(("g", g))
    for name, t in vectors:
        if t.dtype != torch.float32 or t.shape != x.shape[1:]:
            raise TypeError(f"{name} must be float32 [{x.shape[1]}], got "
                            f"{t.dtype} {tuple(t.shape)}")
    for name, t in tensors:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_rows(n: int) -> None:
    if n >= 2 ** 31:
        raise ValueError(f"the batch-norm kernels take fewer than 2^31 rows, "
                         f"got {n}")


def _forward(name: str, x, mask, scale, bias, eps: float):
    _check(x, mask, (("scale", scale), ("bias", bias)))
    n, d = x.shape
    _check_rows(n)
    y = torch.empty_like(x)
    mean = torch.empty((d,), dtype=torch.float32, device=x.device)
    var = torch.empty_like(mean)
    _build.check_launch(name, _lib().fused_bn_forward_f32(
        x.data_ptr(), mask.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        eps, y.data_ptr(), mean.data_ptr(), var.data_ptr(), n, d,
        *bn_plan(n, d, 1)[:5], _build.stream(x.device)))
    return y, mean, var


def _backward(name: str, x, mask, scale, mean, var, eps: float, g):
    _check(x, mask, (("scale", scale), ("mean", mean), ("var", var)), g)
    n, d = x.shape
    _check_rows(n)
    dx = torch.empty_like(x)
    dscale = torch.empty((d,), dtype=torch.float32, device=x.device)
    dbias = torch.empty_like(dscale)
    _build.check_launch(name, _lib().fused_bn_backward_f32(
        x.data_ptr(), mask.data_ptr(), scale.data_ptr(), mean.data_ptr(),
        var.data_ptr(), eps, g.data_ptr(), dx.data_ptr(), dscale.data_ptr(),
        dbias.data_ptr(), n, d, *bn_plan(n, d, 2)[:5],
        _build.stream(x.device)))
    return dx, dscale, dbias


def bn_forward(x, mask, scale, bias, eps: float):
    """``(y [N, D], mean [D], var [D])`` of the masked batch norm of ``x``
    (kernel D)."""
    if x.device.type == "cpu":
        return bn_forward_plain(x, mask, scale, bias, eps)
    out = _forward("bn_forward", x, mask, scale, bias, eps)
    bn_forward.launches += 1
    return out


bn_forward.launches = 0


def bn_backward(x, mask, scale, mean, var, eps: float, g):
    """``(dx [N, D], dscale [D], dbias [D])`` given the forward's ``mean``
    and ``var`` and the cotangent ``g`` of ``y`` (kernel E)."""
    if x.device.type == "cpu":
        return bn_backward_plain(x, mask, scale, mean, var, eps, g)
    out = _backward("bn_backward", x, mask, scale, mean, var, eps, g)
    bn_backward.launches += 1
    return out


bn_backward.launches = 0


def bn_forward_blocked(x, mask, scale, bias, eps: float):
    """``bn_forward``'s launch counted as F with its normalise fused in: the
    same kernel on the same plan."""
    if x.device.type == "cpu":
        return bn_forward_blocked_plain(x, mask, scale, bias, eps)
    out = _forward("bn_forward_blocked", x, mask, scale, bias, eps)
    bn_forward_blocked.launches += 1
    return out


bn_forward_blocked.launches = 0


def bn_backward_blocked(x, mask, scale, mean, var, eps: float, g):
    """``bn_backward``'s launch counted as G with its dx fused in: the same
    kernel on the same plan."""
    if x.device.type == "cpu":
        return bn_backward_blocked_plain(x, mask, scale, mean, var, eps, g)
    out = _backward("bn_backward_blocked", x, mask, scale, mean, var, eps,
                    g)
    bn_backward_blocked.launches += 1
    return out


bn_backward_blocked.launches = 0


class _FusedMaskedBN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mask, scale, bias, eps, blocked):
        fwd = bn_forward_blocked if blocked else bn_forward
        y, mean, var = fwd(x, mask, scale, bias, eps)
        ctx.save_for_backward(x, mask, scale, mean, var)
        ctx.eps = eps
        ctx.blocked = blocked
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        x, mask, scale, mean, var = ctx.saved_tensors
        bwd = bn_backward_blocked if ctx.blocked else bn_backward
        dx, dscale, dbias = bwd(x, mask, scale, mean, var, ctx.eps,
                                gy.contiguous())
        return dx, None, dscale, dbias, None, None


def _apply(x, mask, scale, bias, eps, blocked: bool):
    if mask is None:
        mask = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
    return _FusedMaskedBN.apply(x, mask, scale, bias, float(eps), blocked)


def fused_masked_bn(x, mask: Optional[torch.Tensor], scale, bias,
                    eps: float = 1e-5):
    """Training-mode masked batch norm over axis 0 of ``x`` [N, D]:
    ``(y, mean [D], var [D])``, differentiable in ``x``, ``scale`` and
    ``bias``; ``mean`` and ``var`` (biased) are detached.  ``mask=None``
    counts every row."""
    return _apply(x, mask, scale, bias, eps, False)


def fused_masked_bn_blocked(x, mask: Optional[torch.Tensor], scale, bias,
                            eps: float = 1e-5):
    """The contract of ``fused_masked_bn`` through the row-blocked kernels
    F and G (one launch each way), for any [N, D]."""
    return _apply(x, mask, scale, bias, eps, True)
