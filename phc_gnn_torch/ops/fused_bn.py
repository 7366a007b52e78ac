"""Masked batch norm in training mode: the statistics, the normalised output
and the analytic backward.

Two Hopper kernels (``csrc/fused_bn.cu``), each beside its plain PyTorch
version with the same masking semantics:

- ``bn_forward`` replaces ``_bn_fwd_kernel`` (phc_gnn_tpu/ops/fused_bn.py:50):
  over the rows where ``mask`` holds, the mean and the biased, centred
  variance of every column, then ``y = (x - mean) * rsqrt(var + eps) * scale
  + bias`` on EVERY row;
- ``bn_backward`` replaces ``_bn_bwd_kernel`` (:64): ``dbias = sum g`` and
  ``dscale = sum g * xhat`` over ALL rows, and ``dx = scale * r * (g - m *
  (dbias + xhat * dscale) / cnt)``, where only the row's own mask gates the
  statistics term (:18-22).

``cnt = max(sum mask, 1)``, so an all-masked input gives finite outputs.
``fused_masked_bn`` ties the two into one ``autograd.Function`` that returns
``(y, mean, var)``; mean and var are detached, as in JAX (:105-110): they
feed the running statistics, never a gradient.  The Pallas size gate
(``FUSED_BN_VMEM_LIMIT``) exists only for the TPU's VMEM: these kernels take
any [N, D].

A wrapper runs the plain version for tensors on the CPU.  For CUDA tensors it
launches its kernel or raises; it never falls back.  ``<wrapper>.launches``
counts the launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from phc_gnn_torch.ops import _build

__all__ = ["bn_forward", "bn_forward_plain", "bn_backward",
           "bn_backward_plain", "fused_masked_bn"]

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_F32 = ctypes.c_float
_typed_lib = None


def _lib():
    global _typed_lib
    if _typed_lib is None:
        lib = _build.load("fused_bn")
        lib.fused_bn_forward_f32.argtypes = [
            _P, _P, _P, _P, _F32, _P, _P, _P, _I64, _I64, _P]
        lib.fused_bn_forward_f32.restype = ctypes.c_int
        lib.fused_bn_backward_f32.argtypes = [
            _P, _P, _P, _P, _P, _F32, _P, _P, _P, _P, _I64, _I64, _P]
        lib.fused_bn_backward_f32.restype = ctypes.c_int
        _typed_lib = lib
    return _typed_lib


# ------------------------------------------------------------ plain versions

def _count(mask):
    return mask.sum(dtype=torch.float32).clamp_min(1.0)


def bn_forward_plain(x, mask, scale, bias, eps: float):
    m = mask[:, None]
    cnt = _count(mask)
    mean = torch.where(m, x, 0.0).sum(0) / cnt
    xc = torch.where(m, x - mean, 0.0)
    var = (xc * xc).sum(0) / cnt
    y = (x - mean) * torch.rsqrt(var + eps) * scale + bias
    return y, mean, var


def bn_backward_plain(x, mask, scale, mean, var, eps: float, g):
    r = torch.rsqrt(var + eps)
    xhat = (x - mean) * r
    cnt = _count(mask)
    sum_g = g.sum(0)
    sum_gx = (g * xhat).sum(0)
    stats = torch.where(mask[:, None], (sum_g + xhat * sum_gx) / cnt, 0.0)
    return scale * r * (g - stats), sum_gx, sum_g


# ------------------------------------------------------------------ wrappers

def _check(x, mask, vectors, g=None):
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"the batch-norm kernels run on CPU or CUDA tensors, "
                         f"got {dev}")
    if x.dtype != torch.float32 or x.ndim != 2:
        raise TypeError(f"x must be a 2-D float32 tensor, got {x.dtype} "
                        f"{tuple(x.shape)}")
    if mask.dtype != torch.bool or mask.shape != x.shape[:1]:
        raise TypeError(f"mask must be bool [{x.shape[0]}], got {mask.dtype} "
                        f"{tuple(mask.shape)}")
    tensors = [("x", x), ("mask", mask)] + list(vectors)
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


def bn_forward(x, mask, scale, bias, eps: float):
    """``(y [N, D], mean [D], var [D])`` of the masked batch norm of ``x``."""
    if x.device.type == "cpu":
        return bn_forward_plain(x, mask, scale, bias, eps)
    _check(x, mask, (("scale", scale), ("bias", bias)))
    n, d = x.shape
    y = torch.empty_like(x)
    mean = torch.empty((d,), dtype=torch.float32, device=x.device)
    var = torch.empty_like(mean)
    err = _lib().fused_bn_forward_f32(
        x.data_ptr(), mask.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        eps, y.data_ptr(), mean.data_ptr(), var.data_ptr(), n, d,
        _build.stream(x.device))
    if err != 0:
        raise RuntimeError(f"bn_forward launch failed: CUDA error {err}")
    bn_forward.launches += 1
    return y, mean, var


bn_forward.launches = 0


def bn_backward(x, mask, scale, mean, var, eps: float, g):
    """``(dx [N, D], dscale [D], dbias [D])`` given the forward's ``mean``
    and ``var`` and the cotangent ``g`` of ``y``."""
    if x.device.type == "cpu":
        return bn_backward_plain(x, mask, scale, mean, var, eps, g)
    _check(x, mask, (("scale", scale), ("mean", mean), ("var", var)), g)
    n, d = x.shape
    dx = torch.empty_like(x)
    dscale = torch.empty((d,), dtype=torch.float32, device=x.device)
    dbias = torch.empty_like(dscale)
    err = _lib().fused_bn_backward_f32(
        x.data_ptr(), mask.data_ptr(), scale.data_ptr(), mean.data_ptr(),
        var.data_ptr(), eps, g.data_ptr(), dx.data_ptr(), dscale.data_ptr(),
        dbias.data_ptr(), n, d, _build.stream(x.device))
    if err != 0:
        raise RuntimeError(f"bn_backward launch failed: CUDA error {err}")
    bn_backward.launches += 1
    return dx, dscale, dbias


bn_backward.launches = 0


class _FusedMaskedBN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mask, scale, bias, eps):
        y, mean, var = bn_forward(x, mask, scale, bias, eps)
        ctx.save_for_backward(x, mask, scale, mean, var)
        ctx.eps = eps
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        x, mask, scale, mean, var = ctx.saved_tensors
        dx, dscale, dbias = bn_backward(x, mask, scale, mean, var, ctx.eps,
                                        gy.contiguous())
        return dx, None, dscale, dbias, None


def fused_masked_bn(x, mask: Optional[torch.Tensor], scale, bias,
                    eps: float = 1e-5):
    """Training-mode masked batch norm over axis 0 of ``x`` [N, D]:
    ``(y, mean [D], var [D])``, differentiable in ``x``, ``scale`` and
    ``bias``; ``mean`` and ``var`` (biased) are detached.  ``mask=None``
    counts every row."""
    if mask is None:
        mask = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
    return _FusedMaskedBN.apply(x, mask, scale, bias, float(eps))
