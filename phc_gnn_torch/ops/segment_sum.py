"""Segment sum over a permuted CSR, and the message gather whose backward it is.

One Hopper kernel (``csrc/segment_sum.cu``) beside its plain PyTorch version:

- ``segment_sum_perm`` replaces ``_scan_kernel`` with op="add"
  (phc_gnn_tpu/ops/stream_scan.py:373, via ``_segmented_scan`` :572) as the
  gather backward ``_gather_sb_bwd`` (:854-867) runs it:
  ``out[n] = sum of values[perm[e]] for e in rowptr[n]..rowptr[n+1]``, 0 for
  an empty segment.
- ``gather_nodes`` is ``x[senders]`` (``gather_nodes_streamed``, :873): its
  forward is the plain take, its backward ``dx[senders] += g`` is the kernel
  over the batch's sender CSR (``graph.batch.build_sender_csr``), in which
  masked edges belong to no segment.

The wrapper runs the plain version for tensors on the CPU.  For CUDA tensors
it launches the kernel or raises; it never falls back.
``segment_sum_perm.launches`` counts the launches.  The kernel trusts
``rowptr`` to be ascending and ``perm`` to index rows of ``values`` (checking
would cost a host sync per launch); ``build_sender_csr`` builds both.
"""

from __future__ import annotations

import ctypes

import torch

from phc_gnn_torch.ops import _build

__all__ = ["segment_sum_perm", "segment_sum_perm_plain", "gather_nodes"]

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_typed_lib = None


def _lib():
    global _typed_lib
    if _typed_lib is None:
        lib = _build.load("segment_sum")
        lib.segment_sum_perm_f32.argtypes = [_P, _P, _P, _P, _I64, _I64, _P]
        lib.segment_sum_perm_f32.restype = ctypes.c_int
        _typed_lib = lib
    return _typed_lib


def segment_sum_perm_plain(values, perm, rowptr):
    """The kernel's function in ``values``' dtype (the checks pass float64,
    so that the order of the sums does not matter)."""
    n = rowptr.shape[0] - 1
    counts = (rowptr[1:] - rowptr[:-1]).long()
    seg = torch.repeat_interleave(torch.arange(n, device=rowptr.device), counts)
    rows = values.index_select(0, perm[:seg.shape[0]].long())
    out = torch.zeros((n, values.shape[1]), dtype=values.dtype,
                      device=values.device)
    return out.index_add_(0, seg, rows)


def segment_sum_perm(values, perm, rowptr):
    """[N, D] sums of the rows ``values[perm[e]]`` over each CSR segment of
    ``rowptr`` [N + 1]."""
    if values.device.type == "cpu":
        return segment_sum_perm_plain(values, perm, rowptr)
    dev = values.device
    if dev.type != "cuda":
        raise ValueError(f"segment_sum_perm runs on CPU or CUDA tensors, "
                         f"got {dev}")
    if values.dtype != torch.float32 or values.ndim != 2:
        raise TypeError(f"values must be a 2-D float32 tensor, got "
                        f"{values.dtype} {tuple(values.shape)}")
    for name, t in (("perm", perm), ("rowptr", rowptr)):
        if t.dtype != torch.int32 or t.ndim != 1:
            raise TypeError(f"{name} must be 1-D int32, got {t.dtype}")
    for name, t in (("values", values), ("perm", perm), ("rowptr", rowptr)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, values on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n, d = rowptr.shape[0] - 1, values.shape[1]
    out = torch.empty((n, d), dtype=torch.float32, device=dev)
    err = _lib().segment_sum_perm_f32(
        values.data_ptr(), perm.data_ptr(), rowptr.data_ptr(), out.data_ptr(),
        n, d, _build.stream(dev))
    if err != 0:
        raise RuntimeError(f"segment_sum_perm launch failed: CUDA error {err}")
    segment_sum_perm.launches += 1
    return out


segment_sum_perm.launches = 0


class _GatherNodes(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, senders, snd_perm, snd_rowptr):
        ctx.save_for_backward(snd_perm, snd_rowptr)
        ctx.x_dtype = x.dtype
        return x.index_select(0, senders)

    @staticmethod
    def backward(ctx, g):
        snd_perm, snd_rowptr = ctx.saved_tensors
        dx = segment_sum_perm(g.float().contiguous(), snd_perm, snd_rowptr)
        return dx.to(ctx.x_dtype), None, None, None


def gather_nodes(x, senders, snd_perm, snd_rowptr):
    """``x[senders]`` whose backward sums the cotangent rows per sender over
    the sender CSR (kernel C on the card); ``snd_rowptr`` has
    ``x.shape[0] + 1`` entries."""
    if snd_rowptr.shape[0] != x.shape[0] + 1:
        raise ValueError(f"snd_rowptr has {snd_rowptr.shape[0]} entries for "
                         f"{x.shape[0]} rows of x")
    return _GatherNodes.apply(x, senders, snd_perm, snd_rowptr)
