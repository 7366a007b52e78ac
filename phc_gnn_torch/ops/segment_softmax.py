"""Softmax aggregation over receiver-sorted CSR segments.

Two Hopper kernels (``csrc/segment_softmax.cu``), each beside its plain
PyTorch version over the same CSR and mask semantics:

- ``segment_logit_max`` replaces ``_softmax_suffix_max_kernel``
  (phc_gnn_tpu/ops/stream_scan.py:415): the per-node max of
  ``where(mask, beta * m, -2^100)``.
- ``segment_softmax_aggregate`` replaces ``_softmax_fused_kernel`` /
  ``_softmax_fused_kernel_nw`` (stream_scan.py:439, :521) together with the
  epilogue that gathers at ``last_edge`` and divides (:778-782):
  ``out = sum(w * m) / max(sum(w), 1e-16)`` with
  ``w = mask * exp(beta * m - segmax)``, and optionally the per-edge ``w``
  that the training backward reads.

The CSR ``rowptr`` [N + 1] (int32) comes from ``graph.batch.attach_csr_plan``;
it stops at the last real edge, so the padding run at the tail of the edge
array belongs to no segment.  An empty or all-masked segment gives 0.  The
kernels trust ``rowptr`` to be ascending with ``rowptr[-1] <= E`` (checking
it would cost a host sync per launch); ``attach_csr_plan`` validates the
receivers it is built from.

Both kernels are bound by the bytes they move (see the source's note).  A
wrapper runs the plain version for tensors on the CPU.  For CUDA tensors it
launches its kernel or raises; it never falls back.  ``<wrapper>.launches``
counts the launches.
"""

from __future__ import annotations

import ctypes

import torch

from phc_gnn_torch.ops import _build

__all__ = [
    "NEG",
    "segment_logit_max",
    "segment_logit_max_plain",
    "segment_softmax_aggregate",
    "segment_softmax_aggregate_plain",
    "segment_softmax",
]

NEG = -(2.0 ** 100)  # max identity: a power of two, exact in bf16 too

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_typed_lib = None


def _lib():
    global _typed_lib
    if _typed_lib is None:
        lib = _build.load("segment_softmax")
        lib.segment_logit_max_f32.argtypes = [_P, _P, _P, _P, _P, _I64, _I64, _P]
        lib.segment_logit_max_f32.restype = ctypes.c_int
        lib.segment_softmax_aggregate_f32.argtypes = [
            _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _P]
        lib.segment_softmax_aggregate_f32.restype = ctypes.c_int
        _typed_lib = lib
    return _typed_lib


# ------------------------------------------------------------ plain versions

def _segment_ids(rowptr: torch.Tensor) -> torch.Tensor:
    """Node id of every edge in [0, rowptr[-1])."""
    n = rowptr.shape[0] - 1
    counts = (rowptr[1:] - rowptr[:-1]).long()
    return torch.repeat_interleave(
        torch.arange(n, device=rowptr.device), counts)


def segment_logit_max_plain(msgs, mask, beta, rowptr):
    seg = _segment_ids(rowptr)
    e, d = seg.shape[0], msgs.shape[1]
    logits = torch.where(mask[:e, None], beta * msgs[:e].float(), NEG)
    out = torch.full((rowptr.shape[0] - 1, d), NEG, dtype=torch.float32,
                     device=msgs.device)
    return out.scatter_reduce(0, seg[:, None].expand(e, d), logits, "amax")


def segment_softmax_aggregate_plain(msgs, mask, beta, rowptr, segmax,
                                    emit_w: bool = False):
    seg = _segment_ids(rowptr)
    e, d = seg.shape[0], msgs.shape[1]
    n = rowptr.shape[0] - 1
    m = msgs[:e].float()
    w = torch.where(mask[:e, None], torch.exp(beta * m - segmax[seg]), 0.0)
    num = torch.zeros((n, d), dtype=torch.float32, device=msgs.device)
    den = torch.zeros_like(num)
    num.index_add_(0, seg, w * m)
    den.index_add_(0, seg, w)
    out = num / den.clamp_min(1e-16)
    if not emit_w:
        return out
    w_full = torch.zeros((msgs.shape[0], d), dtype=torch.float32,
                         device=msgs.device)
    w_full[:e] = w
    return out, w_full


# ------------------------------------------------------------------ wrappers

def _check(msgs, mask, beta, rowptr):
    dev = msgs.device
    if dev.type != "cuda":
        raise ValueError(f"segment softmax kernels run on CPU or CUDA "
                         f"tensors, got {dev}")
    if msgs.dtype != torch.float32 or msgs.ndim != 2:
        raise TypeError(f"msgs must be a 2-D float32 tensor, got "
                        f"{msgs.dtype} {tuple(msgs.shape)}")
    if mask.dtype != torch.bool or mask.shape != msgs.shape[:1]:
        raise TypeError(f"mask must be bool [{msgs.shape[0]}], got "
                        f"{mask.dtype} {tuple(mask.shape)}")
    if beta.dtype != torch.float32 or beta.numel() != 1:
        raise TypeError("beta must be a float32 scalar tensor")
    if rowptr.dtype != torch.int32 or rowptr.ndim != 1:
        raise TypeError(f"rowptr must be 1-D int32, got {rowptr.dtype}")
    for name, t in (("msgs", msgs), ("mask", mask), ("beta", beta),
                    ("rowptr", rowptr)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, msgs on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def segment_logit_max(msgs, mask, beta, rowptr):
    """[N, D] max over each segment of ``where(mask, beta * m, -2^100)``."""
    if msgs.device.type == "cpu":
        return segment_logit_max_plain(msgs, mask, beta, rowptr)
    _check(msgs, mask, beta, rowptr)
    n, d = rowptr.shape[0] - 1, msgs.shape[1]
    out = torch.empty((n, d), dtype=torch.float32, device=msgs.device)
    err = _lib().segment_logit_max_f32(
        msgs.data_ptr(), mask.data_ptr(), beta.data_ptr(), rowptr.data_ptr(),
        out.data_ptr(), n, d, _stream(msgs.device))
    if err != 0:
        raise RuntimeError(f"segment_logit_max launch failed: CUDA error {err}")
    segment_logit_max.launches += 1
    return out


segment_logit_max.launches = 0


def segment_softmax_aggregate(msgs, mask, beta, rowptr, segmax,
                              emit_w: bool = False):
    """[N, D] softmax-weighted segment sum given ``segmax`` from
    ``segment_logit_max``; with ``emit_w`` also the per-edge weights
    ``w`` [E, D] (0 on masked and padding-tail edges)."""
    if msgs.device.type == "cpu":
        return segment_softmax_aggregate_plain(msgs, mask, beta, rowptr,
                                               segmax, emit_w)
    _check(msgs, mask, beta, rowptr)
    n, d = rowptr.shape[0] - 1, msgs.shape[1]
    if (segmax.dtype != torch.float32 or segmax.shape != (n, d)
            or segmax.device != msgs.device or not segmax.is_contiguous()):
        raise TypeError(f"segmax must be contiguous float32 [{n}, {d}] on "
                        f"{msgs.device}")
    out = torch.empty((n, d), dtype=torch.float32, device=msgs.device)
    w = (torch.zeros((msgs.shape[0], d), dtype=torch.float32,
                     device=msgs.device) if emit_w else None)
    err = _lib().segment_softmax_aggregate_f32(
        msgs.data_ptr(), mask.data_ptr(), beta.data_ptr(), rowptr.data_ptr(),
        segmax.data_ptr(), out.data_ptr(), w.data_ptr() if emit_w else None,
        n, d, _stream(msgs.device))
    if err != 0:
        raise RuntimeError(
            f"segment_softmax_aggregate launch failed: CUDA error {err}")
    segment_softmax_aggregate.launches += 1
    return (out, w) if emit_w else out


segment_softmax_aggregate.launches = 0


def segment_softmax(msgs, mask, beta, rowptr):
    """Softmax aggregation ``sum_e softmax(beta * m)_e * m_e`` per node, per
    lane: the two kernels in sequence (their plain versions on the CPU)."""
    segmax = segment_logit_max(msgs, mask, beta, rowptr)
    return segment_softmax_aggregate(msgs, mask, beta, rowptr, segmax)
