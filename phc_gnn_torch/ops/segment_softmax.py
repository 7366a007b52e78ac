"""Softmax aggregation over receiver-sorted CSR segments.

Two Hopper kernels (``csrc/segment_softmax.cu``), each beside its plain
PyTorch version over the same CSR and mask semantics:

- ``segment_logit_max`` replaces ``_softmax_suffix_max_kernel``
  (phc_gnn_tpu/ops/stream_scan.py:415): the per-node max of
  ``where(mask, beta * m, -2^100)``.
- ``segment_softmax_aggregate`` replaces ``_softmax_fused_kernel`` /
  ``_softmax_fused_kernel_nw`` (stream_scan.py:439, :521) together with the
  epilogue that gathers at ``last_edge`` and divides (:778-782):
  ``out = sum(w * m) / den`` with ``den = max(sum(w), 1e-16)`` and
  ``w = mask * exp(beta * m - segmax)``; its training variant also writes
  the per-edge ``w`` and the per-node ``den`` that the backward reads.

- ``segment_softmax_fused`` runs A's function and then B's in one launch
  on bf16 messages (``segment_softmax_fused_bf16``), with or without ``w``
  and ``den``: ``segmax`` never reaches device memory, and each row is
  read from it once.  A block a receiver segment runs A's loop then B's
  over the segment's rows (the second reads them from L1).  Its plain
  version is A's then B's.

``segment_softmax`` runs the two in sequence on float32 messages, the
fused kernel on bf16 ones.  Where a gradient is wanted it
goes through an ``autograd.Function`` whose backward is the closed form of
``_softmax_agg_streamed_bwd`` (stream_scan.py:794-815) in plain torch ops, as
JAX leaves it to XLA: one gather of ``[den, g, out * g]`` at the receivers,
then ``dm = (w / den_e) * (g_e + beta * (m * g_e - s_e))`` and
``dbeta = sum (w / den_e) * m * (m * g_e - s_e)``.  The segment max gets no
gradient (``stop_gradient``, :772).  Without a gradient (the eval path) B
runs its eval variant and writes neither ``w`` nor ``den``.

The CSR ``rowptr`` [N + 1] (int32) comes from ``graph.batch.attach_csr_plan``;
it stops at the last real edge, so the padding run at the tail of the edge
array belongs to no segment.  An empty or all-masked segment gives 0.  The
kernels trust ``rowptr`` to be ascending with ``rowptr[-1] <= E`` (checking
it would cost a host sync per launch); ``attach_csr_plan`` validates the
receivers it is built from.

The messages may be float32 or bfloat16 (the model's ``compute_dtype``):
a bf16 launch converts each row at its load and computes in float32, as
JAX's kernels convert their blocks (stream_scan.py:435, :465); ``segmax``,
``out``, ``w`` and ``den`` are float32 either way, and the backward returns
``dm`` in the messages' dtype (:813).  The plain versions upcast first.

Both kernels are bound by the bytes they move (see the source's note).  A
wrapper runs the plain version for tensors on the CPU.  For CUDA tensors it
launches its kernel or raises; it never falls back.  ``<wrapper>.launches``
counts the launches of the float32 instance, ``<wrapper>.launches_bf16``
those of the bf16 one (the fused kernel has a bf16 instance alone).
"""

from __future__ import annotations

import ctypes

import torch

from phc_gnn_torch.ops import _build
from phc_gnn_torch.ops.segment_sum import ROW_DTYPES, count_launch

__all__ = [
    "NEG",
    "segment_logit_max",
    "segment_logit_max_plain",
    "segment_softmax_aggregate",
    "segment_softmax_aggregate_plain",
    "segment_softmax_fused",
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
        for t in ("f32", "bf16"):
            fn = getattr(lib, f"segment_logit_max_{t}")
            fn.argtypes = [_P, _P, _P, _P, _P, _I64, _I64, _P]
            fn.restype = ctypes.c_int
            fn = getattr(lib, f"segment_softmax_aggregate_{t}")
            fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _P]
            fn.restype = ctypes.c_int
        lib.segment_softmax_fused_bf16.argtypes = [_P] * 7 + [_I64] * 2 + [_P]
        lib.segment_softmax_fused_bf16.restype = ctypes.c_int
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
    den = den.clamp_min(1e-16)
    out = num / den
    if not emit_w:
        return out
    w_full = torch.zeros((msgs.shape[0], d), dtype=torch.float32,
                         device=msgs.device)
    w_full[:e] = w
    return out, w_full, den


# ------------------------------------------------------------------ wrappers

def _check(msgs, mask, beta, rowptr):
    dev = msgs.device
    if dev.type != "cuda":
        raise ValueError(f"segment softmax kernels run on CPU or CUDA "
                         f"tensors, got {dev}")
    if msgs.dtype not in ROW_DTYPES or msgs.ndim != 2:
        raise TypeError(f"msgs must be a 2-D float32 or bfloat16 tensor, got "
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


def _suffix(msgs) -> str:
    return "bf16" if msgs.dtype == torch.bfloat16 else "f32"


def segment_logit_max(msgs, mask, beta, rowptr):
    """[N, D] float32 max over each segment of ``where(mask, beta * m,
    -2^100)``."""
    if msgs.device.type == "cpu":
        return segment_logit_max_plain(msgs, mask, beta, rowptr)
    _check(msgs, mask, beta, rowptr)
    n, d = rowptr.shape[0] - 1, msgs.shape[1]
    out = torch.empty((n, d), dtype=torch.float32, device=msgs.device)
    fn = getattr(_lib(), f"segment_logit_max_{_suffix(msgs)}")
    _build.check_launch("segment_logit_max", fn(
        msgs.data_ptr(), mask.data_ptr(), beta.data_ptr(), rowptr.data_ptr(),
        out.data_ptr(), n, d, _build.stream(msgs.device)))
    count_launch(segment_logit_max, msgs)
    return out


segment_logit_max.launches = 0
segment_logit_max.launches_bf16 = 0


def segment_softmax_aggregate(msgs, mask, beta, rowptr, segmax,
                              emit_w: bool = False):
    """[N, D] float32 softmax-weighted segment sum given ``segmax`` from
    ``segment_logit_max``; with ``emit_w`` the triple ``(out, w, den)``,
    adding the per-edge weights ``w`` [E, D] (0 on masked and padding-tail
    edges) and ``den = max(sum w, 1e-16)`` [N, D], both float32."""
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
    w = den = None
    if emit_w:
        w = torch.zeros((msgs.shape[0], d), dtype=torch.float32,
                        device=msgs.device)
        den = torch.empty_like(out)
    fn = getattr(_lib(), f"segment_softmax_aggregate_{_suffix(msgs)}")
    err = fn(
        msgs.data_ptr(), mask.data_ptr(), beta.data_ptr(), rowptr.data_ptr(),
        segmax.data_ptr(), out.data_ptr(), w.data_ptr() if emit_w else None,
        den.data_ptr() if emit_w else None, n, d, _build.stream(msgs.device))
    _build.check_launch("segment_softmax_aggregate", err)
    count_launch(segment_softmax_aggregate, msgs)
    return (out, w, den) if emit_w else out


segment_softmax_aggregate.launches = 0
segment_softmax_aggregate.launches_bf16 = 0


def segment_softmax_fused(msgs, mask, beta, rowptr, emit_w: bool = False):
    """``segment_softmax_aggregate`` of ``segment_logit_max`` on bf16
    messages in one launch (on the CPU their plain versions in sequence):
    ``out``, or with ``emit_w`` the triple ``(out, w, den)``, all float32
    (``w`` zeroed, so that edges past ``rowptr[-1]`` hold 0), bit-equal to
    the two kernels in sequence."""
    if msgs.device.type == "cpu":
        segmax = segment_logit_max_plain(msgs, mask, beta, rowptr)
        return segment_softmax_aggregate_plain(msgs, mask, beta, rowptr,
                                               segmax, emit_w)
    _check(msgs, mask, beta, rowptr)
    if msgs.dtype != torch.bfloat16:
        raise TypeError("the fused softmax kernel reads bfloat16 messages; "
                        "float32 ones run segment_logit_max, then "
                        "segment_softmax_aggregate")
    n, (e, d) = rowptr.shape[0] - 1, msgs.shape
    out = torch.empty((n, d), dtype=torch.float32, device=msgs.device)
    w = den = None
    if emit_w:
        w = torch.zeros((e, d), dtype=torch.float32, device=msgs.device)
        den = torch.empty_like(out)
    err = _lib().segment_softmax_fused_bf16(
        msgs.data_ptr(), mask.data_ptr(), beta.data_ptr(), rowptr.data_ptr(),
        out.data_ptr(), w.data_ptr() if emit_w else None,
        den.data_ptr() if emit_w else None, n, d, _build.stream(msgs.device))
    _build.check_launch("segment_softmax_fused", err)
    count_launch(segment_softmax_fused, msgs)
    return (out, w, den) if emit_w else out


segment_softmax_fused.launches = 0
segment_softmax_fused.launches_bf16 = 0


def _forward(msgs, mask, beta, rowptr, emit_w: bool = False):
    """The softmax aggregation's kernels: the fused one on bf16 messages,
    A then B on float32 ones."""
    if msgs.dtype == torch.bfloat16:
        return segment_softmax_fused(msgs, mask, beta, rowptr, emit_w)
    segmax = segment_logit_max(msgs, mask, beta, rowptr)
    return segment_softmax_aggregate(msgs, mask, beta, rowptr, segmax,
                                     emit_w)


class _SegmentSoftmax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, msgs, mask, beta, rowptr, receivers):
        out, w, den = _forward(msgs, mask, beta, rowptr, emit_w=True)
        ctx.save_for_backward(msgs, beta, w, den, out, receivers)
        return out

    @staticmethod
    def backward(ctx, g):
        msgs, beta, w, den, out, receivers = ctx.saved_tensors
        d = msgs.shape[1]
        g = g.float()
        packed = torch.cat([den, g, out * g], dim=1)
        den_e, g_e, s_e = packed.index_select(0, receivers).split(d, dim=1)
        wt = w / den_e
        m = msgs.float()
        diff = m * g_e - s_e
        dm = dbeta = None
        if ctx.needs_input_grad[0]:
            dm = (wt * (g_e + beta * diff)).to(msgs.dtype)
        if ctx.needs_input_grad[2]:
            dbeta = (wt * m * diff).sum().reshape(beta.shape)
        return dm, None, dbeta, None, None


def segment_softmax(msgs, mask, beta, rowptr, receivers=None):
    """Softmax aggregation ``sum_e softmax(beta * m)_e * m_e`` per node, per
    lane: the two kernels in sequence on float32 messages, the fused kernel
    on bf16 ones (their plain versions on the CPU).
    Differentiable in ``msgs`` and ``beta``; the backward gathers at
    ``receivers`` [E], which a gradient needs."""
    if torch.is_grad_enabled() and (msgs.requires_grad or beta.requires_grad):
        if receivers is None:
            raise ValueError("the softmax backward gathers at the receivers: "
                             "pass receivers")
        return _SegmentSoftmax.apply(msgs, mask, beta, rowptr, receivers)
    return _forward(msgs, mask, beta, rowptr)
