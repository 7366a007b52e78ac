"""Softmax aggregation over receiver-sorted CSR segments.

Hopper kernels (``csrc/segment_softmax.cu``), each beside its plain
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
  on float32 or bf16 messages, with or without ``w`` and ``den``:
  ``segmax`` never reaches device memory, and each row is read from it
  once.  A block a receiver segment runs A's loop then B's over the
  segment's rows (the second reads them from L1).  Its plain version is
  A's then B's.
- ``segment_softmax_backward`` replaces the XLA glue of JAX's backward,
  ``_softmax_agg_streamed_bwd`` (stream_scan.py:794-815): a block a
  receiver segment, ``den``, ``g`` and ``out * g`` read once a node, then
  per edge ``dm = (w / den_n) * (g_n + beta * (m * g_n - s_n))`` and the
  terms of ``dbeta = sum (w / den_n) * m * (m * g_n - s_n)``, summed in
  float64 in a fixed order (no atomics).  Its plain version,
  ``segment_softmax_backward_plain``, is the same closed form in torch
  ops, as JAX leaves it to XLA: one gather of ``[den, g, out * g]`` at the
  receivers, then elementwise passes and a sum.

``segment_softmax`` runs the fused kernel forward and, where a gradient is
wanted, the backward kernel, through an ``autograd.Function``.  The segment
max gets no gradient (``stop_gradient``, :772).  Without a gradient (the
eval path) the fused kernel runs its eval variant and writes neither ``w``
nor ``den``.  A and B stay public with their plain versions; no path of the
model runs them.

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

The kernels are bound by the bytes they move (see the source's note).  A
wrapper runs the plain version for tensors on the CPU.  For CUDA tensors it
launches its kernel or raises; it never falls back.  ``<wrapper>.launches``
counts the launches of the float32 instance, ``<wrapper>.launches_bf16``
those of the bf16 one.

Each wrapper calls its ``torch.library`` op (``torch.ops.phc_gnn.<name>``;
B and the fused kernel have a ``<name>_train`` op beside it for ``(out, w,
den)``), so that ``torch.export`` traces the kernels
(``phc_gnn_torch/export.py``): the op's CPU implementation is the plain
version, its CUDA one the launch, which counts it, and its fake one gives
the outputs' shapes, so that a trace launches and counts nothing.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

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
    "segment_softmax_backward",
    "segment_softmax_backward_plain",
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
            fn = getattr(lib, f"segment_softmax_fused_{t}")
            fn.argtypes = [_P] * 7 + [_I64] * 3 + [_P]
            fn.restype = ctypes.c_int
            fn = getattr(lib, f"segment_softmax_backward_{t}")
            fn.argtypes = [_P] * 10 + [_I64] * 3 + [_P]
            fn.restype = ctypes.c_int
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


def segment_softmax_backward_plain(msgs, beta, w, den, out, g, receivers):
    """``(dm, dbeta)`` of the softmax aggregation given the cotangent ``g``
    of ``out``: the closed form of ``_softmax_agg_streamed_bwd``
    (stream_scan.py:794-815) in plain torch ops, one gather of ``[den, g,
    out * g]`` at the receivers, then ``dm = (w / den_e) * (g_e + beta * (m
    * g_e - s_e))`` in the messages' dtype and ``dbeta = sum (w / den_e) *
    m * (m * g_e - s_e)`` shaped as ``beta``."""
    d = msgs.shape[1]
    packed = torch.cat([den, g, out * g], dim=1)
    den_e, g_e, s_e = packed.index_select(0, receivers).split(d, dim=1)
    wt = w / den_e
    m = msgs.float()
    diff = m * g_e - s_e
    dm = (wt * (g_e + beta * diff)).to(msgs.dtype)
    dbeta = (wt * m * diff).sum().reshape(beta.shape)
    return dm, dbeta


# ------------------------------------------------------------------ wrappers

def _check_rows(msgs, beta, rowptr, fake: bool, **others):
    """What every kernel here takes: ``msgs``, ``beta`` and ``rowptr``'s
    device, dtypes and shapes, and every tensor on ``msgs``' device and
    contiguous (``others`` by name too), read without the data.  ``fake``:
    a fake implementation's check, which passes CPU tensors too (a trace
    on the CPU); a meta tensor never passes."""
    dev = msgs.device
    if dev.type not in (("cuda", "cpu") if fake else ("cuda",)):
        raise ValueError(f"segment softmax kernels run on CPU or CUDA "
                         f"tensors, got {dev}")
    if msgs.dtype not in ROW_DTYPES or msgs.ndim != 2:
        raise TypeError(f"msgs must be a 2-D float32 or bfloat16 tensor, got "
                        f"{msgs.dtype} {tuple(msgs.shape)}")
    if beta.dtype != torch.float32 or beta.numel() != 1:
        raise TypeError("beta must be a float32 scalar tensor")
    if rowptr.dtype != torch.int32 or rowptr.ndim != 1:
        raise TypeError(f"rowptr must be 1-D int32, got {rowptr.dtype}")
    for name, t in (("msgs", msgs), ("beta", beta), ("rowptr", rowptr),
                    *others.items()):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, msgs on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check(msgs, mask, beta, rowptr, fake: bool = False):
    """The forward kernels' inputs (``_check_rows``) and the bool ``mask``
    [E]."""
    if mask.dtype != torch.bool or mask.shape != msgs.shape[:1]:
        raise TypeError(f"mask must be bool [{msgs.shape[0]}], got "
                        f"{mask.dtype} {tuple(mask.shape)}")
    _check_rows(msgs, beta, rowptr, fake, mask=mask)


def _check_segmax(msgs, rowptr, segmax):
    n, d = rowptr.shape[0] - 1, msgs.shape[1]
    if (segmax.dtype != torch.float32 or segmax.shape != (n, d)
            or segmax.device != msgs.device or not segmax.is_contiguous()):
        raise TypeError(f"segmax must be contiguous float32 [{n}, {d}] on "
                        f"{msgs.device}")


def _suffix(msgs) -> str:
    return "bf16" if msgs.dtype == torch.bfloat16 else "f32"


def _outputs(msgs, rowptr, emit_w: bool, zero_w: bool = True):
    """New float32 ``out`` [N, D], and with ``emit_w`` a ``w`` [E, D]
    (zeroed, unless the kernel zeroes its padding rows itself:
    ``zero_w=False``) and ``den`` [N, D]."""
    n, (e, d) = rowptr.shape[0] - 1, msgs.shape
    out = msgs.new_empty((n, d), dtype=torch.float32)
    if not emit_w:
        return out, None, None
    w = (msgs.new_zeros if zero_w else msgs.new_empty)((e, d),
                                                       dtype=torch.float32)
    return out, w, torch.empty_like(out)


# The kernels as torch.library ops (namespace phc_gnn), so that torch.export
# traces them: the CPU implementation is the plain version, the CUDA one
# launches the kernel on the current stream and counts the launch on the
# public wrapper, the fake one gives the outputs' shapes.  B and the fused
# kernel are two ops each, the eval variant and the training variant
# ``(out, w, den)``: an op's outputs cannot depend on a flag.

@torch.library.custom_op("phc_gnn::segment_logit_max", mutates_args=(),
                         device_types="cpu")
def _logit_max_op(msgs: torch.Tensor, mask: torch.Tensor, beta: torch.Tensor,
                  rowptr: torch.Tensor) -> torch.Tensor:
    return segment_logit_max_plain(msgs, mask, beta, rowptr)


@_logit_max_op.register_kernel("cuda")
def _logit_max_cuda(msgs, mask, beta, rowptr):
    _check(msgs, mask, beta, rowptr)
    out, _, _ = _outputs(msgs, rowptr, False)
    n, d = out.shape
    fn = getattr(_lib(), f"segment_logit_max_{_suffix(msgs)}")
    _build.check_launch("segment_logit_max", fn(
        msgs.data_ptr(), mask.data_ptr(), beta.data_ptr(), rowptr.data_ptr(),
        out.data_ptr(), n, d, _build.stream(msgs.device)))
    count_launch(segment_logit_max, msgs)
    return out


@_logit_max_op.register_fake
def _logit_max_fake(msgs, mask, beta, rowptr):
    _check(msgs, mask, beta, rowptr, fake=True)
    return _outputs(msgs, rowptr, False)[0]


def _aggregate_cuda(msgs, mask, beta, rowptr, segmax, emit_w: bool):
    _check(msgs, mask, beta, rowptr)
    _check_segmax(msgs, rowptr, segmax)
    out, w, den = _outputs(msgs, rowptr, emit_w)
    n, d = out.shape
    fn = getattr(_lib(), f"segment_softmax_aggregate_{_suffix(msgs)}")
    err = fn(
        msgs.data_ptr(), mask.data_ptr(), beta.data_ptr(), rowptr.data_ptr(),
        segmax.data_ptr(), out.data_ptr(), w.data_ptr() if emit_w else None,
        den.data_ptr() if emit_w else None, n, d, _build.stream(msgs.device))
    _build.check_launch("segment_softmax_aggregate", err)
    count_launch(segment_softmax_aggregate, msgs)
    return (out, w, den) if emit_w else out


def _aggregate_fake(msgs, mask, beta, rowptr, segmax, emit_w: bool):
    _check(msgs, mask, beta, rowptr, fake=True)
    _check_segmax(msgs, rowptr, segmax)
    out, w, den = _outputs(msgs, rowptr, emit_w)
    return (out, w, den) if emit_w else out


@torch.library.custom_op("phc_gnn::segment_softmax_aggregate",
                         mutates_args=(), device_types="cpu")
def _aggregate_op(msgs: torch.Tensor, mask: torch.Tensor, beta: torch.Tensor,
                  rowptr: torch.Tensor, segmax: torch.Tensor) -> torch.Tensor:
    return segment_softmax_aggregate_plain(msgs, mask, beta, rowptr, segmax)


_aggregate_op.register_kernel("cuda")(
    lambda *args: _aggregate_cuda(*args, emit_w=False))
_aggregate_op.register_fake(lambda *args: _aggregate_fake(*args, emit_w=False))


@torch.library.custom_op("phc_gnn::segment_softmax_aggregate_train",
                         mutates_args=(), device_types="cpu")
def _aggregate_train_op(
        msgs: torch.Tensor, mask: torch.Tensor, beta: torch.Tensor,
        rowptr: torch.Tensor, segmax: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return segment_softmax_aggregate_plain(msgs, mask, beta, rowptr, segmax,
                                           emit_w=True)


_aggregate_train_op.register_kernel("cuda")(
    lambda *args: _aggregate_cuda(*args, emit_w=True))
_aggregate_train_op.register_fake(
    lambda *args: _aggregate_fake(*args, emit_w=True))


def _fused_plain(msgs, mask, beta, rowptr, emit_w: bool):
    segmax = segment_logit_max_plain(msgs, mask, beta, rowptr)
    return segment_softmax_aggregate_plain(msgs, mask, beta, rowptr, segmax,
                                           emit_w)


def _fused_cuda(msgs, mask, beta, rowptr, emit_w: bool):
    _check(msgs, mask, beta, rowptr)
    out, w, den = _outputs(msgs, rowptr, emit_w, zero_w=False)
    n, d = out.shape
    fn = getattr(_lib(), f"segment_softmax_fused_{_suffix(msgs)}")
    err = fn(
        msgs.data_ptr(), mask.data_ptr(), beta.data_ptr(), rowptr.data_ptr(),
        out.data_ptr(), w.data_ptr() if emit_w else None,
        den.data_ptr() if emit_w else None, n, msgs.shape[0], d,
        _build.stream(msgs.device))
    _build.check_launch("segment_softmax_fused", err)
    count_launch(segment_softmax_fused, msgs)
    return (out, w, den) if emit_w else out


def _fused_fake(msgs, mask, beta, rowptr, emit_w: bool):
    _check(msgs, mask, beta, rowptr, fake=True)
    out, w, den = _outputs(msgs, rowptr, emit_w)
    return (out, w, den) if emit_w else out


@torch.library.custom_op("phc_gnn::segment_softmax_fused", mutates_args=(),
                         device_types="cpu")
def _fused_op(msgs: torch.Tensor, mask: torch.Tensor, beta: torch.Tensor,
              rowptr: torch.Tensor) -> torch.Tensor:
    return _fused_plain(msgs, mask, beta, rowptr, emit_w=False)


_fused_op.register_kernel("cuda")(lambda *args: _fused_cuda(*args, False))
_fused_op.register_fake(lambda *args: _fused_fake(*args, False))


@torch.library.custom_op("phc_gnn::segment_softmax_fused_train",
                         mutates_args=(), device_types="cpu")
def _fused_train_op(
        msgs: torch.Tensor, mask: torch.Tensor, beta: torch.Tensor,
        rowptr: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return _fused_plain(msgs, mask, beta, rowptr, emit_w=True)


_fused_train_op.register_kernel("cuda")(lambda *args: _fused_cuda(*args, True))
_fused_train_op.register_fake(lambda *args: _fused_fake(*args, True))


def _check_backward(msgs, beta, w, den, out, g, rowptr, receivers,
                    fake: bool = False):
    """The backward's inputs: ``msgs``, ``beta`` and ``rowptr`` as the
    forward's (``_check_rows``), float32 ``w`` [E, D] and ``den``, ``out``,
    ``g`` [N, D], ``receivers`` [E]."""
    _check_rows(msgs, beta, rowptr, fake, w=w, den=den, out=out, g=g,
                receivers=receivers)
    n, (e, d) = rowptr.shape[0] - 1, msgs.shape
    for name, t, shape in (("w", w, (e, d)), ("den", den, (n, d)),
                           ("out", out, (n, d)), ("g", g, (n, d))):
        if t.dtype != torch.float32 or t.shape != shape:
            raise TypeError(f"{name} must be float32 {list(shape)}, got "
                            f"{t.dtype} {tuple(t.shape)}")
    if receivers.shape != (e,):
        raise TypeError(f"receivers must be [{e}], got "
                        f"{tuple(receivers.shape)}")


def _backward_cuda(msgs, beta, w, den, out, g, rowptr, receivers):
    _check_backward(msgs, beta, w, den, out, g, rowptr, receivers)
    n, (e, d) = rowptr.shape[0] - 1, msgs.shape
    dm = torch.empty_like(msgs)
    dbeta = torch.empty_like(beta)
    # the blocks' dbeta partials, summed in node order by the last block
    partials = msgs.new_empty((max(n, 1),), dtype=torch.float64)
    fn = getattr(_lib(), f"segment_softmax_backward_{_suffix(msgs)}")
    err = fn(msgs.data_ptr(), beta.data_ptr(), w.data_ptr(), den.data_ptr(),
             out.data_ptr(), g.data_ptr(), rowptr.data_ptr(), dm.data_ptr(),
             partials.data_ptr(), dbeta.data_ptr(), n, e, d,
             _build.stream(msgs.device))
    _build.check_launch("segment_softmax_backward", err)
    count_launch(segment_softmax_backward, msgs)
    return dm, dbeta


@torch.library.custom_op("phc_gnn::segment_softmax_backward",
                         mutates_args=(), device_types="cpu")
def _backward_op(msgs: torch.Tensor, beta: torch.Tensor, w: torch.Tensor,
                 den: torch.Tensor, out: torch.Tensor, g: torch.Tensor,
                 rowptr: torch.Tensor, receivers: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    return segment_softmax_backward_plain(msgs, beta, w, den, out, g,
                                          receivers)


_backward_op.register_kernel("cuda")(_backward_cuda)


@_backward_op.register_fake
def _backward_fake(msgs, beta, w, den, out, g, rowptr, receivers):
    _check_backward(msgs, beta, w, den, out, g, rowptr, receivers, fake=True)
    return torch.empty_like(msgs), torch.empty_like(beta)


def segment_logit_max(msgs, mask, beta, rowptr):
    """[N, D] float32 max over each segment of ``where(mask, beta * m,
    -2^100)`` (``torch.ops.phc_gnn.segment_logit_max``)."""
    return torch.ops.phc_gnn.segment_logit_max(msgs, mask, beta, rowptr)


segment_logit_max.launches = 0
segment_logit_max.launches_bf16 = 0


def segment_softmax_aggregate(msgs, mask, beta, rowptr, segmax,
                              emit_w: bool = False):
    """[N, D] float32 softmax-weighted segment sum given ``segmax`` from
    ``segment_logit_max``; with ``emit_w`` the triple ``(out, w, den)``,
    adding the per-edge weights ``w`` [E, D] (0 on masked and padding-tail
    edges) and ``den = max(sum w, 1e-16)`` [N, D], both float32
    (``torch.ops.phc_gnn.segment_softmax_aggregate``, or its ``_train``
    op)."""
    if emit_w:
        return torch.ops.phc_gnn.segment_softmax_aggregate_train(
            msgs, mask, beta, rowptr, segmax)
    return torch.ops.phc_gnn.segment_softmax_aggregate(msgs, mask, beta,
                                                       rowptr, segmax)


segment_softmax_aggregate.launches = 0
segment_softmax_aggregate.launches_bf16 = 0


def segment_softmax_fused(msgs, mask, beta, rowptr, emit_w: bool = False):
    """``segment_softmax_aggregate`` of ``segment_logit_max`` in one launch,
    on float32 or bf16 messages (on the CPU their plain versions in
    sequence): ``out``, or with ``emit_w`` the triple ``(out, w, den)``, all
    float32 (``w`` 0 on edges past ``rowptr[-1]``), bit-equal to the two
    kernels in sequence (``torch.ops.phc_gnn.segment_softmax_fused``, or its
    ``_train`` op)."""
    if emit_w:
        return torch.ops.phc_gnn.segment_softmax_fused_train(msgs, mask, beta,
                                                             rowptr)
    return torch.ops.phc_gnn.segment_softmax_fused(msgs, mask, beta, rowptr)


segment_softmax_fused.launches = 0
segment_softmax_fused.launches_bf16 = 0


def segment_softmax_backward(msgs, beta, w, den, out, g, rowptr, receivers):
    """``(dm, dbeta)``: the softmax aggregation's backward given the
    forward's ``w`` and ``den`` (``segment_softmax_fused(..., emit_w=True)``)
    and ``out``, and the cotangent ``g`` [N, D] of ``out``; ``dm`` [E, D] in
    the messages' dtype (0 past ``rowptr[-1]``), ``dbeta`` shaped as
    ``beta`` (``torch.ops.phc_gnn.segment_softmax_backward``).  The kernel
    walks the CSR ``rowptr``; the plain version on the CPU gathers at
    ``receivers``."""
    return torch.ops.phc_gnn.segment_softmax_backward(
        msgs, beta, w, den, out, g, rowptr, receivers)


segment_softmax_backward.launches = 0
segment_softmax_backward.launches_bf16 = 0


class _SegmentSoftmax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, msgs, mask, beta, rowptr, receivers):
        out, w, den = segment_softmax_fused(msgs, mask, beta, rowptr,
                                            emit_w=True)
        ctx.save_for_backward(msgs, beta, w, den, out, rowptr, receivers)
        return out

    @staticmethod
    def backward(ctx, g):
        msgs, beta, w, den, out, rowptr, receivers = ctx.saved_tensors
        dm, dbeta = segment_softmax_backward(
            msgs, beta, w, den, out, g.float().contiguous(), rowptr,
            receivers)
        return (dm if ctx.needs_input_grad[0] else None, None,
                dbeta if ctx.needs_input_grad[2] else None, None, None)


def segment_softmax(msgs, mask, beta, rowptr, receivers=None):
    """Softmax aggregation ``sum_e softmax(beta * m)_e * m_e`` per node, per
    lane: A fused into B (``segment_softmax_fused``; the plain A then B on
    the CPU).  Differentiable in ``msgs`` and ``beta``: the backward is
    ``segment_softmax_backward``, whose plain version on the CPU gathers at
    ``receivers`` [E], which a gradient needs."""
    if torch.is_grad_enabled() and (msgs.requires_grad or beta.requires_grad):
        if receivers is None:
            raise ValueError("the softmax backward gathers at the receivers: "
                             "pass receivers")
        return _SegmentSoftmax.apply(msgs, mask, beta, rowptr, receivers)
    return segment_softmax_fused(msgs, mask, beta, rowptr)
