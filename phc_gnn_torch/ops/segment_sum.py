"""Segment sums over a CSR: the sum aggregation, and the message gather
whose backward is one.

Kernel C (``csrc/segment_sum.cu``) replaces ``_scan_kernel`` with op="add"
(phc_gnn_tpu/ops/stream_scan.py:373, via ``_segmented_scan`` :572) in its two
roles, each wrapper beside its plain PyTorch version and with a launch
counter of its own:

- ``segment_sum_perm``, as the gather backward ``_gather_sb_bwd``
  (:854-867) runs it: ``out[n] = sum of values[perm[e]] for e in
  rowptr[n]..rowptr[n+1]``, 0 for an empty segment.
- ``segment_sum_masked``, as the sum aggregation ``_seg_sum_streamed``
  (:698-744) runs it: ``out[n] = sum of msgs[e] over e in rowptr[n]..
  rowptr[n+1] with mask[e]``, over the receiver CSR of
  ``graph.batch.build_csr_rowptr``, in which masked edges among real ones
  stay inside their segment.

Around them:

- ``gather_nodes`` is ``x[senders]`` (``gather_nodes_streamed``, :873): its
  forward is the plain take, its backward ``dx[senders] += g`` is
  ``segment_sum_perm`` over the batch's sender CSR
  (``graph.batch.build_sender_csr``), in which masked edges belong to no
  segment.
- ``segment_sum_aggregate`` is ``segment_sum_streamed`` (:726): its forward
  is ``segment_sum_masked``, its backward JAX's VJP, the gather
  ``g[receivers]`` (:715-720), 0 on masked edges (JAX zeroes their messages
  before the scan, :741-742).

A wrapper runs the plain version for tensors on the CPU.  For CUDA tensors
it launches the kernel or raises; it never falls back.  The kernels trust
``rowptr`` to be ascending and ``perm`` to index rows of ``values`` (checking
would cost a host sync per launch); ``graph.attach_csr_plan`` builds both.

``segment_sum_plan`` computes the launch (``csrc/segment_sum.cu`` checks
it): a warp a segment, a CTA a run of consecutive segments whose CSR slice
and mask bytes or perm entries it stages in shared memory, float4 lanes
where the rows allow them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from phc_gnn_torch.ops import _build

__all__ = ["SegSumPlan", "segment_sum_plan", "segment_sum_perm",
           "segment_sum_perm_plain", "segment_sum_masked",
           "segment_sum_masked_plain", "gather_nodes", "segment_sum_aggregate",
           "segment_ids", "check_masked_csr"]

# the launch plan (csrc/segment_sum.cu holds the same constants)
SEG_WARPS = 8               # warps a CTA, one a segment at a time (kWarps)
SEG_MAX_RUN = 64            # segments a CTA, at most (kMaxRun)
SEG_CHUNKS = (1, 2, 4)      # vectors of a row a lane holds, per column block
SEG_STAGE_PER_SEG = 16      # staged mask bytes or perm entries a segment
SEG_MAX_SMEM = 48 * 1024    # dynamic shared memory without an opt-in
SEG_MIN_CTAS = 4 * _build.SMS  # runs grow only while the grid keeps 4 CTAs
                               # an SM


class SegSumPlan(NamedTuple):
    """The launch of C: ``grid`` x ``col_blocks`` CTAs of ``SEG_WARPS``
    warps; CTA (b, c) owns the segments ``[b * run, min(n, (b + 1) * run))``
    and the columns ``[c * cols, (c + 1) * cols)``, ``cols = chunks * 32 *
    vec``; a lane holds ``chunks`` accumulators of ``vec`` floats (4: float4
    loads); ``stage`` mask bytes or perm entries of the run's edges sit in
    ``smem_bytes`` of shared memory beside its ``run + 1`` row pointers."""
    vec: int
    chunks: int
    col_blocks: int
    run: int
    stage: int
    smem_bytes: int
    grid: int


@functools.lru_cache(maxsize=256)
def segment_sum_plan(n: int, e: int, d: int, perm: bool,
                     aligned: bool = True) -> SegSumPlan:
    """The launch plan of C over ``n`` segments of ``e`` edges of ``d``
    floats, in the perm role (``perm``) or the masked one: float4 lanes where
    ``d % 4 == 0`` and the rows are 16-byte ``aligned``, else one float a
    lane (the scalar instance); the fewest of ``SEG_CHUNKS`` vectors a lane
    that cover a row, in column blocks past 4; runs of ``SEG_WARPS`` * 2^k
    segments, the longest up to ``SEG_MAX_RUN`` whose grid keeps
    ``SEG_MIN_CTAS`` CTAs; and up to ``SEG_STAGE_PER_SEG`` staged entries a
    segment of the run, no more than ``e``."""
    vec = 4 if aligned and d % 4 == 0 else 1
    vectors = -(-d // vec)
    chunks = next((c for c in SEG_CHUNKS if 32 * c >= vectors), SEG_CHUNKS[-1])
    col_blocks = max(1, -(-vectors // (32 * chunks)))
    run = SEG_WARPS
    while (2 * run <= SEG_MAX_RUN
           and -(-n // (2 * run)) * col_blocks >= SEG_MIN_CTAS):
        run *= 2
    stage = min(e, run * SEG_STAGE_PER_SEG)
    smem = 4 * (run + 1) + stage * (4 if perm else 1)
    return SegSumPlan(vec, chunks, col_blocks, run, stage, smem, -(-n // run))


_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_typed_lib = None


def _lib():
    global _typed_lib
    if _typed_lib is None:
        lib = _build.load("segment_sum")
        for fn in (lib.segment_sum_perm_f32, lib.segment_sum_masked_f32):
            fn.argtypes = [_P] * 4 + [_I64] * 9 + [_P]
            fn.restype = ctypes.c_int
        _typed_lib = lib
    return _typed_lib


def segment_ids(rowptr):
    """The segment of each edge inside the CSR segments of ``rowptr``
    [N + 1]: ``rowptr[-1]`` entries, ascending."""
    n = rowptr.shape[0] - 1
    counts = (rowptr[1:] - rowptr[:-1]).long()
    return torch.repeat_interleave(torch.arange(n, device=rowptr.device), counts)


def segment_sum_perm_plain(values, perm, rowptr):
    """The kernel's function in ``values``' dtype (the checks pass float64,
    so that the order of the sums does not matter)."""
    seg = segment_ids(rowptr)
    rows = values.index_select(0, perm[:seg.shape[0]].long())
    out = torch.zeros((rowptr.shape[0] - 1, values.shape[1]),
                      dtype=values.dtype, device=values.device)
    return out.index_add_(0, seg, rows)


def segment_sum_masked_plain(msgs, mask, rowptr):
    """The forward kernel's function in ``msgs``' dtype (the checks pass
    float64)."""
    seg = segment_ids(rowptr)
    rows = torch.where(mask[:seg.shape[0], None], msgs[:seg.shape[0]], 0)
    out = torch.zeros((rowptr.shape[0] - 1, msgs.shape[1]), dtype=msgs.dtype,
                      device=msgs.device)
    return out.index_add_(0, seg, rows)


def _check(name, values, index, rowptr):
    """Device, dtype, shape and contiguity of a segment-sum launch;
    ``index`` is ``(name, tensor, dtype)``."""
    dev = values.device
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on CPU or CUDA tensors, got {dev}")
    if values.dtype != torch.float32 or values.ndim != 2:
        raise TypeError(f"values must be a 2-D float32 tensor, got "
                        f"{values.dtype} {tuple(values.shape)}")
    iname, itensor, idtype = index
    for tname, t, dtype in ((iname, itensor, idtype),
                            ("rowptr", rowptr, torch.int32)):
        if t.dtype != dtype or t.ndim != 1:
            raise TypeError(f"{tname} must be 1-D {dtype}, got {t.dtype}")
    for tname, t in (("values", values), (iname, itensor), ("rowptr", rowptr)):
        if t.device != dev:
            raise ValueError(f"{tname} is on {t.device}, values on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{tname} must be contiguous")


def check_masked_csr(name, msgs, mask, rowptr):
    """``_check`` of a launch over the receiver CSR that reads ``mask`` [E]
    beside ``msgs`` [E, D]: C's forward role, and kernels H and I."""
    _check(name, msgs, ("mask", mask, torch.bool), rowptr)
    if mask.shape[0] != msgs.shape[0]:
        raise ValueError(f"mask has {mask.shape[0]} entries for "
                         f"{msgs.shape[0]} rows of msgs")


def _launch(fn, values, index, rowptr, perm: bool):
    """Launch C's entry point ``fn`` on its checked inputs into a new [N, D]
    output, on ``segment_sum_plan``; the instance follows ``values``' width
    and alignment."""
    n, (e, d) = rowptr.shape[0] - 1, values.shape
    out = torch.empty((n, d), dtype=torch.float32, device=values.device)
    plan = segment_sum_plan(n, e, d, perm, values.data_ptr() % 16 == 0)
    _build.check_launch(fn.__name__, fn(
        values.data_ptr(), index.data_ptr(), rowptr.data_ptr(), out.data_ptr(),
        n, d, *plan, _build.stream(values.device)))
    return out


def segment_sum_perm(values, perm, rowptr):
    """[N, D] sums of the rows ``values[perm[e]]`` over each CSR segment of
    ``rowptr`` [N + 1]."""
    if values.device.type == "cpu":
        return segment_sum_perm_plain(values, perm, rowptr)
    _check("segment_sum_perm", values, ("perm", perm, torch.int32), rowptr)
    out = _launch(_lib().segment_sum_perm_f32, values, perm, rowptr, True)
    segment_sum_perm.launches += 1
    return out


segment_sum_perm.launches = 0


def segment_sum_masked(msgs, mask, rowptr):
    """[N, D] sums of the rows ``msgs[e]`` whose ``mask[e]`` holds over each
    CSR segment of ``rowptr`` [N + 1]."""
    if msgs.device.type == "cpu":
        return segment_sum_masked_plain(msgs, mask, rowptr)
    check_masked_csr("segment_sum_masked", msgs, mask, rowptr)
    out = _launch(_lib().segment_sum_masked_f32, msgs, mask, rowptr, False)
    segment_sum_masked.launches += 1
    return out


segment_sum_masked.launches = 0


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


class _SegmentSumAggregate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, msgs, receivers, mask, rowptr):
        ctx.save_for_backward(receivers, mask)
        return segment_sum_masked(msgs, mask, rowptr)

    @staticmethod
    def backward(ctx, g):
        receivers, mask = ctx.saved_tensors
        dm = torch.where(mask[:, None], g.index_select(0, receivers), 0.0)
        return dm, None, None, None


def segment_sum_aggregate(msgs, receivers, mask, rowptr):
    """The masked sum of the receiver-sorted ``msgs`` [E, D] per receiver,
    [N, D] for ``rowptr`` [N + 1] (``segment_sum_masked``, kernel C on the
    card); its backward gives each real edge its receiver's cotangent and a
    masked edge 0."""
    return _SegmentSumAggregate.apply(msgs, receivers, mask, rowptr)
