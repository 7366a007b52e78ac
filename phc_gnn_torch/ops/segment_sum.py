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

- ``halo_gather_split_bwd``, C's halo role, as ``_halo_gs_bwd``
  (:912-927) runs it: the perm role over the sender CSR of a node shard's
  augmented ``[NS + S*H]`` rows (its own NS nodes, then the halo rows
  received from each of S shards), split into the local and the halo
  cotangents.  The same kernel and plan as ``segment_sum_perm``, with
  ``NS + S*H`` segments; counted on its own wrapper.

Around them:

- ``gather_nodes`` is ``x[senders]`` (``gather_nodes_streamed``, :873): its
  forward is the plain take, its backward ``dx[senders] += g`` is
  ``segment_sum_perm`` over the batch's sender CSR
  (``graph.batch.build_sender_csr``), in which masked edges belong to no
  segment.
- ``halo_gather_split`` is ``halo_gather_split_streamed`` (:931): the
  gather ``concat([x, x_remote])[senders]`` of a node shard, whose backward
  is ``halo_gather_split_bwd``.
- ``segment_sum_aggregate`` is ``segment_sum_streamed`` (:726): its forward
  is ``segment_sum_masked``, its backward JAX's VJP, the gather
  ``g[receivers]`` (:715-720), 0 on masked edges (JAX zeroes their messages
  before the scan, :741-742).

A wrapper runs the plain version for tensors on the CPU.  For CUDA tensors
it launches the kernel or raises; it never falls back.  ``<wrapper>.launches``
counts the launches of the float32 instance, ``<wrapper>.launches_bf16``
those of the bf16 one.  The kernels trust
``rowptr`` to be ascending and ``perm`` to index rows of ``values`` (checking
would cost a host sync per launch); ``graph.attach_csr_plan`` builds both.

``segment_sum_plan`` computes the launch (``csrc/segment_sum.cu`` checks
it): a warp a segment, a CTA a run of consecutive segments whose CSR slice
and mask bytes or perm entries it stages in shared memory, 16-byte lanes
(4 float32 or 8 bf16 elements) where the rows allow them.  On bf16 rows
16-byte aligned with ``d % 8 == 0`` and ``d <= 1024`` it has a bulk
instance: each warp's segments' first rows (``stage`` a CTA) come into
shared memory by the TMA's bulk copy, one copy of a segment's contiguous
range (masked role) or one a gathered row (perm role), before the warp
sums them.  The plan takes it where it timed faster than the instance
without it: in the masked role on rows of ``SEG_BULK_MIN_ROW_BYTES`` or
more (pcba's sum aggregation, train and eval), and in either role where
the runs reach ``SEG_BULK_MIN_RUN`` segments (16,384 segments: pcba's
eval batch, and the gather backward of a train step on pcba's 16k
bucket); not in the perm role at runs of 8 (the flagship's and pcba's
4,096-node batches), nor in the halo role.  ``segment_sum_instance``
launches either instance, uncounted, for the checks and the timing
tools.

The rows may be float32 or bfloat16 (the model's ``compute_dtype``): a
bf16 launch converts each row at its load and sums in float32, as JAX's
scan converts its block (stream_scan.py:375-380); every output is float32.
The plain versions upcast bf16 rows first, so that they sum in float32 as
the kernel does (torch's bf16 ``index_add_`` would sum in bf16).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from phc_gnn_torch.ops import _build

__all__ = ["SegSumPlan", "segment_sum_plan", "segment_sum_perm",
           "segment_sum_perm_plain", "segment_sum_masked",
           "segment_sum_masked_plain", "segment_sum_instance",
           "gather_nodes", "halo_gather_split",
           "halo_gather_split_bwd", "halo_gather_split_bwd_plain",
           "segment_sum_aggregate",
           "segment_ids", "check_masked_csr", "count_launch", "ROW_DTYPES",
           "upcast"]

# the launch plan (csrc/segment_sum.cu holds the same constants)
SEG_WARPS = 8               # warps a CTA, one a segment at a time (kWarps)
SEG_MAX_RUN = 64            # segments a CTA, at most (kMaxRun)
SEG_CHUNKS = (1, 2, 4)      # vectors of a row a lane holds, per column block
SEG_STAGE_PER_SEG = 16      # staged mask bytes or perm entries a segment
SEG_MAX_SMEM = 48 * 1024    # dynamic shared memory without an opt-in
SEG_MIN_CTAS = 4 * _build.SMS  # runs grow only while the grid keeps 4 CTAs
                               # an SM
SEG_BULK_ROWS_PER_SEG = 4   # rows the bulk instance stages a segment of a run
SEG_BULK_MAX_WARP_ROWS = 32  # ... a warp at most (a lane a gathered row)
SEG_BULK_MIN_RUN = 16       # runs from which the plan takes it
SEG_BULK_MIN_ROW_BYTES = 1024  # ... and rows, in the masked role
SEG_MAX_BULK_SMEM = 200 * 1024  # the dynamic shared memory it opts in to


def seg_bulk_bar_bytes(run: int) -> int:
    """The bulk instance's mbarriers, one a segment of a run, padded to 16
    bytes (``bar_bytes``)."""
    return -(-8 * run // 16) * 16


class SegSumPlan(NamedTuple):
    """The launch of C: ``grid`` x ``col_blocks`` CTAs of ``SEG_WARPS``
    warps; CTA (b, c) owns the segments ``[b * run, min(n, (b + 1) * run))``
    and the columns ``[c * cols, (c + 1) * cols)``, ``cols = chunks * 32 *
    vec``; a lane holds ``chunks`` accumulators of ``vec`` elements (16
    bytes of them loaded at once where ``vec`` > 1); ``stage`` mask bytes or
    perm entries of the run's edges sit in ``smem_bytes`` of shared memory
    beside its ``run + 1`` row pointers.  ``bulk``, the bulk instance:
    ``stage`` rows a CTA, ``stage / SEG_WARPS`` a warp for its segments,
    sit there after the segments' mbarriers (``seg_bulk_bar_bytes``); the
    entries stay in registers."""
    vec: int
    chunks: int
    col_blocks: int
    run: int
    stage: int
    smem_bytes: int
    grid: int
    bulk: bool = False


@functools.lru_cache(maxsize=256)
def segment_sum_plan(n: int, e: int, d: int, perm: bool,
                     aligned: bool = True, elem_bytes: int = 4,
                     bulk: Optional[bool] = None) -> SegSumPlan:
    """The launch plan of C over ``n`` segments of ``e`` edges of ``d``
    elements of ``elem_bytes`` bytes (4: float32, 2: bf16), in the perm role
    (``perm``) or the masked one: 16-byte lanes of ``16 // elem_bytes``
    elements where ``d`` is a multiple of it and the rows are 16-byte
    ``aligned``, else one element a lane (the scalar instance); the fewest
    of ``SEG_CHUNKS`` vectors a lane that cover a row, in column blocks past
    4; runs of ``SEG_WARPS`` * 2^k segments, the longest up to
    ``SEG_MAX_RUN`` whose grid keeps ``SEG_MIN_CTAS`` CTAs; and up to
    ``SEG_STAGE_PER_SEG`` staged entries a segment of the run, no more than
    ``e``.  bf16 rows with 16-byte lanes in one column block take the bulk
    instance where ``bulk`` is True, or by default (``bulk=None``) where
    the run reaches ``SEG_BULK_MIN_RUN`` or, in the masked role, a row
    ``SEG_BULK_MIN_ROW_BYTES``: ``SEG_BULK_ROWS_PER_SEG`` rows a segment
    of the run, no more than ``SEG_BULK_MAX_WARP_ROWS`` a warp nor than
    fit ``SEG_MAX_BULK_SMEM``; ``bulk=False`` keeps the instance without
    it."""
    wide = 16 // elem_bytes
    vec = wide if aligned and d % wide == 0 else 1
    vectors = -(-d // vec)
    chunks = next((c for c in SEG_CHUNKS if 32 * c >= vectors), SEG_CHUNKS[-1])
    col_blocks = max(1, -(-vectors // (32 * chunks)))
    run = SEG_WARPS
    while (2 * run <= SEG_MAX_RUN
           and -(-n // (2 * run)) * col_blocks >= SEG_MIN_CTAS):
        run *= 2
    entry = 4 if perm else 1
    grid = -(-n // run)
    if bulk is None:
        bulk = run >= SEG_BULK_MIN_RUN or (
            not perm and d * elem_bytes >= SEG_BULK_MIN_ROW_BYTES)
    if bulk and elem_bytes == 2 and vec == wide and col_blocks == 1:
        bars = seg_bulk_bar_bytes(run)
        per_warp = min(run // SEG_WARPS * SEG_BULK_ROWS_PER_SEG,
                       SEG_BULK_MAX_WARP_ROWS,
                       (SEG_MAX_BULK_SMEM - bars) // (SEG_WARPS * 2 * d))
        if per_warp > 0:
            rows = SEG_WARPS * per_warp
            return SegSumPlan(vec, chunks, col_blocks, run, rows,
                              bars + rows * 2 * d, grid, True)
    stage = min(e, run * SEG_STAGE_PER_SEG)
    return SegSumPlan(vec, chunks, col_blocks, run, stage,
                      4 * (run + 1) + stage * entry, grid)


_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_typed_lib = None


def _lib():
    global _typed_lib
    if _typed_lib is None:
        lib = _build.load("segment_sum")
        for fn in (lib.segment_sum_perm_f32, lib.segment_sum_masked_f32,
                   lib.segment_sum_perm_bf16, lib.segment_sum_masked_bf16):
            fn.argtypes = [_P] * 4 + [_I64] * 10 + [_P]
            fn.restype = ctypes.c_int
        _typed_lib = lib
    return _typed_lib


def segment_ids(rowptr):
    """The segment of each edge inside the CSR segments of ``rowptr``
    [N + 1]: ``rowptr[-1]`` entries, ascending."""
    n = rowptr.shape[0] - 1
    counts = (rowptr[1:] - rowptr[:-1]).long()
    return torch.repeat_interleave(torch.arange(n, device=rowptr.device), counts)


def upcast(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32 where it is narrower (bf16 rows, which the kernels
    and JAX's glue sum in float32); float32 and float64 (the checks'
    witness) stay as they are."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def segment_sum_perm_plain(values, perm, rowptr):
    """The kernel's function in ``values``' dtype, bf16 rows summed in
    float32 (the checks pass float64, so that the order of the sums does
    not matter)."""
    seg = segment_ids(rowptr)
    values = upcast(values)
    rows = values.index_select(0, perm[:seg.shape[0]].long())
    out = torch.zeros((rowptr.shape[0] - 1, values.shape[1]),
                      dtype=values.dtype, device=values.device)
    return out.index_add_(0, seg, rows)


def segment_sum_masked_plain(msgs, mask, rowptr):
    """The forward kernel's function in ``msgs``' dtype, bf16 rows summed in
    float32 (the checks pass float64)."""
    seg = segment_ids(rowptr)
    msgs = upcast(msgs)
    rows = torch.where(mask[:seg.shape[0], None], msgs[:seg.shape[0]], 0)
    out = torch.zeros((rowptr.shape[0] - 1, msgs.shape[1]), dtype=msgs.dtype,
                      device=msgs.device)
    return out.index_add_(0, seg, rows)


ROW_DTYPES = (torch.float32, torch.bfloat16)  # the rows C, A and B read


def _check(name, values, index, rowptr, dtypes=ROW_DTYPES):
    """Device, dtype, shape and contiguity of a segment-sum launch;
    ``index`` is ``(name, tensor, dtype)``; the rows' dtype one of
    ``dtypes``."""
    dev = values.device
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on CPU or CUDA tensors, got {dev}")
    if values.dtype not in dtypes or values.ndim != 2:
        names = " or ".join(str(t).replace("torch.", "") for t in dtypes)
        raise TypeError(f"values must be a 2-D {names} tensor, got "
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


def check_masked_csr(name, msgs, mask, rowptr, dtypes=ROW_DTYPES):
    """``_check`` of a launch over the receiver CSR that reads ``mask`` [E]
    beside ``msgs`` [E, D]: C's forward role (float32 or bf16 rows), and
    kernels H and I (float32 only)."""
    _check(name, msgs, ("mask", mask, torch.bool), rowptr, dtypes)
    if mask.shape[0] != msgs.shape[0]:
        raise ValueError(f"mask has {mask.shape[0]} entries for "
                         f"{msgs.shape[0]} rows of msgs")


def _launch(role, values, index, rowptr, bulk: Optional[bool] = None):
    """Launch C's entry point ``segment_sum_<role>_<f32|bf16>`` on its
    checked inputs into a new float32 [N, D] output, on
    ``segment_sum_plan``; the instance follows ``values``' dtype, width and
    alignment, and ``bulk``."""
    n, (e, d) = rowptr.shape[0] - 1, values.shape
    bf16 = values.dtype == torch.bfloat16
    fn = getattr(_lib(), f"segment_sum_{role}_{'bf16' if bf16 else 'f32'}")
    out = torch.empty((n, d), dtype=torch.float32, device=values.device)
    plan = segment_sum_plan(n, e, d, role == "perm",
                            values.data_ptr() % 16 == 0,
                            values.element_size(), bulk)
    _build.check_launch(fn.__name__, fn(
        values.data_ptr(), index.data_ptr(), rowptr.data_ptr(), out.data_ptr(),
        n, d, *plan, _build.stream(values.device)))
    return out


def segment_sum_instance(role: str, values, index, rowptr,
                         bulk: Optional[bool] = None):
    """C in ``role`` ("perm": ``index`` is perm; "masked": the mask) on a
    CUDA tensor, on the instance ``bulk`` asks for (True: the bulk instance
    where the rows allow it; False: the instance without it; None: the
    plan's choice), counted on no wrapper: the checks and the timing tools
    hold and time the two instances with it."""
    if role == "perm":
        _check("segment_sum_perm", values, ("perm", index, torch.int32),
               rowptr)
    else:
        check_masked_csr("segment_sum_masked", values, index, rowptr)
    return _launch(role, values, index, rowptr, bulk)


def count_launch(wrapper, values) -> None:
    """One launch of ``wrapper``'s instance for ``values``' dtype: its
    ``launches_bf16`` for bf16 rows, else its ``launches``."""
    if values.dtype == torch.bfloat16:
        wrapper.launches_bf16 += 1
    else:
        wrapper.launches += 1


def _perm_sum(wrapper, values, perm, rowptr):
    """C's perm role for ``wrapper``: the plain version on the CPU, else one
    launch counted on ``wrapper``."""
    if values.device.type == "cpu":
        return segment_sum_perm_plain(values, perm, rowptr)
    _check(wrapper.__name__, values, ("perm", perm, torch.int32), rowptr)
    out = _launch("perm", values, perm, rowptr)
    count_launch(wrapper, values)
    return out


def segment_sum_perm(values, perm, rowptr):
    """[N, D] float32 sums of the rows ``values[perm[e]]`` (float32 or
    bf16) over each CSR segment of ``rowptr`` [N + 1]."""
    return _perm_sum(segment_sum_perm, values, perm, rowptr)


segment_sum_perm.launches = 0
segment_sum_perm.launches_bf16 = 0


def segment_sum_masked(msgs, mask, rowptr):
    """[N, D] float32 sums of the rows ``msgs[e]`` (float32 or bf16) whose
    ``mask[e]`` holds over each CSR segment of ``rowptr`` [N + 1]."""
    if msgs.device.type == "cpu":
        return segment_sum_masked_plain(msgs, mask, rowptr)
    check_masked_csr("segment_sum_masked", msgs, mask, rowptr)
    out = _launch("masked", msgs, mask, rowptr)
    count_launch(segment_sum_masked, msgs)
    return out


segment_sum_masked.launches = 0
segment_sum_masked.launches_bf16 = 0


class _GatherNodes(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, senders, snd_perm, snd_rowptr):
        ctx.save_for_backward(snd_perm, snd_rowptr)
        ctx.x_dtype = x.dtype
        return x.index_select(0, senders)

    @staticmethod
    def backward(ctx, g):
        # a bf16 cotangent goes into C's bf16 instance as it is: JAX casts
        # it to f32 first (stream_scan.py:861), an exact conversion, so the
        # sums are the same; dx comes back in x's dtype (:867)
        snd_perm, snd_rowptr = ctx.saved_tensors
        if g.dtype not in ROW_DTYPES:
            g = g.float()
        dx = segment_sum_perm(g.contiguous(), snd_perm, snd_rowptr)
        return dx.to(ctx.x_dtype), None, None, None


def gather_nodes(x, senders, snd_perm, snd_rowptr):
    """``x[senders]`` whose backward sums the cotangent rows per sender over
    the sender CSR (kernel C on the card); ``snd_rowptr`` has
    ``x.shape[0] + 1`` entries."""
    if snd_rowptr.shape[0] != x.shape[0] + 1:
        raise ValueError(f"snd_rowptr has {snd_rowptr.shape[0]} entries for "
                         f"{x.shape[0]} rows of x")
    return _GatherNodes.apply(x, senders, snd_perm, snd_rowptr)


def halo_gather_split_bwd_plain(g, snd_perm, snd_rowptr, ns: int):
    """``halo_gather_split_bwd``'s function in ``g``'s dtype, bf16 rows
    summed in float32 (the checks pass float64)."""
    dsrc = segment_sum_perm_plain(g, snd_perm, snd_rowptr)
    return dsrc[:ns], dsrc[ns:]


def halo_gather_split_bwd(g, snd_perm, snd_rowptr, ns: int):
    """``(dx [ns, D], dx_remote [R - ns, D])``, float32: the rows of ``g``
    [E, D] (float32 or bf16) summed per sender over the sender CSR
    ``snd_rowptr`` [R + 1] of a node shard's ``R = NS + S*H`` augmented rows,
    split at ``ns`` into the shard's own rows and its halo rows (kernel C
    on the card, ``_halo_gs_bwd``)."""
    dsrc = _perm_sum(halo_gather_split_bwd, g, snd_perm, snd_rowptr)
    return dsrc[:ns], dsrc[ns:]


halo_gather_split_bwd.launches = 0
halo_gather_split_bwd.launches_bf16 = 0


class _HaloGatherSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, x_remote, senders, snd_perm, snd_rowptr):
        ctx.save_for_backward(snd_perm, snd_rowptr)
        ctx.dtypes = (x.dtype, x_remote.dtype)
        ctx.ns = x.shape[0]
        return torch.cat([x, x_remote]).index_select(0, senders)

    @staticmethod
    def backward(ctx, g):
        # JAX casts g to float32 first (stream_scan.py:922), exact for bf16,
        # and casts the sums back to x's dtype (:925)
        snd_perm, snd_rowptr = ctx.saved_tensors
        if g.dtype not in ROW_DTYPES:
            g = g.float()
        dx, dxr = halo_gather_split_bwd(g.contiguous(), snd_perm, snd_rowptr,
                                        ctx.ns)
        return (dx.to(ctx.dtypes[0]), dxr.to(ctx.dtypes[1]), None, None,
                None)


def halo_gather_split(x, x_remote, senders, snd_perm, snd_rowptr):
    """``concat([x, x_remote])[senders]`` for a node shard: ``senders``
    index its augmented rows, ``x`` [NS, D] its own nodes and ``x_remote``
    [S*H, D] the halo rows the exchange received
    (``parallel.halo.halo_exchange``).  The backward sums the cotangent
    rows per augmented row over the sender CSR ``snd_rowptr`` [NS + S*H + 1]
    (``halo_gather_split_bwd``) and returns the local part to ``x`` and the
    halo part to ``x_remote``, whose backward sends it back."""
    rows = x.shape[0] + x_remote.shape[0]
    if snd_rowptr.shape[0] != rows + 1:
        raise ValueError(f"snd_rowptr has {snd_rowptr.shape[0]} entries for "
                         f"{x.shape[0]} + {x_remote.shape[0]} rows")
    return _HaloGatherSplit.apply(x, x_remote, senders, snd_perm, snd_rowptr)


class _SegmentSumAggregate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, msgs, receivers, mask, rowptr):
        ctx.save_for_backward(receivers, mask)
        ctx.msgs_dtype = msgs.dtype
        return segment_sum_masked(msgs, mask, rowptr)

    @staticmethod
    def backward(ctx, g):
        receivers, mask = ctx.saved_tensors
        dm = torch.where(mask[:, None], g.index_select(0, receivers), 0.0)
        return dm.to(ctx.msgs_dtype), None, None, None


def segment_sum_aggregate(msgs, receivers, mask, rowptr):
    """The masked sum of the receiver-sorted ``msgs`` [E, D] per receiver,
    float32 [N, D] for ``rowptr`` [N + 1] (``segment_sum_masked``, kernel C
    on the card); its backward gives each real edge its receiver's
    cotangent and a masked edge 0, in ``msgs``' dtype (stream_scan.py:
    715-720)."""
    return _SegmentSumAggregate.apply(msgs, receivers, mask, rowptr)
