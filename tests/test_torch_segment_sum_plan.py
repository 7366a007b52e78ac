"""The launch plan of the segment sum C
(``phc_gnn_torch.ops.segment_sum.segment_sum_plan``), on the CPU.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).  Here the plan is held to what the kernel needs of it:
every segment and every column owned by exactly one CTA, runs of whole
warps, shared memory under the 48 KB a CTA gets without an opt-in, the
16-byte instance (4 float32 or 8 bf16 elements a lane) only where the
width and the rows' alignment allow it, and a grid of several CTAs an SM
at the main paths' shapes, for float32 rows and for bf16 rows (the
model's ``compute_dtype``).  The bulk instance on bf16 rows (its rows
staged by the TMA's bulk copy) appears only where ``d * 2 % 16 == 0``, the
rows are 16-byte aligned and a row fits one column block, and by default
only where the runs reach ``SEG_BULK_MIN_RUN`` or, in the masked role,
the rows ``SEG_BULK_MIN_ROW_BYTES``; its stage of rows fits the shared
memory it opts in to, and ``_walk_bulk`` follows its walk (a warp's
segments' rows staged in order until the warp's stage is full, the rest
read from the arrays) bit for bit to the sequential sum.  ``_walk``
follows the kernel's walk on a plan in float32 -- a CTA's run of
segments, its staged mask bytes or perm entries (an edge past them read from the arrays
themselves), a warp a segment, edges in groups of four with every live
row's load before the adds, the adds in edge order from 0 -- and is held
bit for bit to a sequential float32 sum in edge order and within 1e-5 to
the plain version in float64; on bf16 rows, whose conversion to float32 is
exact, the walk is the float32 walk of the converted rows.  Needs no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_segment_sum_plan.py
"""

import numpy as np
import pytest
import torch

from phc_gnn_torch.graph import build_csr_rowptr, build_sender_csr
from phc_gnn_torch.ops import segment_sum as ssum

UNROLL = 4  # kUnroll of csrc/segment_sum.cu
# (n, e, d): pcba's eval and train receivers at width 512, the flagship's
# senders at 200, an odd width (the scalar instance), a width past one
# column block, one segment
SHAPES = [(16384, 32768, 512), (4096, 8192, 512), (4096, 8192, 200),
          (64, 1500, 37), (100, 400, 768), (1, 3, 8)]


def _ctas(plan, n):
    """(segments, vector columns) of every CTA (b, c) of the grid."""
    cols = plan.chunks * 32
    for b in range(plan.grid):
        for c in range(plan.col_blocks):
            yield (range(b * plan.run, min(n, (b + 1) * plan.run)),
                   range(c * cols, (c + 1) * cols))


def _bulk_rows(run, d):
    """The rows the bulk instance stages a CTA: ``SEG_BULK_ROWS_PER_SEG`` a
    segment, a warp's share at most ``SEG_BULK_MAX_WARP_ROWS`` and within
    the opt-in."""
    fit = ((ssum.SEG_MAX_BULK_SMEM - ssum.seg_bulk_bar_bytes(run))
           // (ssum.SEG_WARPS * 2 * d))
    return ssum.SEG_WARPS * min(
        run // ssum.SEG_WARPS * ssum.SEG_BULK_ROWS_PER_SEG,
        ssum.SEG_BULK_MAX_WARP_ROWS, fit)


@pytest.mark.parametrize("n,e,d", SHAPES)
def test_plan_covers_every_segment_and_column_once(n, e, d):
    for perm, elem_bytes, bulk in ((False, 4, None), (True, 4, None),
                                   (False, 2, None), (True, 2, None),
                                   (False, 2, True), (True, 2, True)):
        plan = ssum.segment_sum_plan(n, e, d, perm, True, elem_bytes, bulk)
        assert plan.vec in (1, 16 // elem_bytes)
        vectors = -(-d // plan.vec)
        owned = np.zeros((n, plan.col_blocks * plan.chunks * 32), np.int64)
        for segs, cols in _ctas(plan, n):
            assert 0 < len(segs) <= plan.run
            owned[segs.start:segs.stop, cols.start:cols.stop] += 1
        assert (owned == 1).all()
        assert (plan.col_blocks - 1) * plan.chunks * 32 < vectors
        # the fewest chunks that cover a row, column blocks only past the
        # most chunks (csrc/segment_sum.cu's plan_ok refuses other plans)
        assert plan.chunks == 1 or 16 * plan.chunks < vectors
        assert plan.col_blocks == 1 or plan.chunks == ssum.SEG_CHUNKS[-1]
        assert plan.run % ssum.SEG_WARPS == 0
        assert plan.run <= ssum.SEG_MAX_RUN and plan.chunks in ssum.SEG_CHUNKS
        if plan.bulk:
            # the bulk instance: a whole number of rows a warp, at most a
            # row a lane, the barriers and rows under the opt-in
            assert elem_bytes == 2 and plan.vec == 8 and plan.col_blocks == 1
            assert plan.stage == _bulk_rows(plan.run, d)
            assert plan.stage % ssum.SEG_WARPS == 0
            assert plan.stage // ssum.SEG_WARPS <= ssum.SEG_BULK_MAX_WARP_ROWS
            assert plan.smem_bytes == (ssum.seg_bulk_bar_bytes(plan.run)
                                       + plan.stage * 2 * d)
            assert plan.smem_bytes <= ssum.SEG_MAX_BULK_SMEM
            continue
        assert plan.stage == min(e, plan.run * ssum.SEG_STAGE_PER_SEG)
        assert plan.smem_bytes == 4 * (plan.run + 1) + plan.stage * (
            4 if perm else 1)
        assert plan.smem_bytes <= ssum.SEG_MAX_SMEM


def test_instance_follows_the_width_and_alignment():
    """16-byte lanes where d is a multiple of their elements and the rows
    are 16-byte aligned, one element a lane otherwise; the fewest chunks of
    32 vectors that cover a row, column blocks past 4: 512 floats are 4
    float4 chunks, 200 floats 2 (the second 18 lanes live), 37 floats 2
    scalar chunks, 768 floats 2 blocks of 4 float4 chunks.  In bf16 a lane
    loads 8 elements: 512 are 2 chunks, 200 one (25 lanes live), 768 one
    block of 4 chunks, and 4 or 6 take the scalar instance."""
    bf16 = dict(elem_bytes=2)
    assert ssum.segment_sum_plan(4096, 8192, 512, False, **bf16)[:3] == (
        8, 2, 1)
    assert ssum.segment_sum_plan(4096, 8192, 200, True, **bf16)[:3] == (
        8, 1, 1)
    assert ssum.segment_sum_plan(4096, 8192, 200, True, False, 2)[:3] == (
        1, 4, 2)
    assert ssum.segment_sum_plan(100, 400, 768, False, **bf16)[:3] == (
        8, 4, 1)
    assert ssum.segment_sum_plan(10, 40, 8, True, **bf16)[:3] == (8, 1, 1)
    assert ssum.segment_sum_plan(10, 40, 4, True, **bf16)[:3] == (1, 1, 1)
    assert ssum.segment_sum_plan(4096, 8192, 512, False)[:3] == (4, 4, 1)
    assert ssum.segment_sum_plan(4096, 8192, 200, True)[:3] == (4, 2, 1)
    assert ssum.segment_sum_plan(4096, 8192, 200, True, False)[:3] == (1, 4, 2)
    assert ssum.segment_sum_plan(64, 1500, 37, False)[:3] == (1, 2, 1)
    assert ssum.segment_sum_plan(100, 400, 768, False)[:3] == (4, 4, 2)
    assert ssum.segment_sum_plan(10, 40, 4, True)[:3] == (4, 1, 1)
    assert ssum.segment_sum_plan(10, 40, 6, True)[:3] == (1, 1, 1)


@pytest.mark.parametrize("d", [8, 16, 200, 512, 768, 1024, 1032, 4, 37, 6])
@pytest.mark.parametrize("aligned", [True, False])
def test_bulk_instance_only_where_the_rows_allow_it(d, aligned):
    """The bulk instance needs 16-byte rows (``d * 2 % 16 == 0``), 16-byte
    aligned rows and one column block (``d <= 1024``); float32 rows never
    take it; by default it runs from runs of ``SEG_BULK_MIN_RUN`` segments
    (16,384 segments: pcba's eval batch and its 16k bucket's gather) and,
    in the masked role, on rows of ``SEG_BULK_MIN_ROW_BYTES`` (pcba's
    width); ``bulk=False`` keeps the instance without it."""
    allowed = d * 2 % 16 == 0 and aligned and d <= 1024
    for n, e in ((4096, 8192), (16384, 32768)):
        for perm in (False, True):
            forced = ssum.segment_sum_plan(n, e, d, perm, aligned, 2, True)
            assert forced.bulk == allowed
            default = ssum.segment_sum_plan(n, e, d, perm, aligned, 2)
            assert default.bulk == (allowed and (
                default.run >= ssum.SEG_BULK_MIN_RUN
                or (not perm and 2 * d >= ssum.SEG_BULK_MIN_ROW_BYTES)))
            assert ssum.segment_sum_plan(n, e, d, perm, aligned, 2,
                                         False).bulk is False
            assert ssum.segment_sum_plan(n, e, d, perm, aligned, 4,
                                         True).bulk is False
    # the main paths' shapes: pcba's sum aggregation (train and eval) and
    # the gather backward of a train step on its 16k bucket take it; the
    # flagship's gather, its sum at width 200, the gather backward of
    # pcba's 4,096-node train batch and the halo role do not
    for n, e, d, perm in ((16384, 32768, 512, False),
                          (16384, 32768, 512, True),
                          (4096, 8192, 512, False)):
        assert ssum.segment_sum_plan(n, e, d, perm, True, 2).bulk
    for n, e, d, perm in ((4096, 8192, 512, True), (4096, 8192, 200, True),
                          (4096, 8192, 200, False), (2064, 4480, 200, True),
                          (1032, 2240, 200, True)):
        assert not ssum.segment_sum_plan(n, e, d, perm, True, 2).bulk


def test_bulk_stage_fits_its_shared_memory():
    """At the widest row the instance takes (1,024 bf16, 2 KB) and the
    longest runs the stage shrinks to fit ``SEG_MAX_BULK_SMEM`` (a row
    more a warp would not); at pcba's eval shape it holds 4 rows a segment
    of a run of 16, 8 a warp, 64 KB beside 16 barriers."""
    wide = ssum.segment_sum_plan(10 ** 7, 4 * 10 ** 7, 1024, True, True, 2,
                                 True)
    assert wide.run == ssum.SEG_MAX_RUN and wide.bulk
    assert wide.stage < wide.run * ssum.SEG_BULK_ROWS_PER_SEG
    assert wide.smem_bytes <= ssum.SEG_MAX_BULK_SMEM
    assert (wide.smem_bytes + ssum.SEG_WARPS * 2 * 1024
            > ssum.SEG_MAX_BULK_SMEM)
    pcba = ssum.segment_sum_plan(16384, 32768, 512, False, True, 2)
    assert (pcba.run, pcba.stage, pcba.smem_bytes, pcba.grid, pcba.bulk) == (
        16, 64, 128 + 64 * 1024, 1024, True)


def test_runs_keep_several_ctas_an_sm():
    """Runs grow from one segment a warp while the grid keeps
    ``SEG_MIN_CTAS`` CTAs: at pcba's eval shape runs of 16 (1,024 CTAs),
    at its train and the flagship's shape runs of 8 (512); a grid that
    could not keep them takes runs of 8, and the largest runs fit the
    shared memory."""
    assert ssum.segment_sum_plan(16384, 32768, 512, False)[3:] == (
        16, 256, 4 * 17 + 256, 1024, False)
    assert ssum.segment_sum_plan(4096, 8192, 512, True).grid == 512
    assert ssum.segment_sum_plan(4096, 8192, 200, True).run == 8
    assert ssum.segment_sum_plan(129, 300, 100, False).run == 8
    big = ssum.segment_sum_plan(10 ** 7, 4 * 10 ** 7, 512, True)
    assert big.run == ssum.SEG_MAX_RUN and big.grid * big.run >= 10 ** 7
    assert big.smem_bytes <= ssum.SEG_MAX_SMEM


def _walk(values, entries, rowptr, plan, perm):
    """The kernel's walk on ``plan`` in float32: ``entries`` is perm (1) or
    the mask (2)."""
    n = rowptr.shape[0] - 1
    out = np.full((n, values.shape[1]), np.nan, np.float32)
    for b in range(plan.grid):
        s0 = b * plan.run
        segs = min(plan.run, n - s0)
        e0 = int(rowptr[s0])
        staged = min(int(rowptr[s0 + segs]) - e0, plan.stage)
        stage = entries[e0:e0 + staged].copy()
        for i in range(segs):  # warp i % SEG_WARPS takes segment s0 + i
            lo, hi = int(rowptr[s0 + i]), int(rowptr[s0 + i + 1])
            acc = np.zeros(values.shape[1], np.float32)
            for e in range(lo, hi, UNROLL):
                rows = []
                for ee in range(e, min(e + UNROLL, hi)):
                    k = ee - e0
                    entry = stage[k] if k < staged else entries[ee]
                    if perm:
                        rows.append(values[entry])
                    elif entry:
                        rows.append(values[ee])
                for row in rows:  # every load of the group, then the adds
                    acc = acc + row
            out[s0 + i] = acc
    return out


def _walk_bulk(values, entries, rowptr, plan, perm):
    """The bulk instance's walk on ``plan`` in float32: warp w of CTA b
    owns the run's segments w, w + SEG_WARPS, ...; a prefix sum over them
    places their rows in the warp's stage of ``stage / SEG_WARPS`` rows,
    in order, until it is full; the first 32 mask bits of a segment come
    from its ballot, the rest, and the rows past the stage, from the
    arrays."""
    n = rowptr.shape[0] - 1
    out = np.full((n, values.shape[1]), np.nan, np.float32)
    cap = plan.stage // ssum.SEG_WARPS
    for b in range(plan.grid):
        for w in range(ssum.SEG_WARPS):
            segs = [s for s in range(b * plan.run + w, (b + 1) * plan.run,
                                     ssum.SEG_WARPS) if s < n]
            stage, off = [], 0
            for s in segs:
                lo, hi = int(rowptr[s]), int(rowptr[s + 1])
                held = max(0, min(hi - lo, cap - off))
                stage.append((off, held, [
                    values[entries[e]] if perm else values[e]
                    for e in range(lo, lo + held)]))
                off += hi - lo
            rows = {}
            for off_s, _, staged in stage:
                for i, row in enumerate(staged):
                    rows[off_s + i] = row
            for s, (off_s, held, _) in zip(segs, stage):
                lo, hi = int(rowptr[s]), int(rowptr[s + 1])
                ballot = entries[lo:lo + 32] if not perm else None
                acc = np.zeros(values.shape[1], np.float32)
                for k in range(hi - lo):  # groups of four: the same order
                    e = lo + k
                    if not perm and not (ballot[k] if k < 32 else entries[e]):
                        continue
                    row = (rows[off_s + k] if k < held else
                           values[entries[e]] if perm else values[e])
                    acc = acc + row
                out[s] = acc
    return out


def _sequential(values, entries, rowptr, perm):
    """A sequential float32 sum of each segment's rows in edge order."""
    n = rowptr.shape[0] - 1
    out = np.zeros((n, values.shape[1]), np.float32)
    for s in range(n):
        for e in range(rowptr[s], rowptr[s + 1]):
            if perm:
                out[s] = out[s] + values[entries[e]]
            elif entries[e]:
                out[s] = out[s] + values[e]
    return out


def _adversarial(rng, n=48):
    """Edges per node 1-5, none for node 3, 1,100 for node 7 (past a run's
    staged entries), masked edges inside segments, an all-masked node 11,
    a masked tail of 40 edges."""
    counts = rng.integers(1, 6, size=n)
    counts[3], counts[7] = 0, 1100
    nodes = np.repeat(np.arange(n), counts)
    mask = rng.random(nodes.shape[0]) > 0.25
    lo = counts[:11].sum()
    mask[lo:lo + counts[11]] = False
    nodes = np.concatenate([nodes, np.full(40, n - 1)]).astype(np.int32)
    return nodes, np.concatenate([mask, np.zeros(40, bool)]), n


@pytest.mark.parametrize("role", ["masked", "perm"])
@pytest.mark.parametrize("d", [8, 37, 200])
def test_kernel_walk_on_the_plan_matches_plain(role, d):
    """Receivers (masked role) or senders in no order (perm role) with an
    isolated node, a node of 1,100 edges, masked edges inside segments and
    an all-masked node: the walk is bit-equal to the sequential f32 sum,
    0 exactly on the isolated and all-masked nodes, and within 1e-5 of each
    output's max of the plain version in float64."""
    rng = np.random.default_rng(17 + d)
    nodes, mask, n = _adversarial(rng)
    values = rng.uniform(-32, 32, size=(nodes.shape[0], d)).astype(np.float32)
    perm = role == "perm"
    if perm:
        nodes = rng.permutation(nodes[:-40])
        mask = rng.random(nodes.shape[0]) > 0.2
        values = values[:nodes.shape[0]]
        entries, rowptr = build_sender_csr(nodes, n, mask)
    else:
        rowptr = build_csr_rowptr(nodes, n, mask)
        entries = mask
    plan = ssum.segment_sum_plan(n, values.shape[0], d, perm)
    assert plan.stage < int(rowptr[-1])  # node 7 reads past the staged ones
    got = _walk(values, entries, rowptr, plan, perm)
    assert np.array_equal(got, _sequential(values, entries, rowptr, perm))
    # bf16 rows: their own plan, the walk of the exactly converted rows,
    # and the plain version's float32 output from the bf16 rows themselves
    rows16 = torch.from_numpy(values).to(torch.bfloat16)
    up = rows16.float().numpy()
    plan16 = ssum.segment_sum_plan(n, values.shape[0], d, perm, True, 2)
    got16 = _walk(up, entries, rowptr, plan16, perm)
    assert np.array_equal(got16, _sequential(up, entries, rowptr, perm))
    # the bulk instance, where the width allows it: node 7's 1,100 edges
    # run past its staged rows and entries, which the walk then reads from
    # the arrays, in the same order
    bulk = ssum.segment_sum_plan(n, values.shape[0], d, perm, True, 2, True)
    assert bulk.bulk == (d % 8 == 0)
    if bulk.bulk:
        assert bulk.stage // ssum.SEG_WARPS < 1100
        assert np.array_equal(_walk_bulk(up, entries, rowptr, bulk, perm),
                              got16)
    te16, tr16 = torch.from_numpy(entries), torch.from_numpy(rowptr)
    plain16 = (ssum.segment_sum_perm_plain(rows16, te16, tr16) if perm else
               ssum.segment_sum_masked_plain(rows16, te16, tr16))
    assert plain16.dtype == torch.float32
    assert (np.abs(plain16.numpy() - got16).max()
            <= 1e-5 * np.abs(got16).max())
    assert (got[3] == 0).all()
    if not perm:
        assert (got[11] == 0).all()
    tv, te, tr = (torch.from_numpy(a) for a in (values, entries, rowptr))
    want = (ssum.segment_sum_perm_plain(tv.double(), te, tr) if perm else
            ssum.segment_sum_masked_plain(tv.double(), te, tr)).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
