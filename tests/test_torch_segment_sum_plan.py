"""The launch plan of the segment sum C
(``phc_gnn_torch.ops.segment_sum.segment_sum_plan``), on the CPU.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).  Here the plan is held to what the kernel needs of it:
every segment and every column owned by exactly one CTA, runs of whole
warps, shared memory under the 48 KB a CTA gets without an opt-in, the
float4 instance only where the width and the rows' alignment allow it, and
a grid of several CTAs an SM at the main paths' shapes.  ``_walk`` follows
the kernel's walk on a plan in float32 -- a CTA's run of segments, its
staged mask bytes or perm entries (an edge past them read from the arrays
themselves), a warp a segment, edges in groups of four with every live
row's load before the adds, the adds in edge order from 0 -- and is held
bit for bit to a sequential float32 sum in edge order and within 1e-5 to
the plain version in float64.  Needs no JAX:

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


@pytest.mark.parametrize("n,e,d", SHAPES)
def test_plan_covers_every_segment_and_column_once(n, e, d):
    for perm in (False, True):
        plan = ssum.segment_sum_plan(n, e, d, perm)
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
        assert plan.stage == min(e, plan.run * ssum.SEG_STAGE_PER_SEG)
        assert plan.smem_bytes == 4 * (plan.run + 1) + plan.stage * (
            4 if perm else 1)
        assert plan.smem_bytes <= ssum.SEG_MAX_SMEM


def test_instance_follows_the_width_and_alignment():
    """float4 lanes where d % 4 == 0 and the rows are 16-byte aligned, one
    float a lane otherwise; the fewest chunks of 32 vectors that cover a
    row, column blocks past 4: 512 floats are 4 float4 chunks, 200 floats
    2 (the second 18 lanes live), 37 floats 2 scalar chunks, 768 floats 2
    blocks of 4 float4 chunks."""
    assert ssum.segment_sum_plan(4096, 8192, 512, False)[:3] == (4, 4, 1)
    assert ssum.segment_sum_plan(4096, 8192, 200, True)[:3] == (4, 2, 1)
    assert ssum.segment_sum_plan(4096, 8192, 200, True, False)[:3] == (1, 4, 2)
    assert ssum.segment_sum_plan(64, 1500, 37, False)[:3] == (1, 2, 1)
    assert ssum.segment_sum_plan(100, 400, 768, False)[:3] == (4, 4, 2)
    assert ssum.segment_sum_plan(10, 40, 4, True)[:3] == (4, 1, 1)
    assert ssum.segment_sum_plan(10, 40, 6, True)[:3] == (1, 1, 1)


def test_runs_keep_several_ctas_an_sm():
    """Runs grow from one segment a warp while the grid keeps
    ``SEG_MIN_CTAS`` CTAs: at pcba's eval shape runs of 16 (1,024 CTAs),
    at its train and the flagship's shape runs of 8 (512); a grid that
    could not keep them takes runs of 8, and the largest runs fit the
    shared memory."""
    assert ssum.segment_sum_plan(16384, 32768, 512, False)[3:] == (
        16, 256, 4 * 17 + 256, 1024)
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
@pytest.mark.parametrize("d", [8, 37])
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
    assert (got[3] == 0).all()
    if not perm:
        assert (got[11] == 0).all()
    tv, te, tr = (torch.from_numpy(a) for a in (values, entries, rowptr))
    want = (ssum.segment_sum_perm_plain(tv.double(), te, tr) if perm else
            ssum.segment_sum_masked_plain(tv.double(), te, tr)).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
