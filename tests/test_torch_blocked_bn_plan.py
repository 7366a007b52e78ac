"""The launch plan of the row-blocked batch norm F and G on the CPU: the
plan of D and E (``phc_gnn_torch.ops.fused_bn.bn_plan``) at the shapes past
the size gate.

F and G are the cluster kernels of D and E on the same plan, each with its
elementwise pass fused in; they run only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).  Here the plan is held to
what they need of it at those shapes: every row and column owned by exactly
one CTA, the tile and the static shared memory within the card's 232,448
bytes a block, every CTA's rows whole with two CTAs an SM at pcba's [4096,
512] (one wave), and chunks of a full tile where a CTA's rows do not fit.
``_emulate`` (``tests/test_torch_bn_plan.py``) follows the kernels' order of
operations on the plan in float32 and is held to the plain versions in
float64.
"""

import itertools

import numpy as np
import pytest
import torch

from phc_gnn_torch.ops import fused_bn
from test_torch_bn_plan import SMEM_PER_BLOCK, _emulate, _tiles
from torch_threads import one_torch_thread  # noqa: F401

SMS = 132                     # H100 SXM
SMEM_PER_SM = 233_472         # 228 KiB of shared memory an SM
RESERVED = 1024               # the system's shared memory a CTA
BLOCKED_SHAPES = [(4096, 512), (4096, 214), (16384, 512), (65536, 512),
                  (1100, 24)]


def _per_sm(plan):
    """CTAs of the plan that share an SM."""
    return SMEM_PER_SM // (plan.smem_bytes + fused_bn.BN_STATIC_SMEM
                           + RESERVED)


@pytest.mark.parametrize("n,d", BLOCKED_SHAPES)
def test_blocked_plan_covers_every_row_and_column_once(n, d):
    for tensors in (1, 2):
        plan = fused_bn.bn_plan(n, d, tensors)
        slabs = -(-d // plan.slab_cols)
        assert plan.grid == slabs * plan.cluster
        # the grid is slabs x ranks, so one CTA a cell iff the ranks'
        # rows and the slabs' columns each cover their axis once
        rows, cols = np.zeros(n, np.int64), np.zeros(d, np.int64)
        for b, (r, c) in enumerate(_tiles(plan, n, d)):
            slab, rank = divmod(b, plan.cluster)
            if slab == 0:
                rows[r.start:r.stop] += 1
            if rank == 0:
                cols[c.start:c.stop] += 1
        assert (rows == 1).all() and (cols == 1).all(), (n, d, tensors)
        assert 1 <= plan.cluster <= fused_bn.BN_MAX_CLUSTER
        assert plan.smem_bytes + fused_bn.BN_STATIC_SMEM <= SMEM_PER_BLOCK
        row_bytes = plan.slab_cols * 4 * tensors + 1  # and a mask byte
        assert 0 <= plan.smem_bytes - plan.chunk_rows * row_bytes < 16
        assert plan.smem_bytes % 16 == 0
        assert plan.smem_bytes <= fused_bn.BN_TILE_BYTES


def test_blocked_plan_fills_one_wave_at_the_pcba_width():
    """pcba's conv outputs [4096, 512]: 32 slabs x clusters of 5 = 160 CTAs
    of 820 rows, each tile whole (53 KB of x for F, 106 KB of x and g for
    G), at least two CTAs an SM, so that every cluster is resident at
    once."""
    for tensors in (1, 2):
        plan = fused_bn.bn_plan(4096, 512, tensors)
        assert (plan.grid, plan.cluster, plan.rows_per_cta) == (160, 5, 820)
        assert plan.chunk_rows == plan.rows_per_cta
        assert _per_sm(plan) >= 2 and _per_sm(plan) * SMS >= plan.grid


def test_blocked_plan_walks_chunks_where_the_tile_cannot_hold_the_rows():
    """A CTA's rows whole where they fit in BN_TILE_BYTES; else chunks of
    as many rows as a full tile holds."""
    for (n, d), tensors in itertools.product(BLOCKED_SHAPES, (1, 2)):
        plan = fused_bn.bn_plan(n, d, tensors)
        row_bytes = plan.slab_cols * 4 * tensors + 1
        if plan.rows_per_cta * row_bytes <= fused_bn.BN_TILE_BYTES:
            assert plan.chunk_rows == plan.rows_per_cta, (n, d, tensors)
        else:
            assert plan.chunk_rows == fused_bn.BN_TILE_BYTES // row_bytes
            assert plan.chunk_rows < plan.rows_per_cta, (n, d, tensors)
    # [16384, 512]: 3,277 rows a CTA, F in 2 chunks of 3,150, G in 3 of 1,587
    f, g = (fused_bn.bn_plan(16384, 512, t) for t in (1, 2))
    assert (f.cluster, f.rows_per_cta) == (g.cluster, g.rows_per_cta) == (
        5, 3277)
    assert (f.chunk_rows, g.chunk_rows) == (3150, 1587)


@pytest.mark.parametrize("kind", ["offset", "ranks_masked", "all_masked",
                                  "one_row"])
def test_kernel_order_on_the_blocked_plan_matches_plain(kind):
    """F's and G's arithmetic on the plan of [40000, 40] (rows past a tile:
    three slabs of 16, the last ragged, clusters of 8 CTAs of 5,000 rows),
    in float32 against the plain versions in float64 within 1e-5: columns at
    an offset of 1e3 with std 0.1; the rows of the first three ranks masked;
    every row masked (mean and var exactly 0); one live row (var exactly
    0)."""
    rng = np.random.default_rng(17)
    n, d = 40000, 40
    plan = fused_bn.bn_plan(n, d)
    assert (plan.slab_cols, plan.cluster, plan.grid) == (16, 8, 24)
    assert plan.chunk_rows < plan.rows_per_cta == 5000
    offset, std = (1e3, 0.1) if kind == "offset" else (3.0, 2.0)
    x = torch.from_numpy((rng.normal(size=(n, d)) * std + offset)
                         .astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    scale = torch.from_numpy(rng.normal(size=d).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=d).astype(np.float32))
    mask = torch.from_numpy(rng.random(n) > 0.25)
    if kind == "ranks_masked":
        mask[:3 * plan.rows_per_cta] = False
    elif kind in ("all_masked", "one_row"):
        mask[:] = False
        if kind == "one_row":
            mask[21500] = True
    got = _emulate(x, mask, scale, bias, g, 1e-5, plan)
    y, mean, var = fused_bn.bn_forward_blocked_plain(
        x.double(), mask, scale.double(), bias.double(), 1e-5)
    want = [y, mean, var, *fused_bn.bn_backward_blocked_plain(
        x.double(), mask, scale.double(), got[1].double(), got[2].double(),
        1e-5, g.double())]
    for name, a, b in zip(("y", "mean", "var", "dx", "dscale", "dbias"),
                          got, want):
        assert torch.isfinite(a).all(), name
        scale_b = float(b.abs().max())
        if scale_b == 0.0:
            assert torch.equal(a, torch.zeros_like(a)), name
        else:
            assert float((a.double() - b).abs().max()) <= 1e-5 * scale_b, name
    if kind == "one_row":
        assert torch.equal(got[2], torch.zeros(d))
