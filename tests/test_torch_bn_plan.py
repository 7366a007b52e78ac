"""The launch plan of the masked batch-norm pair D and E
(``phc_gnn_torch.ops.fused_bn.bn_plan``), on the CPU.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).  Here the plan is held to what the kernels need of it:
every row and column owned by exactly one CTA, the tile within the card's
shared memory, clusters of at most 16 that divide the grid, and enough CTAs
to fill the card at the flagship's node shape.  ``_emulate`` follows the
kernels' order of operations on a plan (a shift per CTA, partials combined
in rank order with Chan's formula) in float32 and is held to the plain versions in float64.
"""

import numpy as np
import pytest
import torch

from phc_gnn_torch.ops import fused_bn
from torch_threads import one_torch_thread  # noqa: F401

SMEM_PER_BLOCK = 232_448      # H100: shared memory a block can use
GATE_SHAPES = [(4096, 200), (4096, 213), (109_375, 8), (129, 768), (129, 100),
               (1, 200), (1, 1)]


def _tiles(plan, n, d):
    """(rows, columns) of every CTA of the grid, as the kernels index them:
    block b is rank b % cluster of slab b // cluster."""
    for b in range(plan.grid):
        slab, rank = divmod(b, plan.cluster)
        r0 = min(n, rank * plan.rows_per_cta)
        r1 = min(n, r0 + plan.rows_per_cta)
        c0 = slab * plan.slab_cols
        yield range(r0, r1), range(c0, min(d, c0 + plan.slab_cols))


@pytest.mark.parametrize("n,d", GATE_SHAPES)
def test_plan_covers_every_row_and_column_once(n, d):
    for tensors in (1, 2):
        plan = fused_bn.bn_plan(n, d, tensors)
        owned = np.zeros((n, d), np.int64)
        for rows, cols in _tiles(plan, n, d):
            owned[rows.start:rows.stop, cols.start:cols.stop] += 1
        assert (owned == 1).all(), (n, d, tensors)
        assert 1 <= plan.cluster <= 16 and plan.grid % plan.cluster == 0
        assert plan.smem_bytes + fused_bn.BN_STATIC_SMEM <= SMEM_PER_BLOCK
        row_bytes = plan.slab_cols * 4 * tensors + 1  # and a mask byte
        assert 0 <= plan.smem_bytes - plan.chunk_rows * row_bytes < 16
        assert plan.smem_bytes % 16 == 0
        # the tile holds a CTA's rows whole unless they exceed the budget
        whole = plan.rows_per_cta * row_bytes
        assert (plan.chunk_rows == max(1, plan.rows_per_cta)) == (
            whole <= fused_bn.BN_TILE_BYTES)


def test_plan_fills_the_card():
    node = fused_bn.bn_plan(4096, 200, 2)
    assert node.grid >= 100 and node.rows_per_cta <= 512
    assert fused_bn.bn_plan(129, 768).grid >= 48
    # a head's 129 rows take clusters of 1: no cluster barrier
    assert all(fused_bn.bn_plan(129, d).cluster == 1
               for d in (64, 100, 128, 200, 256, 768))


def test_plan_fits_every_shape_the_gate_sends_here():
    """Every [n, d] with n * d * 4 at the gate (FUSED_BN_VMEM_LIMIT) and a
    sweep of widths gets a plan the C entry points take."""
    limit = fused_bn.FUSED_BN_VMEM_LIMIT
    for d in (1, 2, 3, 7, 8, 15, 16, 17, 64, 100, 200, 203, 213, 512, 768,
              2400, 875_000):
        n = limit // (4 * d)
        for tensors in (1, 2):
            p = fused_bn.bn_plan(n, d, tensors)
            assert p.rows_per_cta * p.cluster >= n
            assert p.smem_bytes <= fused_bn.BN_TILE_BYTES
            assert 1 <= p.cluster <= fused_bn.BN_MAX_CLUSTER
            assert p.grid == -(-d // p.slab_cols) * p.cluster


def _emulate(x, mask, scale, bias, g, eps, plan):
    """D and E in the kernels' order on ``plan``, in float32: per CTA a
    shift s (x at its first live row), the count c, S = sum m (x - s) and
    M2 = sum m ((x - s) - S / c)^2; the cluster's shift K is the first
    rank's with a live row, and the ranks meet in order (Chan's parallel
    variance); E's sums over all rows likewise."""
    n, d = x.shape
    m = mask.numpy()
    f32 = np.float32
    xs, gs = x.numpy(), g.numpy()
    ranks = [range(min(n, r * plan.rows_per_cta),
                   min(n, (r + 1) * plan.rows_per_cta))
             for r in range(plan.cluster)]
    pub = []  # (count, shift, local mean offset, M2) of each rank
    for rows in ranks:
        live = [r for r in rows if m[r]]
        shift = xs[live[0]] if live else np.zeros(d, f32)
        dev = xs[live] - shift
        local = dev.sum(0, dtype=f32) / max(f32(len(live)), f32(1))
        m2 = ((dev - local) ** 2).sum(0, dtype=f32)
        pub.append((f32(len(live)), shift, local, m2))
    k = next((sh for c, sh, _, _ in pub if c > 0), np.zeros(d, f32))
    e = [(sh - k) + local for _, sh, local, _ in pub]
    total, c = np.zeros(d, f32), f32(0)
    for (cr, _, _, _), er in zip(pub, e):
        total = total + cr * er
        c = c + cr
    cnt = max(c, f32(1))
    corr = total / cnt
    m2 = np.zeros(d, f32)
    for (cr, _, _, m2r), er in zip(pub, e):
        m2 = m2 + (m2r + cr * (er - corr) ** 2)
    var = m2 / cnt
    a = scale.numpy() / np.sqrt(var + f32(eps))
    y = ((xs - k) - corr) * a + bias.numpy()
    mean = k + corr
    xhat = (xs - mean) / np.sqrt(var + f32(eps))
    sg, sgx = np.zeros(d, f32), np.zeros(d, f32)
    for rows in ranks:
        sel = list(rows)
        sg = sg + gs[sel].sum(0, dtype=f32)
        sgx = sgx + (gs[sel] * xhat[sel]).sum(0, dtype=f32)
    dx = a * (gs - m[:, None] * (sg + xhat * sgx) / cnt)
    return [torch.from_numpy(np.asarray(v, f32))
            for v in (y, mean, var, dx, sgx, sg)]


@pytest.mark.parametrize("kind", ["random", "all_masked", "ctas_masked"])
def test_kernel_order_on_the_plan_matches_plain(kind):
    """The kernels' arithmetic on the plan of [4096, 24] (a cluster of 8 CTAs
    of 512 rows), columns at an offset of 1e3 with std 0.1: within 1e-5 of
    the plain versions in float64 (mean and var exactly 0 when every row is
    masked; the ranks without a live row add nothing)."""
    rng = np.random.default_rng(7)
    n, d = 4096, 24
    plan = fused_bn.bn_plan(n, d)
    assert plan.cluster == 8
    x = torch.from_numpy((rng.normal(size=(n, d)) * 0.1 + 1e3).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    scale = torch.from_numpy(rng.normal(size=d).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=d).astype(np.float32))
    mask = torch.from_numpy(rng.random(n) > 0.25)
    if kind == "all_masked":
        mask[:] = False
    elif kind == "ctas_masked":
        mask[:3 * plan.rows_per_cta] = False
    got = _emulate(x, mask, scale, bias, g, 1e-5, plan)
    y, mean, var = fused_bn.bn_forward_plain(x.double(), mask, scale.double(),
                                             bias.double(), 1e-5)
    want = [y, mean, var, *fused_bn.bn_backward_plain(
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
