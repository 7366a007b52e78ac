"""The launch plan of the whitening reductions J and L
(``phc_gnn_torch.ops.fused_whitening.wbn_plan``), on the CPU.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).  Here the plan is held to what the kernels need of it:
every feature and row owned by exactly one CTA, clusters of at most 16
that divide the grid, no more clusters than an H100 holds at once, shared
memory under the 48 KB a CTA gets without an opt-in, and enough CTAs to
fill the card at the quaternion path's node shape.  ``_stats`` and
``_sums`` follow the kernels' order of operations on a plan in float32 --
each thread's partials over its rows (J's Welford about its shift, x at its
first live row), then the lanes of a feature, the warps and the ranks (J:
Chan's formula with the other partial's mean taken about the first's shift,
in the kernel's shuffle trees; L: its 20 sums in the kernel's order, then
the algebra once a feature) -- and are held to the plain versions in
float64.  Needs no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_wbn_plan.py
"""

import numpy as np
import pytest
import torch

from phc_gnn_torch.ops import fused_whitening as fw

SUMS = (fw.WBN_STATS_SUMS, fw.WBN_SUMS)
# [n, d] with x [n, 4d]: the quaternion add and concat presets' whitening
# inputs ([4096, 200] at the flagship bucket: every site is 50 features
# wide), a ragged N, d = 49, a head-sized N, one row, and d = 64, the
# first width whose 8 slabs an H100 cannot hold in clusters of 16
SHAPES = [(4096, 50), (1100, 50), (1100, 49), (129, 49), (1, 50), (4096, 64)]


def _ctas(plan, n, d):
    """(rows, features) of every CTA of the grid, as the kernels index them:
    block b is rank b % cluster of slab b // cluster."""
    for b in range(plan.grid):
        slab, rank = divmod(b, plan.cluster)
        r0 = min(n, rank * plan.rows_per_cta)
        r1 = min(n, r0 + plan.rows_per_cta)
        f0 = slab * plan.slab
        yield range(r0, r1), range(f0, min(d, f0 + plan.slab))


@pytest.mark.parametrize("n,d", SHAPES)
def test_plan_covers_every_feature_and_row_once(n, d):
    for sums in SUMS:
        plan = fw.wbn_plan(n, d, sums)
        owned = np.zeros((n, d), np.int64)
        for rows, feats in _ctas(plan, n, d):
            owned[rows.start:rows.stop, feats.start:feats.stop] += 1
        assert (owned == 1).all(), (n, d, sums)
        assert 1 <= plan.cluster <= fw.WBN_MAX_CLUSTER
        assert plan.grid % plan.cluster == 0
        assert plan.grid == -(-d // plan.slab) * plan.cluster
        assert plan.smem_bytes == fw.wbn_smem_bytes(plan.slab, plan.cluster,
                                                    sums)
        assert plan.smem_bytes <= fw.WBN_MAX_SMEM


def test_plan_fills_the_card_and_fits_every_shape():
    """At [4096, 200] 7 slabs of 8 features in clusters of 16, 256 rows a
    CTA (112 CTAs, one an SM); at [4096, 256] 8 slabs, more clusters of 16
    than an H100 holds at once, so clusters of 8; a cluster has no more
    CTAs than 256-row blocks of n, so 129 rows and one row take clusters of
    1; every plan's clusters fit the card at once where the slabs are no
    more than its SMs, and the largest cluster fits the shared memory of a
    CTA."""
    for sums in SUMS:
        plan = fw.wbn_plan(4096, 50, sums)
        assert (plan.slab, plan.cluster, plan.rows_per_cta, plan.grid) == (
            8, 16, 256, 112)
        assert (fw.wbn_plan(4096, 64, sums).cluster,
                fw.wbn_plan(4096, 64, sums).grid) == (8, 64)
        assert fw.wbn_plan(129, 49, sums).cluster == 1
        assert fw.wbn_plan(1, 50, sums).cluster == 1
        assert fw.wbn_plan(0, 50, sums).rows_per_cta == 0
        assert fw.wbn_smem_bytes(8, fw.WBN_MAX_CLUSTER, sums) <= fw.WBN_MAX_SMEM
        for n in (1, 129, 1100, 4096, 16384, 10 ** 6):
            for d in (1, 49, 50, 56, 57, 64, 100, 128, 240, 241, 528, 1056):
                p = fw.wbn_plan(n, d, sums)
                assert p.rows_per_cta * p.cluster >= n
                held = fw.WBN_CLUSTERS_HELD[p.cluster]
                assert p.grid // p.cluster <= held, (n, d, p)
                assert p.cluster <= max(1, -(-n // fw.WBN_MIN_ROWS))


def _ranks(plan, n):
    return [range(min(n, r * plan.rows_per_cta),
                  min(n, (r + 1) * plan.rows_per_cta))
            for r in range(plan.cluster)]


def _comps(a):
    d = a.shape[-1] // 4
    return [a[..., k * d:(k + 1) * d] for k in range(4)]


# co-moment (j, k), j <= k, in the kernels' cov order
COV = [(j, k) for j in range(4) for k in range(j, 4)]
GROUPS = 32 * fw.WBN_WARPS // fw.WBN_SLAB  # a CTA's threads a feature
SLOTS = 32 // fw.WBN_SLAB                  # a warp's threads a feature


def _threads(x, ranks):
    """The rows of every thread of a feature, as the kernels walk them: in
    the CTA of rank r the thread of row group rg takes r0 + rg, + GROUPS,
    ...  Returns x's rows ``[R, GROUPS, U, 4d]`` (0 past the CTA's rows),
    which rows exist ``[R, GROUPS, U]`` and their indices."""
    steps = max(1, max(-(-len(rows) // GROUPS) for rows in ranks))
    rg = torch.arange(GROUPS)[:, None] + GROUPS * torch.arange(steps)
    idx = torch.stack([rows.start + rg for rows in ranks])
    ok = torch.stack([rows.start + rg < rows.stop for rows in ranks])
    idx = torch.where(ok, idx, 0)
    return torch.where(ok[..., None], x[idx], 0.0), ok, idx


def _merge(a, b):
    """Chan's merge of partials b into a, elementwise over the leading
    axes, as ``chan_merge`` takes it: b's mean about a's shift, delta =
    ((s_b - s_a) + m_b) - m_a; a partial with no live row is a no-op, and
    one merged into an empty partial is copied.  A partial is (count
    [..., 1, 1], shift [..., 4, d], mean of x - shift [..., 4, d],
    co-moments [..., 10, d])."""
    ca, sa, ma, qa = a
    cb, sb, mb, qb = b
    cn = ca + cb
    ratio = cb / cn
    cross = ca * ratio
    delta = ((sb - sa) + mb) - ma
    q = torch.stack([qa[..., i, :] + (qb[..., i, :] + delta[..., j, :]
                                      * delta[..., k, :] * cross[..., 0, :])
                     for i, (j, k) in enumerate(COV)], -2)
    merged = (cn, sa, ma + delta * ratio, q)
    return tuple(torch.where(cb == 0, ta, torch.where(ca == 0, tb, tm))
                 for ta, tb, tm in zip(a, b, merged))


def _tree(parts, axis):
    """The kernels' shuffle tree over ``axis`` of the partials (a power of
    two long): at each offset, from half the width down to 1, position q
    takes q + offset."""
    width = parts[0].shape[axis]
    while width > 1:
        width //= 2
        lo = tuple(t.narrow(axis, 0, width) for t in parts)
        hi = tuple(t.narrow(axis, width, width) for t in parts)
        parts = _merge(lo, hi)
    return tuple(t.squeeze(axis) for t in parts)


def _stats(x, mask, eps, plan, ranks=None):
    """J in the kernel's order on ``plan`` in float32 (IEEE divisions where
    the kernel takes ``__fdividef``, and no fused multiply-adds): each
    thread's Welford over its rows about its shift (x at its first live
    row); the lanes of a feature in a warp in the tree of offsets 16, 8;
    the warps in the tree of 4, 2, 1; the ranks, padded with empty
    partials to 8 or 16, in the same tree; mean = s + m, cov = M2 * (1 /
    max(c, 1)) and the Cholesky.  ``ranks`` overrides the ranks' rows."""
    n, d4 = x.shape
    d = d4 // 4
    ranks = ranks or _ranks(plan, n)
    xv, ok, idx = _threads(x, ranks)
    live = ok & mask[idx]
    lead = live.shape[:2]
    c = torch.zeros(*lead, 1, 1)
    s, m = torch.zeros(*lead, 4, d), torch.zeros(*lead, 4, d)
    q = torch.zeros(*lead, 10, d)
    for u in range(live.shape[2]):
        on = live[:, :, u, None, None]
        v = xv[:, :, u].reshape(*lead, 4, d)
        s = torch.where(on & (c == 0), v, s)
        c = torch.where(on, c + 1, c)
        xs = v - s
        e = xs - m
        m_new = m + e * (1.0 / c)
        q_new = torch.stack([q[:, :, i] + e[:, :, j] * (xs[:, :, k]
                                                        - m_new[:, :, k])
                             for i, (j, k) in enumerate(COV)], 2)
        m, q = torch.where(on, m_new, m), torch.where(on, q_new, q)
    # [R, warps, slots]: slot i of warp w is row group SLOTS * w + i
    parts = tuple(t.reshape(len(ranks), fw.WBN_WARPS, SLOTS, *t.shape[2:])
                  for t in (c, s, m, q))
    parts = _tree(_tree(parts, 2), 1)
    lanes = 16 if len(ranks) > 8 else 8
    parts = tuple(torch.cat([t, torch.zeros(lanes - len(ranks), *t.shape[1:])])
                  for t in parts)
    c, s, m, q = _tree(parts, 0)
    inv = 1.0 / torch.clamp(c, min=1.0)
    cov = {jk: q[i] * inv[0] for i, jk in enumerate(COV)}
    l = fw._chol_fields(cov, eps)
    return (s + m, fw._stack_cov(cov), fw._stack_l(l),
            torch.clamp(c, min=1.0).reshape(1))


def _sums(x, g, gamma, mean, l, plan):
    """L in the kernel's order on ``plan`` in float32 (no fused
    multiply-adds): each thread's 20 sums over its rows that are linear in
    them, sum g and G = sum g u^T (u = x - mean); the lanes of a feature in
    a warp in the tree of offsets 16, 8; the warps in order; the ranks in
    order; then dGamma = G L^{-T}, W = sum w z^T = L^{-T} Gamma^T dGamma,
    sum w = L^{-T} Gamma^T sum g and M from Lbar = -tril(W)."""
    n, d4 = x.shape
    d = d4 // 4
    ranks = _ranks(plan, n)
    xv, ok, _ = _threads(x, ranks)
    gv, _, _ = _threads(g, ranks)
    lead = ok.shape[:2]
    acc = torch.zeros(*lead, 20, d)
    for u in range(ok.shape[2]):
        gu = gv[:, :, u].reshape(*lead, 4, d)
        xu = (xv[:, :, u] - mean.reshape(-1)).reshape(*lead, 4, d)
        row = torch.cat([gu, (gu[:, :, :, None] * xu[:, :, None]).reshape(
            *lead, 16, d)], 2)
        acc = torch.where(ok[:, :, u, None, None], acc + row, acc)
    acc = acc.reshape(len(ranks), fw.WBN_WARPS, SLOTS, 20, d)
    warp = (acc[:, :, 0] + acc[:, :, 2]) + (acc[:, :, 1] + acc[:, :, 3])
    rank = warp[:, 0]
    for w in range(1, fw.WBN_WARPS):
        rank = rank + warp[:, w]
    tot = torch.zeros(20, d)
    for r in range(len(ranks)):
        tot = tot + rank[r]
    sg = list(tot[:4])
    G = [list(tot[4 + c * 4:8 + c * 4]) for c in range(4)]
    lf = fw._fields(l)
    il = fw._inv_diag(lf)
    dgamma = [fw._fwd_subst(lf, G[c], il) for c in range(4)]
    cols = [fw._bwd_subst(lf, [sum(gamma[c, k] * dgamma[c][m] for c in range(4))
                               for k in range(4)], il) for m in range(4)]
    lbar = {(a, b): -cols[b][a] for a, b in fw.L_IDX}
    m_rows = fw._m_from_lbar(lf, lbar)
    mmat = torch.stack([m_rows[a][b] for a in range(4) for b in range(4)])
    sw = fw._bwd_subst(lf, [sum(gamma[c, k] * sg[c] for c in range(4))
                            for k in range(4)], il)
    return (torch.stack([torch.stack(r) for r in dgamma]), torch.stack(sg),
            mmat, torch.stack(sw))


def _leaf(got, want, name):
    got, want = got.double(), want.double()
    assert torch.isfinite(got).all(), name
    scale = float(want.abs().max())
    if scale == 0.0:
        assert float(got.abs().max()) == 0.0, name
    else:
        assert float((got - want).abs().max()) <= 1e-5 * scale, name


@pytest.mark.parametrize("kind", ["random", "all_masked", "one_row",
                                  "ctas_masked", "offset"])
def test_kernel_order_on_the_plan_matches_plain(kind):
    """J and L (both variants) in the kernels' order on the plan of
    [4096, 48] (a cluster of 16 CTAs of 256 rows) against the plain versions
    in float64, within 1e-5 of each output's max: a random mask, every row
    masked, one live row (whose value is the mean exactly), the rows of the
    first three CTAs masked (those ranks merge as ranks with no rows)
    and columns at an offset of 1e3 with std 0.1."""
    rng = np.random.default_rng(8)
    n, d = 4096, 12
    plan = fw.wbn_plan(n, d, fw.WBN_STATS_SUMS)
    assert plan.cluster == 16 and plan.rows_per_cta == 256
    x = rng.normal(size=(n, 4 * d)) * 1.5 + 0.5
    if kind == "offset":
        x = 1e3 + rng.normal(size=(n, 4 * d)) * 0.1
    x = torch.from_numpy(x.astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(n, 4 * d)).astype(np.float32))
    gamma = torch.from_numpy((rng.normal(size=(4, 4, d)) * 0.2 + 0.5 * np.eye(
        4)[..., None]).astype(np.float32))
    mask = torch.from_numpy(rng.random(n) > 0.2)
    if kind in ("all_masked", "one_row"):
        mask[:] = False
        if kind == "one_row":
            mask[1500] = True
    elif kind == "ctas_masked":
        mask[:3 * plan.rows_per_cta] = False
    got = _stats(x, mask, 1e-5, plan)
    want = fw.wbn_stats_plain(x.double(), mask, 1e-5)
    for name, a, b in zip(("mean", "cov", "L", "cnt"), got, want):
        _leaf(a, b, name)
    if kind == "one_row":
        assert torch.equal(got[0], torch.stack(_comps(x[1500])))
    if kind == "ctas_masked":  # masked ranks merge as ranks with no rows
        alone = _stats(x, mask, 1e-5, plan, ranks=[range(0, 0)] * 3
                       + _ranks(plan, n)[3:])
        assert all(torch.equal(a, b) for a, b in zip(got, alone))
    mean, l = got[0], got[2]
    sums = _sums(x, g, gamma, mean, l, plan)
    want = fw.wbn_bwd_sums_plain(x.double(), g.double(), gamma.double(),
                                 mean.double(), l.double())
    for name, a, b in zip(("dgamma", "dbeta", "M", "sum w"), sums, want):
        _leaf(a, b, name)
    frozen = fw.wbn_bwd_sums_plain(x.double(), g.double(), gamma.double(),
                                   mean.double(), l.double(), frozen=True)
    for name, a, b in zip(("frozen dgamma", "frozen dbeta"), sums, frozen):
        _leaf(a, b, name)
