"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without a CUDA device (decided inside the
fixture, never at import).  Needs no JAX, so it runs on a machine with a
GPU and without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from phc_gnn_torch.data import synthetic_batch
from phc_gnn_torch.graph import (attach_csr_plan, build_csr_rowptr,
                                 build_sender_csr)
from phc_gnn_torch.nn.norm import QuaternionWhiteningNorm
from phc_gnn_torch.ops import fused_bn, fused_whitening as fw
from phc_gnn_torch.ops import segment_reduce as sr
from phc_gnn_torch.ops import segment_softmax as ss
from phc_gnn_torch.ops import segment_sum as ssum

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc for sm_90a)")
    return torch.device("cuda", 0)


def _rel_err(got, want):
    """Normwise relative error over the entries where ``want`` is not the max
    identity -2^100 (empty and all-masked segments); those must hold the
    identity exactly in ``got``, or the error is inf."""
    got, want = got.double().cpu(), want.double().cpu()
    empty = want == ss.NEG
    if not bool((got[empty] == ss.NEG).all()):
        return float("inf")
    got, want = got[~empty], want[~empty]
    err = float((got - want).abs().max())
    return err / max(1.0, float(want.abs().max()))


def _flagship_case(dev, beta):
    b = attach_csr_plan(synthetic_batch(128, 4096, 8192, seed=0)).to(dev)
    gen = torch.Generator().manual_seed(0)
    msgs = torch.randn((b.num_edges, 200), generator=gen).to(dev)
    return msgs, b.edge_mask, torch.tensor(beta, device=dev), b.rowptr


def _adversarial_case(dev):
    rng = np.random.default_rng(3)
    counts = rng.integers(1, 6, size=48)
    counts[3], counts[7] = 0, 1100
    recv = np.repeat(np.arange(48), counts)
    mask = rng.random(recv.shape[0]) > 0.25
    lo = counts[:11].sum()
    mask[lo:lo + counts[11]] = False
    recv = np.concatenate([recv, np.full(40, 47)]).astype(np.int32)
    mask = np.concatenate([mask, np.zeros(40, bool)])
    msgs = rng.uniform(-32, 32, size=(recv.shape[0], 200)).astype(np.float32)
    rowptr = build_csr_rowptr(recv, 48, mask)
    return (torch.from_numpy(msgs).to(dev), torch.from_numpy(mask).to(dev),
            torch.tensor(-2.75, device=dev), torch.from_numpy(rowptr).to(dev))


@pytest.mark.parametrize("case", ["flagship", "adversarial"])
def test_kernels_match_plain_versions(dev, case):
    m, k, b, rp = (_flagship_case(dev, 1.37) if case == "flagship"
                   else _adversarial_case(dev))
    n0, a0 = ss.segment_logit_max.launches, ss.segment_softmax_aggregate.launches
    smax = ss.segment_logit_max(m, k, b, rp)
    out, w, den = ss.segment_softmax_aggregate(m, k, b, rp, smax, emit_w=True)
    torch.cuda.synchronize()
    assert ss.segment_logit_max.launches == n0 + 1
    assert ss.segment_softmax_aggregate.launches == a0 + 1
    smax_ref = ss.segment_logit_max_plain(m, k, b, rp)
    out_ref, w_ref, den_ref = ss.segment_softmax_aggregate_plain(
        m, k, b, rp, smax_ref, emit_w=True)
    assert _rel_err(smax, smax_ref) <= 1e-6
    assert _rel_err(out, out_ref) <= 1e-5
    assert _rel_err(w, w_ref) <= 1e-5
    assert _leaf_err(den, den_ref) <= 1e-5
    assert torch.isfinite(out).all()


def _leaf_err(got, want):
    """max |got - want| over max |want|."""
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max()) / float(want.abs().max())


@pytest.mark.parametrize("case", ["flagship", "adversarial"])
def test_segment_sum_kernel_matches_plain_version(dev, case):
    """Kernel C over the sender CSR, with g non-zero on masked edges; the
    adversarial senders hold an isolated node and one of 1,100 edges.
    ``test_segment_sum_tolerance_separates_a_dropped_edge`` shows the limit
    catches one edge too few."""
    if case == "flagship":
        b = attach_csr_plan(synthetic_batch(128, 4096, 8192, seed=0)).to(dev)
        perm, rowptr, e = b.snd_perm, b.snd_rowptr, b.num_edges
    else:
        rng = np.random.default_rng(4)
        counts = rng.integers(1, 6, size=48)
        counts[3], counts[7] = 0, 1100
        senders = rng.permutation(np.repeat(np.arange(48), counts))
        mask = rng.random(senders.shape[0]) > 0.2
        perm, rowptr = (torch.from_numpy(a).to(dev)
                        for a in build_sender_csr(senders, 48, mask))
        e = senders.shape[0]
    g = torch.randn((e, 200), generator=torch.Generator().manual_seed(1)).to(dev)
    n0 = ssum.segment_sum_perm.launches
    out = ssum.segment_sum_perm(g, perm, rowptr)
    again = ssum.segment_sum_perm(g, perm, rowptr)
    torch.cuda.synchronize()
    assert ssum.segment_sum_perm.launches == n0 + 2
    assert torch.equal(out, again)
    # against a float64 sum, so that the reference's order does not matter;
    # the kernel's f32 running sum of 1,100 rows drifts ~1e-6 of the max
    want = ssum.segment_sum_perm_plain(g.double(), perm, rowptr)
    assert _leaf_err(out, want) <= 1e-5
    if case == "adversarial":
        assert torch.all(out[3] == 0)


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_halo_role_matches_plain_version(dev, shards, dtype):
    """Kernel C's halo role on shard 0 of the flagship batch cut in
    ``shards``: the cotangent rows summed per augmented row (the shard's
    own, then its halo rows), split at NS; bit-equal on relaunch, within
    1e-5 of each leaf's max of a float64 sum (bf16 rows: of the plain
    version on the same rows), and the counter moves on its own wrapper."""
    from phc_gnn_torch.parallel import partition_nodes

    sh = partition_nodes(synthetic_batch(128, 4096, 8192, seed=0),
                         shards)[0].to(dev)
    g = torch.randn((sh.num_edges, 200),
                    generator=torch.Generator().manual_seed(2)).to(dev, dtype)
    n0 = (ssum.halo_gather_split_bwd.launches,
          ssum.halo_gather_split_bwd.launches_bf16,
          ssum.segment_sum_perm.launches)
    dx, dxr = ssum.halo_gather_split_bwd(g, sh.snd_perm, sh.snd_rowptr,
                                         sh.num_nodes)
    again = torch.cat(ssum.halo_gather_split_bwd(g, sh.snd_perm,
                                                 sh.snd_rowptr, sh.num_nodes))
    torch.cuda.synchronize()
    bf16 = dtype == torch.bfloat16
    assert (ssum.halo_gather_split_bwd.launches,
            ssum.halo_gather_split_bwd.launches_bf16,
            ssum.segment_sum_perm.launches) == (n0[0] + 2 * (not bf16),
                                                n0[1] + 2 * bf16, n0[2])
    out = torch.cat([dx, dxr])
    assert dx.shape[0] == sh.num_nodes and torch.equal(out, again)
    want = torch.cat(ssum.halo_gather_split_bwd_plain(
        g if bf16 else g.double(), sh.snd_perm, sh.snd_rowptr, sh.num_nodes))
    assert _leaf_err(out, want) <= 1e-5


@pytest.mark.parametrize("shape", [(4096, 200), (129, 100), (129, 768),
                                   (109_375, 8), (4096, 213), (4096, 203),
                                   (1, 200)])
@pytest.mark.parametrize("mask_kind", ["random", "all_masked", "one_row",
                                       "offset", "ctas_masked"])
def test_fused_bn_kernels_match_plain_versions(dev, shape, mask_kind):
    """D and E against their plain versions in float64 (E fed D's own mean
    and var): the node and head shapes, the size gate's edges ([109375, 8]
    walks its rows in chunks), ragged widths, one row; columns at an offset
    of 1e3 with std 0.1, and the rows of the first three CTAs of each
    cluster masked.  A second launch is bit-equal."""
    gen = torch.Generator().manual_seed(2)
    n, d = shape
    offset, std = (1e3, 0.1) if mask_kind == "offset" else (3.0, 2.0)
    x = (torch.randn(shape, generator=gen) * std + offset).to(dev)
    g = torch.randn(shape, generator=gen).to(dev)
    scale = torch.randn(d, generator=gen).to(dev)
    bias = torch.randn(d, generator=gen).to(dev)
    mask = torch.rand(n, generator=gen) > 0.3
    if mask_kind in ("all_masked", "one_row"):
        mask[:] = False
        if mask_kind == "one_row":
            mask[n // 2] = True
    elif mask_kind == "ctas_masked":
        mask[:3 * fused_bn.bn_plan(n, d).rows_per_cta] = False
    mask = mask.to(dev)
    f0, b0 = fused_bn.bn_forward.launches, fused_bn.bn_backward.launches
    y, mean, var = fused_bn.bn_forward(x, mask, scale, bias, 1e-5)
    dx, ds, db = fused_bn.bn_backward(x, mask, scale, mean, var, 1e-5, g)
    again = (fused_bn.bn_forward(x, mask, scale, bias, 1e-5)
             + fused_bn.bn_backward(x, mask, scale, mean, var, 1e-5, g))
    torch.cuda.synchronize()
    assert (fused_bn.bn_forward.launches, fused_bn.bn_backward.launches) == (
        f0 + 2, b0 + 2)
    got = (y, mean, var, dx, ds, db)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    ref = fused_bn.bn_forward_plain(x.double(), mask, scale.double(),
                                    bias.double(), 1e-5)
    ref_b = fused_bn.bn_backward_plain(x.double(), mask, scale.double(),
                                       mean.double(), var.double(), 1e-5,
                                       g.double())
    for got_t, want in zip(got, ref + ref_b):
        assert torch.isfinite(got_t).all()
        if float(want.abs().max()) == 0.0:
            assert torch.equal(got_t, want.float())
        else:
            assert _leaf_err(got_t, want) <= 1e-5


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    m, k, b, rp = _flagship_case(dev, 1.0)
    with pytest.raises(TypeError, match="float32"):
        ss.segment_logit_max(m.half(), k, b, rp)
    with pytest.raises(TypeError, match="int32"):
        ss.segment_logit_max(m, k, b, rp.long())
    with pytest.raises(ValueError, match="contiguous"):
        ss.segment_logit_max(m.t().contiguous().t(), k, b, rp)
    with pytest.raises(ValueError, match="msgs on"):
        ss.segment_logit_max(m, k, b.cpu(), rp)


def _pcba_batch(dev):
    return attach_csr_plan(synthetic_batch(
        128, 4096, 8192, seed=0, target_dim=128, num_node_feats=9,
        num_edge_feats=3)).to(dev)


def _blocked_case(dev, shape, mask_kind):
    """(x, g, scale, bias, mask) for F and G; see
    test_blocked_bn_kernels_match_plain_versions."""
    gen = torch.Generator().manual_seed(5)
    n, d = shape
    offset, std = (1e3, 0.1) if mask_kind == "offset" else (3.0, 2.0)
    x = (torch.randn(shape, generator=gen) * std + offset).to(dev)
    g = torch.randn(shape, generator=gen).to(dev)
    scale = torch.randn(d, generator=gen).to(dev)
    bias = torch.randn(d, generator=gen).to(dev)
    if mask_kind in ("pcba", "offset"):
        return x, g, scale, bias, _pcba_batch(dev).node_mask
    mask = torch.rand(n, generator=gen) > 0.25
    if mask_kind == "masked_block":
        mask[128:640] = False
    elif mask_kind in ("all_masked", "one_row"):
        mask[:] = False
        if mask_kind == "one_row":
            mask[n // 2] = True
    return x, g, scale, bias, mask.to(dev)


@pytest.mark.parametrize("shape,mask_kind", [
    ((4096, 512), "pcba"), ((1100, 24), "random"), ((1100, 24), "masked_block"),
    ((4096, 512), "all_masked"), ((129, 768), "one_row"),
    ((32768, 512), "chunked"), ((4096, 512), "offset"),
    ((40000, 41), "random"), ((20000, 212), "random")])
def test_blocked_bn_kernels_match_plain_versions(dev, shape, mask_kind):
    """F and G, each with its elementwise pass fused in, against their plain
    versions in float64 (G fed F's own mean and var): the pcba batch's node
    mask at [4096, 512], a ragged [1100, 24] with a random mask and with
    rows 128-639 masked, an all-masked and a one-row mask, [32768, 512]
    (rows past a CTA's tile, walked in chunks; x and g 67 MB each, past the
    50 MB L2), columns at an offset of 1e3 with std 0.1, and two ragged
    widths in chunks: [40000, 41] (4-byte copies, 9 columns in the last
    slab) and [20000, 212] (4 in the last slab; the backward chunked, the
    forward whole).  One launch each way; a second is bit-equal."""
    x, g, scale, bias, mask = _blocked_case(dev, shape, mask_kind)
    f0 = fused_bn.bn_forward_blocked.launches
    b0 = fused_bn.bn_backward_blocked.launches
    y, mean, var = fused_bn.bn_forward_blocked(x, mask, scale, bias, 1e-5)
    dx, ds, db = fused_bn.bn_backward_blocked(x, mask, scale, mean, var, 1e-5,
                                              g)
    torch.cuda.synchronize()
    assert (fused_bn.bn_forward_blocked.launches,
            fused_bn.bn_backward_blocked.launches) == (f0 + 1, b0 + 1)
    again = (fused_bn.bn_forward_blocked(x, mask, scale, bias, 1e-5)
             + fused_bn.bn_backward_blocked(x, mask, scale, mean, var, 1e-5,
                                            g))
    got = (y, mean, var, dx, ds, db)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    ref = fused_bn.bn_forward_blocked_plain(x.double(), mask, scale.double(),
                                            bias.double(), 1e-5)
    ref_b = fused_bn.bn_backward_blocked_plain(
        x.double(), mask, scale.double(), mean.double(), var.double(), 1e-5,
        g.double())
    for got_t, want in zip(got, ref + ref_b):
        assert torch.isfinite(got_t).all()
        if float(want.abs().max()) == 0.0:
            assert torch.equal(got_t, want.float())
        else:
            assert _leaf_err(got_t, want) <= 1e-5


def test_blocked_plan_runs_in_one_wave_on_the_card(dev):
    """At pcba's [4096, 512] the card holds every cluster of F's and G's
    plan at once."""
    for tensors in (1, 2):
        plan = fused_bn.bn_plan(4096, 512, tensors)
        assert (fused_bn._max_active_clusters(plan, tensors)
                >= plan.grid // plan.cluster)


def test_fused_masked_bn_blocked_autograd_on_the_card(dev):
    """``fused_masked_bn_blocked`` forward and backward on CUDA tensors at
    pcba's [4096, 512] go through F and G once each and agree with the same
    function on the CPU in float64."""
    x, g, scale, bias, mask = _blocked_case(dev, (4096, 512), "pcba")
    outs = []
    for device, dtype in ((dev, torch.float32), ("cpu", torch.float64)):
        tx, ts, tb = (t.detach().to(device, dtype).requires_grad_()
                      for t in (x, scale, bias))
        counts = (fused_bn.bn_forward_blocked.launches,
                  fused_bn.bn_backward_blocked.launches)
        y, mean, var = fused_bn.fused_masked_bn_blocked(tx, mask.to(device),
                                                        ts, tb)
        (y * g.to(device, dtype)).sum().backward()
        if device == dev:
            torch.cuda.synchronize()
            assert (fused_bn.bn_forward_blocked.launches,
                    fused_bn.bn_backward_blocked.launches) == (
                counts[0] + 1, counts[1] + 1)
        outs.append([t.detach().cpu() for t in (y, mean, var, tx.grad,
                                                ts.grad, tb.grad)])
    for a, b in zip(*outs):
        assert _leaf_err(a, b) <= 1e-5


@pytest.mark.parametrize("case", ["pcba", "adversarial"])
def test_segment_sum_masked_kernel_matches_plain_version(dev, case):
    """C's forward role over the receiver CSR at width 512, against a float64
    sum: the pcba batch, and receivers with an isolated node (3), a segment
    of 1,100 edges (7), masked edges inside segments and an all-masked one
    (11)."""
    if case == "pcba":
        b = _pcba_batch(dev)
        mask, rowptr = b.edge_mask, b.rowptr
        msgs = torch.randn((b.num_edges, 512),
                           generator=torch.Generator().manual_seed(6)).to(dev)
    else:
        msgs, mask, _, rowptr = _adversarial_case(dev)
        msgs = torch.cat([msgs, msgs, msgs[:, :112]], 1).contiguous()
    n0 = ssum.segment_sum_masked.launches
    out = ssum.segment_sum_masked(msgs, mask, rowptr)
    again = ssum.segment_sum_masked(msgs, mask, rowptr)
    torch.cuda.synchronize()
    assert ssum.segment_sum_masked.launches == n0 + 2
    assert torch.equal(out, again)
    want = ssum.segment_sum_masked_plain(msgs.double(), mask, rowptr)
    assert _leaf_err(out, want) <= 1e-5
    if case == "adversarial":
        assert torch.all(out[3] == 0) and torch.all(out[11] == 0)


def _unaligned(t):
    """A contiguous copy of ``t`` whose base lies 4 bytes past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16 == 4
    return view


@pytest.mark.parametrize("role", ["masked", "perm"])
@pytest.mark.parametrize("width", [512, 200, 37, "unaligned", 768])
def test_segment_sum_instances_are_sequential_sums(dev, role, width):
    """Each instance of C (float4 lanes at 512, 200 and 768, two column
    blocks there; one float a lane at d = 37 and on rows 4 bytes past a
    16-byte boundary) over the adversarial nodes (an isolated node 3, a
    node of 1,100 edges past a run's staged entries, masked edges inside
    segments, an all-masked node 11) is bit-equal to the plain version run
    in float32 on the CPU, a sequential sum in edge order, and to a second
    launch; the isolated and all-masked nodes give exact 0."""
    msgs, mask, _, rowptr = _adversarial_case(dev)
    d = 200 if width == "unaligned" else width
    gen = torch.Generator().manual_seed(d)
    values = (torch.rand((msgs.shape[0], d), generator=gen) * 64 - 32).to(dev)
    if role == "perm":
        rng = np.random.default_rng(d)
        senders = rng.permutation(np.repeat(np.arange(48),
                                            np.diff(rowptr.cpu().numpy())))
        e_mask = rng.random(senders.shape[0]) > 0.2
        index, rowptr = (torch.from_numpy(a).to(dev)
                         for a in build_sender_csr(senders, 48, e_mask))
        values = values[:senders.shape[0]].contiguous()
        fn, plain = ssum.segment_sum_perm, ssum.segment_sum_perm_plain
    else:
        index = mask
        fn, plain = ssum.segment_sum_masked, ssum.segment_sum_masked_plain
    if width == "unaligned":
        values = _unaligned(values)
    plan = ssum.segment_sum_plan(rowptr.shape[0] - 1, values.shape[0], d,
                                 role == "perm", values.data_ptr() % 16 == 0)
    assert plan.vec == (4 if isinstance(width, int) and width % 4 == 0 else 1)
    assert plan.stage < int(rowptr[-1])
    n0 = fn.launches
    out, again = fn(values, index, rowptr), fn(values, index, rowptr)
    torch.cuda.synchronize()
    assert fn.launches == n0 + 2
    assert torch.equal(out, again)
    assert torch.equal(out.cpu(), plain(values.cpu(), index.cpu(),
                                        rowptr.cpu()))
    assert torch.all(out[3] == 0)
    if role == "masked":
        assert torch.all(out[11] == 0)


def _whitening_case(dev, n, d, mask_kind, seed=8):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((n, 4 * d), generator=gen) * 1.5 + 0.5
    mask = torch.rand(n, generator=gen) > 0.2
    if mask_kind == "flagship":
        mask = attach_csr_plan(synthetic_batch(128, 4096, 8192, seed=0)
                               ).node_mask
    elif mask_kind == "ctas_masked":
        mask[:3 * fw.wbn_plan(n, d, fw.WBN_STATS_SUMS).rows_per_cta] = False
    elif mask_kind != "random":
        mask[:] = False
        if mask_kind == "one_row":
            mask[n // 2] = True
    gamma = torch.randn((4, 4, d), generator=gen) * 0.2 + 0.5 * torch.eye(4)[
        ..., None]
    beta = torch.randn((4, d), generator=gen) * 0.3
    g = torch.randn((n, 4 * d), generator=gen)
    return [t.to(dev).contiguous() for t in (x, mask, gamma, beta, g)]


@pytest.mark.parametrize("n,d,mask_kind", [
    (4096, 50, "flagship"), (1100, 50, "random"), (1100, 49, "random"),
    (4096, 50, "all_masked"), (129, 49, "one_row"), (4096, 50, "ctas_masked"),
    (4096, 64, "random")])
def test_whitening_kernels_match_plain_versions(dev, n, d, mask_kind):
    """J, K, L (with the T/S/M algebra) and M, and K's eval route (the
    Cholesky in its prologue), against the plain versions run in float64
    on the card: the flagship's
    [4096, 200] with its node mask, a ragged N = 1,100, d = 49, an
    all-masked and a one-row mask, the rows of J's first three CTAs masked,
    and d = 64, whose plan takes clusters of 8.  1e-5 of each output's max: the covariances here are well
    conditioned (chip_smoke.py holds the badly conditioned cases).  A
    second launch of J, L (both variants, and the frozen one with dx), K
    and its eval route is bit-equal, and the eval route's y is K's fed the
    factor it returns.  The frozen L with dx gives the frozen L's dGamma
    and dbeta and M's frozen dx bit for bit, that dx within 1e-5 of the
    plain version in float64."""
    x, mask, gamma, beta, g = _whitening_case(dev, n, d, mask_kind)
    wrappers = (fw.wbn_stats, fw.wbn_transform, fw.wbn_bwd_sums, fw.wbn_dx)
    counts = [w.launches for w in wrappers]
    mean, cov, l, cnt = fw.wbn_stats(x, mask, 1e-5)
    y = fw.wbn_transform(x, mean, l, gamma, beta)
    dgamma, dbeta, mmat, sw = fw.wbn_bwd_sums(x, g, gamma, mean, l)
    dx = fw.wbn_dx(x, g, mask, gamma, mean, l, mmat, sw, cnt)
    y_eval, l_eval = fw.wbn_transform_eval(x, mean, cov, gamma, beta, 1e-5)
    torch.cuda.synchronize()
    assert [w.launches for w in wrappers] == [c + 1 for c in counts[:1]] + [
        counts[1] + 2] + [c + 1 for c in counts[2:]]
    frozen = fw.wbn_bwd_sums(x, g, gamma, mean, l, frozen=True)
    frozen_dx = fw.wbn_dx(x, g, None, gamma, mean, l, None, None, None,
                          frozen=True)
    fused = fw.wbn_bwd_sums(x, g, gamma, mean, l, frozen=True, with_dx=True)
    for first, again in (
            ((mean, cov, l, cnt), fw.wbn_stats(x, mask, 1e-5)),
            ((dgamma, dbeta, mmat, sw), fw.wbn_bwd_sums(x, g, gamma, mean, l)),
            (frozen, fw.wbn_bwd_sums(x, g, gamma, mean, l, frozen=True)),
            (fused, fw.wbn_bwd_sums(x, g, gamma, mean, l, frozen=True,
                                    with_dx=True)),
            # the fused route is the frozen L and M's frozen variant
            (fused, frozen + (frozen_dx,)),
            ((y,), (fw.wbn_transform(x, mean, l, gamma, beta),)),
            ((y_eval, l_eval), fw.wbn_transform_eval(x, mean, cov, gamma,
                                                     beta, 1e-5)),
            # the eval route is K fed the factor it writes
            ((y_eval,), (fw.wbn_transform(x, mean, l_eval, gamma, beta),))):
        assert all(torch.equal(a, b) for a, b in zip(first, again))
    x64, gam64, beta64, g64 = (t.double() for t in (x, gamma, beta, g))
    r_mean, r_cov, r_l, r_cnt = fw.wbn_stats_plain(x64, mask, 1e-5)
    r_sums = fw.wbn_bwd_sums_plain(x64, g64, gam64, r_mean, r_l)
    ref = (r_mean, r_cov, r_l, r_cnt,
           fw.wbn_transform_plain(x64, r_mean, r_l, gam64, beta64)) + r_sums + (
        fw.wbn_dx_plain(x64, g64, mask, gam64, r_mean, r_l, r_sums[2],
                        r_sums[3], r_cnt),) + fw.wbn_transform_eval_plain(
        x64, r_mean, r_cov, gam64, beta64, 1e-5)
    got = (mean, cov, l, cnt, y, dgamma, dbeta, mmat, sw, dx, y_eval, l_eval)
    for a, b in zip(got, ref):
        assert torch.isfinite(a).all()
        if float(b.abs().max()) == 0.0:
            assert float(a.abs().max()) == 0.0
        else:
            assert _leaf_err(a, b) <= 1e-5
    assert float(cnt) == max(float(mask.sum()), 1.0)
    assert _leaf_err(fused[2], fw.wbn_dx_plain(
        x64, g64, None, gam64, mean.double(), l.double(), None, None, None,
        frozen=True)) <= 1e-5


def test_whitening_plan_runs_in_one_wave_on_the_card(dev):
    """At the quaternion path's [4096, 200], and on both sides of each width
    where the plan steps down to clusters of 8, 4, 2 and 1, the card holds
    every cluster of J's, L's, L frozen's and L frozen with dx's plan at
    once."""
    for kernel in fw.WBN_KERNELS:
        for d in (50, 56, 57, 120, 128, 240, 241, 528, 529):
            plan = fw.wbn_plan(4096, d, fw.WBN_STATS_SUMS
                               if kernel == "wbn_stats" else fw.WBN_SUMS)
            assert (fw._max_active_clusters(plan, kernel)
                    >= plan.grid // plan.cluster), (kernel, d, plan)


def test_fused_whitening_autograd_on_the_card(dev):
    """``fused_whitening`` forward and backward on CUDA tensors go through
    the four kernels and agree with the same function on the CPU."""
    x, mask, gamma, beta, g = _whitening_case(dev, 1100, 50, "random")
    outs = []
    for device in (dev, torch.device("cpu")):
        tx, tg, tb = (t.detach().to(device).requires_grad_()
                      for t in (x, gamma, beta))
        y, mean, cov = fw.fused_whitening(tx, mask.to(device), tg, tb)
        (y * g.to(device)).sum().backward()
        outs.append([t.detach().cpu() for t in (y, mean, cov, tx.grad,
                                                tg.grad, tb.grad)])
    for a, b in zip(*outs):
        assert _leaf_err(a, b) <= 1e-5


def _reduce_case(dev, case):
    """(msgs, mask, rowptr) for kernels H and I: the flagship batch's
    receivers at D = 200; the adversarial receivers (an isolated node, a
    1,100-edge segment, masked edges inside segments, an all-masked one);
    the flagship's with exact ties (halves in [-1.5, 1.5]); or with |m| >=
    1e29 (H only: I's squares overflow f32 there, as JAX's do)."""
    if case == "adversarial":
        msgs, mask, _, rowptr = _adversarial_case(dev)
        return msgs, mask, rowptr
    msgs, mask, _, rowptr = _flagship_case(dev, 1.0)
    gen = torch.Generator().manual_seed(9)
    if case == "ties":
        msgs = (torch.randint(-3, 4, msgs.shape, generator=gen) / 2).to(dev)
    elif case == "huge":
        msgs = (torch.sign(msgs) * (1e29 + 1e30 * msgs.abs())).contiguous()
    return msgs, mask, rowptr


@pytest.mark.parametrize("case", ["flagship", "adversarial", "ties", "huge"])
def test_segment_extreme_kernel_matches_plain_version(dev, case):
    """H, max and min, bit for bit against its plain version in float64 (a
    selection is exact); 0 where a segment has no real edge."""
    msgs, mask, rowptr = _reduce_case(dev, case)
    n0 = sr.segment_extreme.launches
    outs = [sr.segment_extreme(msgs, mask, rowptr, minimum)
            for minimum in (False, True)]
    torch.cuda.synchronize()
    assert sr.segment_extreme.launches == n0 + 2
    for minimum, out in zip((False, True), outs):
        want = sr.segment_extreme_plain(msgs.double(), mask, rowptr, minimum)
        assert torch.equal(out.double(), want)
    if case == "adversarial":
        assert torch.all(outs[0][3] == 0) and torch.all(outs[1][11] == 0)


@pytest.mark.parametrize("case", ["flagship", "adversarial", "ties"])
def test_segment_moments_kernel_matches_plain_version(dev, case):
    """I's mean and var against its plain version in float64 (1e-5 of each
    output's max: f32 sums of up to 1,100 rows); a segment of one real edge
    gives var 0 exactly (no FMA contracts JAX's formula)."""
    msgs, mask, rowptr = _reduce_case(dev, case)
    n0 = sr.segment_moments.launches
    mean, var = sr.segment_moments(msgs, mask, rowptr)
    torch.cuda.synchronize()
    assert sr.segment_moments.launches == n0 + 1
    r_mean, r_var = sr.segment_moments_plain(msgs.double(), mask, rowptr)
    assert _leaf_err(mean, r_mean) <= 1e-5
    assert _leaf_err(var, r_var) <= 1e-5
    seg = ssum.segment_ids(rowptr)
    real = torch.zeros(rowptr.shape[0] - 1, device=dev).index_add_(
        0, seg, mask[:seg.shape[0]].float())
    assert torch.all(var[real == 1] == 0)


@pytest.mark.parametrize("need_x,need_p", [(True, True), (True, False),
                                           (False, True)])
def test_eval_whitening_backward_on_the_card(dev, need_x, need_p):
    """The eval whitening's gradients on the card (one launch of K's eval
    route, then one launch backward: the frozen L writing dx where x and
    Gamma, beta need gradients, M's frozen variant where only x does, the
    frozen L without dx where only Gamma and beta do) against the same
    module on the CPU, and the frozen kernels against their plain versions
    in float64."""
    x, _, gamma, beta, g = _whitening_case(dev, 1100, 50, "random")
    gen = torch.Generator().manual_seed(3)
    b = torch.randn((50, 4, 4), generator=gen)
    cov = (b @ b.transpose(1, 2) / 4 + 0.2 * torch.eye(4)).permute(1, 2, 0)
    mean = torch.randn((4, 50), generator=gen) * 0.3
    outs = []
    for device in (dev, torch.device("cpu")):
        norm = QuaternionWhiteningNorm(50).to(device)
        with torch.no_grad():
            for t, v in ((norm.gamma, gamma), (norm.beta, beta),
                         (norm.mean, mean), (norm.cov, cov)):
                t.copy_(v)
        norm.gamma.requires_grad_(need_p)
        norm.beta.requires_grad_(need_p)
        tx = x.detach().to(device).requires_grad_(need_x)
        counts = (fw.wbn_transform.launches, fw.wbn_bwd_sums.launches,
                  fw.wbn_dx.launches)
        y = norm(tx, training=False)
        (y * g.to(device)).sum().backward()
        if device.type == "cuda":
            torch.cuda.synchronize()
            assert (fw.wbn_transform.launches, fw.wbn_bwd_sums.launches,
                    fw.wbn_dx.launches) == (counts[0] + 1,
                                            counts[1] + int(need_p),
                                            counts[2] + int(not need_p))
        grads = (tx.grad, norm.gamma.grad, norm.beta.grad)
        assert [t is not None for t in grads] == [need_x, need_p, need_p]
        outs.append([t.detach().cpu() for t in (y,) + grads if t is not None])
    for a, b in zip(*outs):
        assert _leaf_err(a, b) <= 1e-5
    mean_d = mean.to(dev)
    _, l = fw.wbn_transform_eval(x, mean_d, cov.to(dev).contiguous(), gamma,
                                 beta, 1e-5)
    got = fw.wbn_bwd_sums(x, g, gamma, mean_d, l, frozen=True) + (
        fw.wbn_dx(x, g, None, gamma, mean_d, l, None, None, None,
                  frozen=True),)
    fused = fw.wbn_bwd_sums(x, g, gamma, mean_d, l, frozen=True, with_dx=True)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(fused, got))
    x64, g64, gam64, l64 = (t.double() for t in (x, g, gamma, l))
    want = fw.wbn_bwd_sums_plain(x64, g64, gam64, mean_d.double(), l64,
                                 frozen=True, with_dx=True)
    for a, b in zip(got, want):
        assert _leaf_err(a, b) <= 1e-5


@pytest.mark.parametrize("n,d", [(4096, 300), (0, 50), (1, 50), (129, 7)])
def test_whitening_transform_routes_cover_every_pair(dev, n, d):
    """K and its eval route, and M's frozen variant on the same pairs,
    where the pairs do not fill a CTA or a thread's second pair, d = 300
    past one chunk of 256 staged features, and no rows at all (the eval
    route still writes its factor): against the plain versions in float64,
    y bit-equal between the routes fed one factor, M's frozen dx bit-equal
    to the frozen L's with dx."""
    x, _, gamma, beta, g = _whitening_case(dev, max(n, 1), d, "random")
    x, g = x[:n].contiguous(), g[:n].contiguous()
    gen = torch.Generator().manual_seed(d)
    b = torch.randn((d, 4, 4), generator=gen)
    cov = (b @ b.transpose(1, 2) / 4 + 0.2 * torch.eye(4)).permute(
        1, 2, 0).contiguous().to(dev)
    mean = (torch.randn((4, d), generator=gen) * 0.3).to(dev)
    y_eval, l = fw.wbn_transform_eval(x, mean, cov, gamma, beta, 1e-5)
    y = fw.wbn_transform(x, mean, l, gamma, beta)
    torch.cuda.synchronize()
    assert torch.equal(y, y_eval)
    want_y, want_l = fw.wbn_transform_eval_plain(
        x.double(), mean.double(), cov.double(), gamma.double(),
        beta.double(), 1e-5)
    dx = fw.wbn_dx(x, g, None, gamma, mean, l, None, None, None, frozen=True)
    fused = fw.wbn_bwd_sums(x, g, gamma, mean, l, frozen=True, with_dx=True)
    torch.cuda.synchronize()
    assert torch.equal(dx, fused[2])
    assert _leaf_err(l, want_l) <= 1e-5
    if n:
        assert _leaf_err(y, want_y) <= 1e-5
        assert _leaf_err(dx, fw.wbn_dx_plain(
            x.double(), g.double(), None, gamma.double(), mean.double(),
            l.double(), None, None, None, frozen=True)) <= 1e-5


@pytest.mark.parametrize("case", ["flagship", "adversarial", "d37"])
def test_bf16_instances_match_the_f32_instances(dev, case):
    """A, B (both variants) and C (both roles) on bf16 rows: float32
    outputs, bit-equal to the float32 instances fed the exactly upcast rows,
    within the float32 checks' tolerances of their plain versions; each
    launch counted by ``launches_bf16`` and not by ``launches``."""
    m, k, b, rp = (_flagship_case(dev, 1.37) if case != "adversarial"
                   else _adversarial_case(dev))
    if case == "d37":
        m = m[:, :37].contiguous()
    m = m.to(torch.bfloat16)
    counts = [(w.launches, w.launches_bf16) for w in (
        ss.segment_logit_max, ss.segment_softmax_aggregate,
        ssum.segment_sum_masked, ssum.segment_sum_perm)]
    smax = ss.segment_logit_max(m, k, b, rp)
    got = ss.segment_softmax_aggregate(m, k, b, rp, smax, emit_w=True)
    masked = ssum.segment_sum_masked(m, k, rp)
    perm = torch.arange(m.shape[0], dtype=torch.int32, device=dev)
    summed = ssum.segment_sum_perm(m, perm, rp)
    torch.cuda.synchronize()
    after = [(w.launches, w.launches_bf16) for w in (
        ss.segment_logit_max, ss.segment_softmax_aggregate,
        ssum.segment_sum_masked, ssum.segment_sum_perm)]
    assert after == [(n, n16 + 1) for n, n16 in counts]
    up = m.float()
    smax32 = ss.segment_logit_max(up, k, b, rp)
    assert torch.equal(smax, smax32)
    for g, w in zip(got, ss.segment_softmax_aggregate(up, k, b, rp, smax32,
                                                      emit_w=True)):
        assert g.dtype == torch.float32 and torch.equal(g, w)
    assert torch.equal(masked, ssum.segment_sum_masked(up, k, rp))
    assert torch.equal(summed, ssum.segment_sum_perm(up, perm, rp))
    assert _rel_err(smax, ss.segment_logit_max_plain(m, k, b, rp)) <= 1e-6
    want = ss.segment_softmax_aggregate_plain(m, k, b, rp, smax)
    assert _rel_err(got[0], want) <= 1e-5
    assert _leaf_err(masked, ssum.segment_sum_masked_plain(
        m.double(), k, rp)) <= 1e-5


def _off_by_one(t):
    """A contiguous copy of ``t`` one element past its allocation's base:
    bf16 rows 2 bytes off 16-byte alignment."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("case", ["flagship", "adversarial", "d37",
                                  "unaligned"])
def test_fused_softmax_is_the_pair_bit_for_bit(dev, case):
    """The fused kernel on bf16 messages: ``out``, ``w`` and ``den`` of its
    training variant and ``out`` of its eval variant bit-equal to A bf16
    then B bf16 and to float32 A then B fed the upcast rows; the softmax
    aggregation on bf16 messages launches it once, counted on
    ``segment_softmax_fused.launches_bf16``, and neither A nor B."""
    m, k, b, rp = (_flagship_case(dev, 1.37) if case != "adversarial"
                   else _adversarial_case(dev))
    if case == "d37":
        m = m[:, :37].contiguous()
    m = m.to(torch.bfloat16)
    if case == "unaligned":
        m = _off_by_one(m)
    smax = ss.segment_logit_max(m, k, b, rp)
    pair = ss.segment_softmax_aggregate(m, k, b, rp, smax, emit_w=True)
    pair_nw = ss.segment_softmax_aggregate(m, k, b, rp, smax)
    up = m.float()
    f32 = ss.segment_softmax_aggregate(
        up, k, b, rp, ss.segment_logit_max(up, k, b, rp), emit_w=True)
    got = ss.segment_softmax_fused(m, k, b, rp, emit_w=True)
    got_nw = ss.segment_softmax_fused(m, k, b, rp)
    torch.cuda.synchronize()
    for g, p, f in zip(got, pair, f32):
        assert g.dtype == torch.float32
        assert torch.equal(g, p) and torch.equal(g, f)
    assert torch.equal(got_nw, pair_nw)
    counters = (ss.segment_logit_max, ss.segment_softmax_aggregate,
                ss.segment_softmax_fused)
    before = [(w.launches, w.launches_bf16) for w in counters]
    out = ss.segment_softmax(m, k, b, rp)
    torch.cuda.synchronize()
    after = [(w.launches, w.launches_bf16) for w in counters]
    assert after == before[:2] + [(before[2][0], before[2][1] + 1)]
    assert torch.equal(out, pair_nw)
    with pytest.raises(TypeError, match="bfloat16"):
        ss.segment_softmax_fused(up, k, b, rp)


@pytest.mark.parametrize("role", ["masked", "perm"])
@pytest.mark.parametrize("width", [200, 512, 768, "senders"])
def test_segment_sum_bulk_instance_is_the_sequential_sum(dev, role, width):
    """C's bulk instance on bf16 rows (rows staged by the TMA's bulk copy)
    at widths 200, 512 and 768 over the adversarial nodes (node 7's 1,100
    edges past its stage), and on the adversarial senders of
    ``chip_smoke.py`` (perm role; the masked role there reads the same
    receivers at 200): bit-equal to the plain version run in float32 on the
    CPU, a sequential sum in edge order, to a second launch, to the
    instance without the bulk copy and to the float32 instance fed the
    upcast rows; by default the plan takes it here (runs of 8) only in the
    masked role on rows of 1 KB or more."""
    msgs, mask, _, rowptr = _adversarial_case(dev)
    d = 200 if width == "senders" else width
    gen = torch.Generator().manual_seed(d + 1)
    values = (torch.rand((msgs.shape[0], d), generator=gen) * 64 - 32).to(dev)
    index = mask
    if role == "perm":
        rng = np.random.default_rng(d + 1)
        counts = np.diff(rowptr.cpu().numpy())
        if width == "senders":
            counts = rng.integers(1, 6, size=64)
            counts[3], counts[7] = 0, 1100
        senders = rng.permutation(np.repeat(np.arange(counts.shape[0]),
                                            counts))
        e_mask = rng.random(senders.shape[0]) > 0.2
        senders = np.concatenate([senders, np.full(40, counts.shape[0] - 1)])
        e_mask = np.concatenate([e_mask, np.zeros(40, bool)])
        index, rowptr = (torch.from_numpy(a).to(dev) for a in build_sender_csr(
            senders.astype(np.int32), counts.shape[0], e_mask))
        values = (torch.rand((senders.shape[0], d), generator=gen) * 64
                  - 32).to(dev)
    values = values.to(torch.bfloat16)
    n, e = rowptr.shape[0] - 1, values.shape[0]
    plan = ssum.segment_sum_plan(n, e, d, role == "perm", True, 2, True)
    assert plan.bulk and plan.stage < 1100
    assert ssum.segment_sum_plan(n, e, d, role == "perm", True,
                                 2).bulk == (role == "masked" and d >= 512)
    fn = ssum.segment_sum_perm if role == "perm" else ssum.segment_sum_masked
    plain = (ssum.segment_sum_perm_plain if role == "perm"
             else ssum.segment_sum_masked_plain)
    counts = (fn.launches, fn.launches_bf16)
    out = ssum.segment_sum_instance(role, values, index, rowptr, True)
    again = ssum.segment_sum_instance(role, values, index, rowptr, True)
    nobulk = ssum.segment_sum_instance(role, values, index, rowptr, False)
    f32 = fn(values.float(), index, rowptr)
    torch.cuda.synchronize()
    assert (fn.launches, fn.launches_bf16) == (counts[0] + 1, counts[1])
    assert torch.equal(out, again) and torch.equal(out, nobulk)
    assert torch.equal(out, f32)
    assert torch.equal(out.cpu(), plain(values.cpu(), index.cpu(),
                                        rowptr.cpu()))
    assert torch.all(out[3] == 0)


def test_wrappers_take_only_f32_or_bf16(dev):
    """float16 rows are refused by A, B and C, and H and I take float32
    alone (the aggregations upcast bf16 messages before them)."""
    m, k, b, rp = _flagship_case(dev, 1.0)
    with pytest.raises(TypeError, match="bfloat16"):
        ss.segment_logit_max(m.half(), k, b, rp)
    with pytest.raises(TypeError, match="bfloat16"):
        ssum.segment_sum_masked(m.half(), k, rp)
    with pytest.raises(TypeError, match="float32"):
        sr.segment_extreme(m.to(torch.bfloat16), k, rp)
