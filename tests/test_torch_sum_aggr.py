"""The port's sum aggregation (kernel C's forward role, its plain version) and
the convs that use it, against the JAX reference.

``segment_sum_aggregate`` is held to ``segment_sum_streamed`` with the
batch's scan plan (Pallas kernel C in interpret mode), forward and VJP, on
receiver-sorted edges with masked edges inside segments, an isolated node,
a 1,100-edge segment and the batcher's masked padding tail.  ``PHMConv``
and ``PHMGINEConv`` are held to flax's through the facade at ``phm_dim`` 2
and 4, with converted weights.

Tolerances: 1e-5 per leaf for the segment sum (f32 sums of the same rows in
other orders: JAX's prefix scan carries across blocks, and a 1,100-term sum
drifts ~1e-6 of the leaf's max, while one edge dropped reads ~1e-2, as
``test_torch_segment_sum.py::test_segment_sum_tolerance_separates_a_dropped_edge``
shows); 1e-6 for its gradient (a gather: exact); 1e-5 normwise for the
convs, as in ``tests/test_torch_modules.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phc_gnn_tpu.data import synthetic_batch as jax_synthetic_batch
from phc_gnn_tpu.graph import conv as jconv
from phc_gnn_tpu.ops.stream_scan import (attach_scan_plan, build_scan_plan,
                                         segment_sum_streamed)
from phc_gnn_torch.data import synthetic_batch
from phc_gnn_torch.graph import attach_csr_plan, build_csr_rowptr, conv
from phc_gnn_torch.ops import segment_sum as ssum
from torch_parity import (adversarial_receivers, assert_close,
                          assert_leaf_close, load_flax, randomize)
from torch_threads import one_torch_thread  # noqa: F401

REL_SUM = 1e-5
REL_GATHER = 1e-6
REL = 1e-5


def _synthetic(seed: int):
    b = jax_synthetic_batch(8, 256, 512, seed=seed)
    return np.array(b.receivers), np.array(b.edge_mask), b.num_nodes


CASES = {"synthetic0": lambda: _synthetic(0),
         "adversarial0": lambda: adversarial_receivers(0, 40),
         "adversarial1": lambda: adversarial_receivers(1, 40)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_segment_sum_aggregate_matches_streamed_kernel(case):
    recv, mask, n = CASES[case]()
    d = 24
    rng = np.random.default_rng(9)
    msgs = rng.normal(size=(recv.shape[0], d)).astype(np.float32)
    g = rng.normal(size=(n, d)).astype(np.float32)
    flags, cont, last = map(jnp.asarray, build_scan_plan(recv, n,
                                                         edge_mask=mask))
    out_j, vjp = jax.vjp(lambda m_: segment_sum_streamed(
        m_, jnp.asarray(recv), flags, cont, last, n,
        edge_mask=jnp.asarray(mask)), jnp.asarray(msgs))
    (dm_j,) = vjp(jnp.asarray(g))

    rowptr = torch.from_numpy(build_csr_rowptr(recv, n, mask))
    mt = torch.tensor(msgs, requires_grad=True)
    out = ssum.segment_sum_aggregate(mt, torch.from_numpy(recv),
                                     torch.from_numpy(mask), rowptr)
    out.backward(torch.from_numpy(g))
    assert_leaf_close(out.detach(), np.asarray(out_j), REL_SUM, "out")
    assert_leaf_close(mt.grad, np.asarray(dm_j), REL_GATHER, "dmsgs")
    assert torch.all(mt.grad[~torch.from_numpy(mask)] == 0)  # padding edges
    if case.startswith("adversarial"):
        assert torch.all(out[3] == 0) and torch.all(out[11] == 0)
        real7 = msgs[(recv == 7) & mask].sum(0)
        np.testing.assert_allclose(out[7].detach().numpy(), real7, rtol=1e-5,
                                   atol=1e-4)


def test_segment_sum_masked_plain_is_a_masked_csr_sum():
    """out[n] = sum of msgs[e] over n's segment where mask[e]; 0 when empty;
    edges past rowptr[-1] in no segment."""
    msgs = torch.arange(14, dtype=torch.float32).reshape(7, 2)
    mask = torch.tensor([True, False, True, True, True, False, False])
    rowptr = torch.tensor([0, 2, 2, 5], dtype=torch.int32)
    out = ssum.segment_sum_masked(msgs, mask, rowptr)
    want = torch.stack([msgs[0], torch.zeros(2), msgs[[2, 3, 4]].sum(0)])
    assert torch.equal(out, want)


def _graph_inputs(seed, phm_dim):
    jb = attach_scan_plan(jax_synthetic_batch(8, 256, 512, seed=seed))
    tb = attach_csr_plan(synthetic_batch(8, 256, 512, seed=seed))
    rng = np.random.default_rng(seed)
    width = 8 * phm_dim
    x = rng.normal(size=(jb.num_nodes, width)).astype(np.float32)
    ea = rng.normal(size=(jb.num_edges, width)).astype(np.float32)
    return jb, tb, x, ea, width


@pytest.mark.parametrize("phm_dim", [2, 4])
@pytest.mark.parametrize("mlp", [False, True])
@pytest.mark.parametrize("with_plan", [True, False])
def test_sum_convs_match_flax(phm_dim, mlp, with_plan):
    """``PHMConv`` (mlp=False, the self loop after the transform) and
    ``PHMGINEConv`` (mlp=True, before its MLP, with a batch norm) through the
    facade: JAX with its scan plan (kernel C in interpret mode) or the XLA
    composite; the port with its CSR plan (kernel C's plain version) or the
    composite.  The gradient of x through the plan's path too."""
    jb, tb, x, ea, w = _graph_inputs(2 + phm_dim, phm_dim)
    kw = dict(norm="naive-batch-norm", aggr="sum", mlp=mlp)
    jm = jconv.PHMMessagePassing(w, w, phm_dim, **kw)
    plan = (jb.scan_flags, jb.scan_cont, jb.last_edge) if with_plan else None
    args = (jnp.asarray(x), jb.senders, jb.receivers, jnp.asarray(ea),
            jb.edge_mask)
    v = randomize(jm.init(jax.random.key(phm_dim), *args, training=False,
                          node_mask=jb.node_mask, scan_plan=plan), phm_dim)
    want, vjp = jax.vjp(lambda x_: jm.apply(
        v, x_, *args[1:], training=False, node_mask=jb.node_mask,
        scan_plan=plan), jnp.asarray(x))
    g = np.random.default_rng(1).normal(size=want.shape).astype(np.float32)
    (dx_j,) = vjp(jnp.asarray(g))
    tm = load_flax(conv.PHMMessagePassing(w, w, phm_dim, **kw), v)
    assert isinstance(tm.conv, conv.PHMGINEConv if mlp else conv.PHMConv)
    xt = torch.tensor(x, requires_grad=True)
    got = tm(xt, tb.senders, tb.receivers, torch.from_numpy(ea), tb.edge_mask,
             node_mask=tb.node_mask, rowptr=tb.rowptr if with_plan else None,
             snd_perm=tb.snd_perm if with_plan else None,
             snd_rowptr=tb.snd_rowptr if with_plan else None)
    assert_close(got, np.asarray(want), REL)
    got.backward(torch.from_numpy(g))
    assert_close(xt.grad, np.asarray(dx_j), REL)


def test_phm_conv_without_self_loops_matches_flax():
    """``add_self_loops=False``: transform(aggr) alone, as flax's PHMConv."""
    jb, tb, x, ea, w = _graph_inputs(5, 2)
    jm = jconv.PHMConv(w, w, 2, add_self_loops=False)
    args = (jnp.asarray(x), jb.senders, jb.receivers, jnp.asarray(ea),
            jb.edge_mask)
    v = jm.init(jax.random.key(5), *args)
    tm = load_flax(conv.PHMConv(w, w, 2, add_self_loops=False), v)
    got = tm(torch.from_numpy(x), tb.senders, tb.receivers,
             torch.from_numpy(ea), tb.edge_mask, rowptr=tb.rowptr)
    assert_close(got, np.asarray(jm.apply(v, *args)), REL)


def test_fixed_aggr_off_cpu_takes_the_kernel_or_raises():
    """Off the CPU there is no composite fallback: without a CSR plan the
    sum aggregation raises, with one it goes to kernel C's wrapper (which
    refuses a device it cannot launch on)."""
    m = torch.empty(4, 8, device="meta")
    recv = torch.empty(4, dtype=torch.int32, device="meta")
    k = torch.empty(4, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="attach_csr_plan"):
        conv._fixed_aggr(m, recv, 2, k, "sum", rowptr=None)
    rowptr = torch.empty(3, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        conv._fixed_aggr(m, recv, 2, k, "sum", rowptr=rowptr)


@pytest.mark.parametrize("cls", [conv.PHMConv, conv.PHMGINEConv])
def test_fixed_aggr_convs_refuse_unported_aggregations(cls):
    """Built directly, a fixed-aggregation conv with an aggregation that it
    does not know raises, rather than running the sum kernel; since the PNA
    slice that is any but sum, mean, min, max, var and std."""
    with pytest.raises(ValueError, match="'median'"):
        cls(16, 16, 2, aggr="median")
    assert cls(16, 16, 2, aggr="mean").aggr == "mean"
