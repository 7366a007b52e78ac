"""PNA's pieces beside the plan route, against JAX: the composite
aggregations of a batch without a CSR plan (``graph/segment.py``, which
split a tie at a min or max as ``jax.ops.segment_max`` does) against
``AGGREGATORS``; the std's relu kink; kernels H's and I's plain versions on
a hand-made CSR; the masked in-degree, every degree scaler and ``phm_cat``;
the degree statistics (``data/datasets.py``); the real-edge count; and
``build_model`` with ``avg_deg``.

Tolerances, each with its reason:
- ``REL_AGG`` 1e-5 per leaf: segment sums of the same f32 rows in other
  orders (JAX's prefix scan carries across 128-edge blocks); a max or min
  is exact;
- ``REL_EXTREME_GRAD`` 1e-6: the min/max backward is a gather, exact;
- ``REL_GRAD`` 1e-5 per leaf for the mean, var and std backwards (their
  means and counts in other orders), on inputs whose var stays away from 0;
- ``KINK_ATOL`` 5e-3 of the cotangent's max for std's gradient on segments
  whose var sits at rounding level: ``relu(var)`` then flips between the
  two summation orders and ``d std / d var`` is about 158 there, as
  tests/test_stream_scan.py allows for the same reason; ``KINK_FWD_ATOL``
  1e-4 for std itself there (var's f32 rounding, ~2e-7, times 158).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phc_gnn_tpu.data import synthetic_batch as jax_synthetic_batch
from phc_gnn_tpu.data.datasets import (avg_deg_from_histogram as
                                       jax_avg_deg_from_histogram)
from phc_gnn_tpu.data.datasets import degree_histogram as jax_degree_histogram
from phc_gnn_tpu.graph import aggregators as jagg
from phc_gnn_tpu.train.config import ExperimentConfig as JaxConfig
from phc_gnn_tpu.train.trainer import build_model as jax_build_model
from phc_gnn_torch.convert import from_flax_variables
from phc_gnn_torch.data import (ZINC_ATOM_DIMS, ZINC_BOND_DIMS,
                                avg_deg_from_histogram, degree_histogram,
                                synthetic_graphs)
from phc_gnn_torch.graph import aggregators as tagg
from phc_gnn_torch.graph import build_csr_rowptr, conv
from phc_gnn_torch.graph.segment import segment_count
from phc_gnn_torch.ops import segment_reduce as sr
from phc_gnn_torch.train.config import ExperimentConfig
from phc_gnn_torch.train.trainer import build_model
from torch_parity import (adversarial_receivers, assert_close,
                          assert_leaf_close, jax_plan_aggregate,
                          pna_messages, port_plan_aggregate, small_receivers)
from torch_threads import one_torch_thread  # noqa: F401

REL_AGG = 1e-5
REL_GRAD = 1e-5
KINK_ATOL = 5e-3
KINK_FWD_ATOL = 1e-4
AVG_DEG = {"lin": 2.2, "log": 1.15, "exp": 10.9}
AGGRS = ["mean", "min", "max", "var", "std"]


@pytest.mark.parametrize("name", AGGRS)
def test_composite_aggregators_match_xla(name):
    """Without a plan the port takes its composites, which follow JAX's XLA
    ``AGGREGATORS``: a tie at a min or max splits the cotangent."""
    recv, mask, n = small_receivers(3)
    msgs = pna_messages("ties", recv.shape[0], 24, 9)
    g = np.random.default_rng(10).normal(size=(n, 24)).astype(np.float32)
    out_j, vjp = jax.vjp(lambda m_: jagg.AGGREGATORS[name](
        m_, jnp.asarray(recv), n, jnp.asarray(mask)), jnp.asarray(msgs))
    (dm_j,) = vjp(jnp.asarray(g))
    mt = torch.tensor(msgs, requires_grad=True)
    out = conv._fixed_aggr(mt, torch.from_numpy(recv), n,
                           torch.from_numpy(mask), name, rowptr=None)
    out.backward(torch.from_numpy(g))
    assert_leaf_close(out.detach(), np.asarray(out_j), REL_AGG, "out")
    assert_leaf_close(mt.grad, np.asarray(dm_j), REL_GRAD, "dmsgs")
    if name in ("min", "max"):  # a split tie differs from a whole one
        _, dm_plan = port_plan_aggregate(name, recv, mask, n, msgs, g)
        assert not torch.allclose(mt.grad, dm_plan)


def test_std_gradient_at_the_relu_kink():
    """Segments of values 1 + 1e-5 r: var is ~1e-10, under the rounding of
    E[m^2] - E[m]^2 in f32 (~2e-7 at m ~ 1), so relu(var) takes the other
    branch in the two summation orders on many lanes, and d std / d var ~
    158 turns that into gradients that differ by far more than REL_GRAD
    (shown here).  The allowances: the forward within KINK_FWD_ATOL (the
    rounding times 158), the gradient within KINK_ATOL of the cotangent's
    max, as JAX's own streamed-vs-XLA test allows."""
    recv, mask, n = small_receivers(4)
    rng = np.random.default_rng(11)
    msgs = (1.0 + 1e-5 * rng.normal(size=(recv.shape[0], 24))).astype(
        np.float32)
    g = rng.normal(size=(n, 24)).astype(np.float32)
    out_j, dm_j = jax_plan_aggregate("std", recv, mask, n, msgs, g)
    out, dm = port_plan_aggregate("std", recv, mask, n, msgs, g)
    assert float((out - torch.from_numpy(out_j)).abs().max()) <= KINK_FWD_ATOL
    err = float((dm - torch.from_numpy(dm_j)).abs().max())
    assert REL_GRAD * float(np.abs(dm_j).max()) < err <= (
        KINK_ATOL * float(np.abs(g).max()))


def test_extreme_and_moments_plain_versions():
    """H's and I's plain versions over a hand-made CSR: masked edges inside
    segments skipped, an all-masked and an empty segment give 0, edges past
    rowptr[-1] belong to no segment; one real edge gives var 0 exactly."""
    msgs = torch.tensor([[1.0], [5.0], [-2.0], [3.0], [3.0], [9.0], [7.0]])
    mask = torch.tensor([True, False, True, True, True, False, False])
    rowptr = torch.tensor([0, 2, 2, 5, 6], dtype=torch.int32)
    assert sr.segment_extreme(msgs, mask, rowptr).ravel().tolist() == [
        1.0, 0.0, 3.0, 0.0]
    assert sr.segment_extreme(msgs, mask, rowptr, minimum=True).ravel(
        ).tolist() == [1.0, 0.0, -2.0, 0.0]
    mean, var = sr.segment_moments(msgs, mask, rowptr)
    torch.testing.assert_close(mean.ravel(),
                               torch.tensor([1.0, 0.0, 4.0 / 3.0, 0.0]))
    assert var[0, 0] == 0 and var[1, 0] == 0 and var[3, 0] == 0
    torch.testing.assert_close(var[2, 0], torch.tensor(22.0 / 3 - 16.0 / 9))


def test_node_degrees_scalers_and_phm_cat_match_jax():
    """The masked in-degree, every scaler (deg = 0 included: attenuation and
    inverse_linear select the division's inf away) with its gradient, and
    phm_cat."""
    recv, mask, n = adversarial_receivers(1)
    deg_j = np.asarray(jagg.node_degrees(jnp.asarray(recv), n,
                                         jnp.asarray(mask)))
    deg = tagg.node_degrees(torch.from_numpy(recv), n, torch.from_numpy(mask))
    np.testing.assert_array_equal(deg.numpy(), deg_j)
    assert deg[3, 0] == 0 and deg[11, 0] == 0
    x = np.random.default_rng(12).normal(size=(n, 8)).astype(np.float32)
    for name in sorted(jagg.SCALERS):
        want, vjp = jax.vjp(lambda x_: jagg.SCALERS[name](
            x_, jnp.asarray(deg_j), AVG_DEG), jnp.asarray(x))
        xt = torch.tensor(x, requires_grad=True)
        got = tagg.SCALERS[name](xt, deg, AVG_DEG)
        got.backward(torch.ones_like(got))
        assert_close(got.detach(), np.asarray(want), 1e-6)
        assert_close(xt.grad, np.asarray(vjp(jnp.ones_like(want))[0]), 1e-6)
    parts = [np.random.default_rng(s).normal(size=(5, 4 * w)).astype(
        np.float32) for s, w in ((0, 2), (1, 3))]
    np.testing.assert_array_equal(
        tagg.phm_cat([torch.from_numpy(p) for p in parts], 4).numpy(),
        np.asarray(jagg.phm_cat([jnp.asarray(p) for p in parts], 4)))


def test_degree_statistics_match_jax():
    graphs = synthetic_graphs(16, seed=2)
    hist = degree_histogram(graphs)
    np.testing.assert_array_equal(hist, jax_degree_histogram(graphs))
    assert avg_deg_from_histogram(hist) == jax_avg_deg_from_histogram(hist)


def test_build_model_takes_avg_deg():
    """``build_model`` from the recipe's ``ExperimentConfig`` and avg_deg:
    the port's model has the JAX model's every variable, of the same
    shape, and its convs read avg_deg."""
    exp = dict(dataset="zinc", phm_dim=4, model_type="add", sc_type="last",
               aggr_msg="pna", mlp_mp=True, input_embed_dim=32,
               mp_units=(32, 32), d_units=(128, 64),
               dropout_mpnn=(0.0, 0.0), dropout_dn=(0.2, 0.1),
               batch_size=128, lr=1e-3, weightdecay=0.0)
    avg = avg_deg_from_histogram(degree_histogram(synthetic_graphs(8)))
    jm = jax_build_model(JaxConfig(**exp), ZINC_ATOM_DIMS, ZINC_BOND_DIMS,
                         avg_deg=avg)
    model = build_model(ExperimentConfig(**exp), ZINC_ATOM_DIMS,
                        ZINC_BOND_DIMS, avg_deg=avg, device="cpu")
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.key(0), jax_synthetic_batch(4, 128, 256, seed=0),
        training=False))
    v = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32),
                               shapes)
    assert len(from_flax_variables(v, model)) == len(model.state_dict())
    assert model.conv_1.conv.avg_deg == avg
    with pytest.raises(ValueError, match="avg_deg"):
        build_model(ExperimentConfig(**exp), ZINC_ATOM_DIMS, ZINC_BOND_DIMS,
                    device="cpu")


def test_pna_real_edge_count_ignores_masked_edges_inside_segments():
    """The mean's count and the PNA in-degree are the REAL edges: masked
    edges among real ones stay inside their CSR segment, so rowptr's
    differences overcount them."""
    recv, mask, n = adversarial_receivers(2)
    rowptr = build_csr_rowptr(recv, n, mask)
    counts = segment_count(torch.from_numpy(recv), n, torch.from_numpy(mask))
    np.testing.assert_array_equal(
        counts.numpy(), np.bincount(recv[mask], minlength=n))
    assert np.any(np.diff(rowptr) != counts.numpy())
