"""The port's modules against their flax counterparts, with the flax weights
converted by ``convert.from_flax_variables`` and inputs from numpy seeds.

Tolerance: 1e-5 normwise relative (f32 on both sides; matmul and reduction
orders differ between XLA and PyTorch on the CPU).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phc_gnn_tpu.data import synthetic_batch as jax_synthetic_batch
from phc_gnn_tpu.graph import conv as jconv
from phc_gnn_tpu.graph import pooling as jpool
from phc_gnn_tpu.hypercomplex.kron import phm_weight_matrix as jax_phm_weight_matrix
from phc_gnn_tpu.hypercomplex.rules import get_multiplication_rule as jax_rule
from phc_gnn_tpu.nn import encoder as jenc
from phc_gnn_tpu.nn import norm as jnorm
from phc_gnn_tpu.nn import phm_linear as jlin
from phc_gnn_tpu.nn.downstream import PHMDownstreamNet as JDownstream
from phc_gnn_tpu.ops.stream_scan import attach_scan_plan
from phc_gnn_torch.graph import attach_csr_plan, conv, pooling
from phc_gnn_torch.data import synthetic_batch
from phc_gnn_torch.hypercomplex import (get_multiplication_rule, glorot_uniform,
                                        phm_init, phm_weight_matrix)
from phc_gnn_torch.nn import (PHMDownstreamNet, PHMEncoder, PHMLinear, PHMMLP,
                              PHMNorm, RealTransformer)
from torch_parity import assert_close, load_flax, randomize
from torch_threads import one_torch_thread  # noqa: F401

REL = 1e-5
N4 = 4


def _x(rows, cols, seed=0):
    return np.random.default_rng(seed).normal(size=(rows, cols)).astype(np.float32)


@pytest.mark.parametrize("n", [2, 3, 4, 5])
def test_rules_and_phm_weight_matrix_match(n):
    rule = get_multiplication_rule(n)
    np.testing.assert_array_equal(rule, jax_rule(n))
    w = np.random.default_rng(n).normal(size=(n, 3, 2)).astype(np.float32)
    got = phm_weight_matrix(torch.from_numpy(rule), torch.from_numpy(w))
    assert_close(got, np.asarray(jax_phm_weight_matrix(jnp.asarray(rule),
                                                       jnp.asarray(w))), REL)


def test_inits_shapes_and_scales():
    gen = torch.Generator().manual_seed(0)
    w = phm_init(gen, 4, 50, 50)
    assert w.shape == (4, 50, 50)
    # chi(df=4) magnitude with scale sqrt(2/(n(in+out))): E|w|^2 summed over
    # the components is 4 s^2
    s2 = 2.0 / (4 * 100)
    assert abs(float((w ** 2).sum(0).mean()) / (4 * s2) - 1.0) < 0.05
    g = glorot_uniform(gen, (28, 50))
    limit = math.sqrt(2.0) * math.sqrt(6.0 / 78)
    assert float(g.abs().max()) <= limit and float(g.abs().max()) > 0.9 * limit


@pytest.mark.parametrize("bias", [True, False])
def test_phm_linear_matches(bias):
    jm = jlin.PHMLinear(32, 16, N4, bias=bias)
    x = _x(10, 32)
    v = jm.init(jax.random.key(1), jnp.asarray(x))
    tm = load_flax(PHMLinear(32, 16, N4, bias=bias), v)
    assert_close(tm(torch.from_numpy(x)), np.asarray(jm.apply(v, jnp.asarray(x))), REL)
    if bias:  # init: component block 0 -> 0.0, the rest 0.2
        b = PHMLinear(32, 16, N4).b.detach()
        assert torch.all(b[:4] == 0.0) and torch.all(b[4:] == 0.2)


def test_phm_mlp_with_eval_norm_matches():
    jm = jlin.PHMMLP(32, 32, N4, norm="naive-batch-norm")
    x = _x(12, 32, seed=2)
    v = randomize(jm.init(jax.random.key(2), jnp.asarray(x), training=False), 2)
    tm = load_flax(PHMMLP(32, 32, N4, norm="naive-batch-norm"), v)
    assert_close(tm(torch.from_numpy(x)),
                 np.asarray(jm.apply(v, jnp.asarray(x), training=False)), REL)


def test_real_transformer_linear_matches():
    """flax Dense kernel (in, out) lands transposed in Linear.weight; the
    'sum', 'mean' and 'norm' types (no parameters) match flax's too."""
    jm = jlin.RealTransformer("linear", 32, N4)
    x = _x(6, 32, seed=3)
    v = jm.init(jax.random.key(3), jnp.asarray(x))
    tm = load_flax(RealTransformer("linear", 32, N4), v)
    assert_close(tm(torch.from_numpy(x)), np.asarray(jm.apply(v, jnp.asarray(x))), REL)
    for trafo in ("sum", "mean", "norm"):
        jm = jlin.RealTransformer(trafo, 32, N4)
        v = jm.init(jax.random.key(3), jnp.asarray(x))
        tm = load_flax(RealTransformer(trafo, 32, N4), v)
        got = tm(torch.from_numpy(x))
        assert got.shape == (6, 8)
        assert_close(got, np.asarray(jm.apply(v, jnp.asarray(x))), REL)


def test_phm_encoder_matches_with_index_clip():
    dims = [28, 5]
    jm = jenc.PHMEncoder(out_dim=8, input_dims=dims, phm_dim=N4)
    rng = np.random.default_rng(4)
    x = np.stack([rng.integers(-3, 33, 50), rng.integers(0, 9, 50)], 1).astype(np.int32)
    v = jm.init(jax.random.key(4), jnp.asarray(x))
    tm = load_flax(PHMEncoder(8, dims, N4), v)
    got = tm(torch.from_numpy(x))
    assert got.shape == (50, N4, 8)
    assert_close(got, np.asarray(jm.apply(v, jnp.asarray(x))), REL)


def test_phm_norm_eval_matches_running_stats():
    jm = jnorm.PHMNorm(num_features=32, phm_dim=N4, norm_type="naive-batch-norm")
    x = _x(20, 32, seed=5)
    v = randomize(jm.init(jax.random.key(5), jnp.asarray(x), training=False), 5)
    tm = load_flax(PHMNorm(32, N4), v)
    assert_close(tm(torch.from_numpy(x)),
                 np.asarray(jm.apply(v, jnp.asarray(x), training=False)), REL)
    # training mode normalises with the batch statistics (kernels D and E,
    # tests/test_torch_fused_bn.py) and moves the running stats
    mean0 = tm.bn.mean.clone()
    y = tm(torch.from_numpy(x), training=True)
    assert torch.isfinite(y).all() and not torch.equal(tm.bn.mean, mean0)


def _graph_inputs(seed):
    jb = attach_scan_plan(jax_synthetic_batch(8, 256, 512, seed=seed))
    tb = attach_csr_plan(synthetic_batch(8, 256, 512, seed=seed))
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(jb.num_nodes, 32)).astype(np.float32)
    ea = rng.normal(size=(jb.num_edges, 32)).astype(np.float32)
    return jb, tb, x, ea


@pytest.mark.parametrize("with_plan", [True, False])
def test_gine_conv_softmax_matches(with_plan):
    """PHMGINEConvSoftmax through the facade: JAX with its scan plan (Pallas
    kernels A/B in interpret mode) or the XLA composite; the port with its
    CSR plan (plain versions of the kernels) or its composite."""
    jb, tb, x, ea = _graph_inputs(6)
    jm = jconv.PHMMessagePassing(32, 32, N4, norm="naive-batch-norm",
                                 aggr="softmax", mlp=True)
    plan = (jb.scan_flags, jb.scan_cont, jb.last_edge) if with_plan else None
    args = (jnp.asarray(x), jb.senders, jb.receivers, jnp.asarray(ea), jb.edge_mask)
    v = randomize(jm.init(jax.random.key(6), *args, training=False,
                          node_mask=jb.node_mask, scan_plan=plan), 6)
    want = jm.apply(v, *args, training=False, node_mask=jb.node_mask,
                    scan_plan=plan)
    tm = load_flax(conv.PHMMessagePassing(32, 32, N4, norm="naive-batch-norm",
                                          aggr="softmax", mlp=True), v)
    got = tm(torch.from_numpy(x), tb.senders, tb.receivers, torch.from_numpy(ea),
             tb.edge_mask, node_mask=tb.node_mask,
             rowptr=tb.rowptr if with_plan else None)
    assert_close(got, np.asarray(want), REL)


def test_softmax_aggr_off_cpu_takes_the_kernels_or_raises():
    """Off the CPU there is no composite fallback: without a CSR plan the
    aggregation raises, with one it goes to the kernel wrappers (which refuse
    a device they cannot launch on)."""
    m = torch.empty(4, 8, device="meta")
    recv = torch.empty(4, dtype=torch.int32, device="meta")
    k = torch.empty(4, dtype=torch.bool, device="meta")
    b = torch.empty((), device="meta")
    with pytest.raises(ValueError, match="attach_csr_plan"):
        conv._softmax_aggr(m, recv, 2, b, k, rowptr=None)
    rowptr = torch.empty(3, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        conv._softmax_aggr(m, recv, 2, b, k, rowptr=rowptr)


def test_unported_conv_variants_raise():
    """Every conv variant of the reference is ported since the PNA slice
    (mean and max build, tests/test_torch_pna.py holds them to flax); an
    aggregation the reference does not know raises, naming it."""
    assert conv.PHMMessagePassing(32, 32, N4, aggr="mean", mlp=True).conv.aggr \
        == "mean"
    assert conv.PHMMessagePassing(32, 32, N4, aggr="max", mlp=False).conv.aggr \
        == "max"
    with pytest.raises(ValueError, match="'median'"):
        conv.PHMMessagePassing(32, 32, N4, aggr="median", mlp=False)
    with pytest.raises(ValueError, match="avg_deg"):
        conv.PHMMessagePassing(32, 32, N4, aggr="pna")


@pytest.mark.parametrize("kind", ["softattention", "globalsum"])
def test_pooling_matches(kind):
    jb, tb, x, _ = _graph_inputs(7)
    if kind == "globalsum":
        jm, tm = jpool.PHMGlobalSumPooling(phm_dim=N4), pooling.PHMGlobalSumPooling(N4)
    else:
        jm = jpool.PHMSoftAttentionPooling(embed_dim=32, phm_dim=N4)
        tm = pooling.PHMSoftAttentionPooling(32, N4)
    v = jm.init(jax.random.key(7), jnp.asarray(x), jb.graph_ids, jb.num_graphs,
                jb.node_mask)
    want = jm.apply(v, jnp.asarray(x), jb.graph_ids, jb.num_graphs, jb.node_mask)
    if v:
        load_flax(tm, v)
    got = tm(torch.from_numpy(x), tb.graph_ids, tb.num_graphs, tb.node_mask)
    assert_close(got, np.asarray(want), REL)


def test_downstream_eval_matches():
    jm = JDownstream(in_features=32, hidden_layers=(32, 16), out_features=1,
                     phm_dim=N4, norm="naive-batch-norm", dropout=(0.2, 0.1))
    x = _x(9, 32, seed=8)
    v = randomize(jm.init(jax.random.key(8), jnp.asarray(x), training=False), 8)
    tm = load_flax(PHMDownstreamNet(32, (32, 16), 1, N4, norm="naive-batch-norm"), v)
    assert_close(tm(torch.from_numpy(x)),
                 np.asarray(jm.apply(v, jnp.asarray(x), training=False)), REL)
