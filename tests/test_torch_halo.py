"""The port's node-sharded halo path (parallel/halo.py, kernel C's halo role,
the cross-shard norms and pooling) against the JAX package's on the CPU.

JAX runs on the 8-device virtual CPU mesh of tests/conftest.py; the port
runs in gloo rank processes started with ``spawn`` (tests/torch_ranks.py,
which imports no JAX), one a shard, and the test process compares.  The
weights go from JAX's variables to the port with
``convert.from_flax_variables``.  Sizes are those of JAX's own halo tests
(tests/test_halo_partition.py:117-147): ``synthetic_batch(6, 160, 384)``,
width 16, 2 layers, dropout off.  The tolerances are JAX's halo tests':
``REL_LOSS`` 1e-5 on the loss, ``REL_PARAM`` 5e-4 with ``ATOL_PARAM``
1e-5 on the parameters, ``REL_STATS`` 1e-4 on the running stats, and
``REL_OUT`` 1e-5 / ``ATOL_OUT`` 1e-6 on the eval outputs.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from phc_gnn_tpu.data import ZINC_ATOM_DIMS as J_ATOM
from phc_gnn_tpu.data import ZINC_BOND_DIMS as J_BOND
from phc_gnn_tpu.data import synthetic_batch as jax_synthetic_batch
from phc_gnn_tpu.models import PHCGNN as JaxPHCGNN
from phc_gnn_tpu.ops.stream_scan import halo_gather_split_streamed
from phc_gnn_tpu.parallel import make_mesh as jax_make_mesh
from phc_gnn_tpu.parallel.halo import SlotOverflow as JaxSlotOverflow
from phc_gnn_tpu.parallel.halo import make_np_eval_step as jax_np_eval_step
from phc_gnn_tpu.parallel.halo import make_np_train_step as jax_np_train_step
from phc_gnn_tpu.parallel.halo import partition_nodes as jax_partition_nodes
from phc_gnn_tpu.train import make_optimizer as jax_make_optimizer
from phc_gnn_tpu.train.loss import masked_l1 as jax_masked_l1
from phc_gnn_tpu.train.state import TrainState
from phc_gnn_torch import parallel as P
from phc_gnn_torch.convert import from_flax_variables
from phc_gnn_torch.data import ZINC_ATOM_DIMS, ZINC_BOND_DIMS, synthetic_batch
from phc_gnn_torch.graph import attach_csr_plan
from phc_gnn_torch.models import PHCGNN
from phc_gnn_torch.ops.segment_sum import halo_gather_split
from torch_parity import numpy_tree, randomize, spd_cov
from torch_ranks import run_ranks, start_ranks
from torch_threads import one_torch_thread  # noqa: F401

REL_LOSS = 1e-5
REL_PARAM, ATOL_PARAM = 5e-4, 1e-5
REL_STATS, ATOL_STATS = 1e-4, 1e-5
REL_OUT, ATOL_OUT = 1e-5, 1e-6
REL_GATHER = 1e-6  # the halo gather's backward: float32 sums in two orders
SHAPE = (6, 160, 384)
LR = 1e-3
S = 2

MODEL = dict(phm_dim=4, atom_encoded_dim=16, mp_layers=(16, 16),
             dropout_mpnn=(0.0, 0.0), downstream_layers=(16, 8), target_dim=1,
             dropout_dn=(0.0, 0.0), msg_aggr="softmax", mlp_mp=True)
FIELDS = ("nodes", "edges", "senders", "receivers", "graph_ids", "node_mask",
          "edge_mask", "graph_mask", "y", "halo_send")


def _jax_loss(out, batch):
    return jax_masked_l1(out, batch.y)


@functools.lru_cache(maxsize=None)
def _jax_variables(seed: int = 3):
    """JAX's initial variables of the test model with naive BN, as numpy,
    with random running stats and softmax betas (``randomize``)."""
    jm = JaxPHCGNN(**MODEL, norm_mp="naive-batch-norm",
                   atom_input_dims=J_ATOM, bond_input_dims=J_BOND)
    # one jitted init compiles in a third of the eager init's time
    return randomize(numpy_tree(jax.jit(
        lambda key, b: jm.init(key, b, training=False))(
        jax.random.key(0), jax_synthetic_batch(*SHAPE, seed=1))), seed=seed)


def _jax_state(v, tx):
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    return TrainState(
        params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray, v["batch_stats"]),
        opt_state=tx.init(params), rng=jax.random.key(1),
        step=jnp.zeros((), jnp.int32))


def _port_state(kw, variables):
    model = PHCGNN(**kw, device="cpu")
    return {k: v.numpy() for k, v in
            from_flax_variables(variables, model).items()}


def stack_shards(shards):
    """The shards' arrays stacked on a leading S axis, as numpy, keyed by
    field (JAX's stacked layout; ``graph_mask`` and ``y`` once)."""
    return {name: (t.numpy() if name in ("graph_mask", "y") else
                   np.stack([getattr(s, name).numpy() for s in shards]))
            for name, t in shards[0].tensors()}


def _close(got, want, rel, atol, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rel, atol=atol, err_msg=name)


@pytest.mark.parametrize("shards", [2, 4])
def test_partition_nodes_bit_equal_to_jax(shards):
    """Every per-shard array, natural and at fixed slot rungs, bit for bit
    JAX's; each shard's CSR plans cover its real edges, the sender plan
    its ``NS + S*H`` augmented rows."""
    jb = jax_synthetic_batch(*SHAPE, seed=1)
    tb = synthetic_batch(*SHAPE, seed=1)
    for slots in ({}, {"edge_slots": 512, "halo_slots": 64}):
        want = jax_partition_nodes(jb, shards, **slots)
        shards_t = P.partition_nodes(tb, shards, **slots)
        got = stack_shards(shards_t)
        for f in FIELDS:
            w = np.asarray(getattr(want, f))
            assert got[f].dtype == w.dtype and got[f].shape == w.shape, f
            np.testing.assert_array_equal(got[f], w, err_msg=f)
        ns, h = want.nodes.shape[1], want.halo_send.shape[2]
        for s, shard in enumerate(shards_t):
            real = int(shard.edge_mask.sum())
            assert shard.rowptr.shape[0] == ns + 1
            assert shard.snd_rowptr.shape[0] == ns + shards * h + 1
            assert int(shard.rowptr[-1]) == int(shard.snd_rowptr[-1]) == real


def test_slot_overflow_matches_jax():
    """Undersized rungs raise ``SlotOverflow`` with JAX's needed sizes."""
    jb = jax_synthetic_batch(8, 256, 512, seed=3)
    tb = synthetic_batch(8, 256, 512, seed=3)
    with pytest.raises(JaxSlotOverflow) as want:
        jax_partition_nodes(jb, 2, edge_slots=128, halo_slots=8)
    with pytest.raises(P.SlotOverflow) as got:
        P.partition_nodes(tb, 2, edge_slots=128, halo_slots=8)
    assert (got.value.needed_edge_slots, got.value.needed_halo_slots) == (
        want.value.needed_edge_slots, want.value.needed_halo_slots)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_halo_gather_split_matches_jax(dtype):
    """``halo_gather_split`` (its plain versions on the CPU) against JAX's
    ``halo_gather_split_streamed`` in interpret mode, on shard 1 of 2:
    the gather, and the backward's local and halo cotangents (JAX sums in
    float32 and casts to ``x``'s dtype, as the port does)."""
    jb = jax_synthetic_batch(*SHAPE, seed=1)
    jpart = jax_partition_nodes(jb, S, scan_plan=True, scan_block=128)
    shard = P.partition_nodes(synthetic_batch(*SHAPE, seed=1), S)[1]
    ns, rows = shard.num_nodes, shard.snd_rowptr.shape[0] - 1
    rng = np.random.default_rng(0)
    x = rng.normal(size=(ns, 12)).astype(np.float32)
    xr = rng.normal(size=(rows - ns, 12)).astype(np.float32)
    g = rng.normal(size=(shard.num_edges, 12)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    plan = [jpart.snd_perm[1], jpart.snd_flags[1], jpart.snd_cont[1],
            jpart.snd_last[1]]

    def f(a, b):
        return halo_gather_split_streamed(a, b, jpart.senders[1], *plan,
                                          interpret=True)

    jx, jxr = jnp.asarray(x, jdt), jnp.asarray(xr, jdt)
    want, vjp = jax.vjp(f, jx, jxr)
    want_dx, want_dxr = vjp(jnp.asarray(g, jdt))
    tdt = getattr(torch, dtype)
    tx = torch.tensor(x).to(tdt).requires_grad_()
    txr = torch.tensor(xr).to(tdt).requires_grad_()
    got = halo_gather_split(tx, txr, shard.senders, shard.snd_perm,
                            shard.snd_rowptr)
    got.backward(torch.tensor(g).to(tdt))
    assert got.dtype == tdt and tx.grad.dtype == tdt
    np.testing.assert_array_equal(got.detach().float().numpy(),
                                  np.asarray(want, np.float32))
    for t, w, name in ((tx.grad, want_dx, "dx"), (txr.grad, want_dxr, "dxr")):
        _close(t.float().numpy(), np.asarray(w, np.float32),
               REL_GATHER if dtype == "float32" else 2 ** -8, 1e-6, name)


def _port_init(kw, seed: int = 3):
    """The port's own initial state of the test model, with a random well
    conditioned running covariance in each whitening norm, as numpy."""
    rng = np.random.default_rng(seed)
    state = {k: v.numpy().copy() for k, v in
             PHCGNN(**kw, device="cpu").state_dict().items()}
    return {k: spd_cov(rng, v.shape[-1]) if k.endswith(".cov") else v
            for k, v in state.items()}


def _jax_np_step(norm_mp, opt, jax_too: bool = True):
    """The spec of the np step on 2 shards for the port's ranks and, with
    ``jax_too``, JAX's same step on ``make_mesh(dp=1, ep=2)`` from
    ``_jax_variables()`` (with, under SGD, its np eval after it);
    without, the port's own initial state."""
    kw = dict(MODEL, norm_mp=norm_mp)
    port_kw = dict(kw, atom_input_dims=tuple(ZINC_ATOM_DIMS),
                   bond_input_dims=tuple(ZINC_BOND_DIMS))
    spec = dict(model=port_kw, opt=opt, clip=2.0, wd=0.1, lr=LR,
                shape=SHAPE, seeds=[1], mesh=(1, S))
    if not jax_too:
        return dict(spec, state=_port_init(port_kw)), None
    jm_np = JaxPHCGNN(**kw, atom_input_dims=J_ATOM, bond_input_dims=J_BOND,
                      node_axis="ep")
    tx = (optax.chain(optax.scale(-1.0)) if opt == "sgd"
          else jax_make_optimizer(LR, grad_clip=2.0))
    jb = jax_synthetic_batch(*SHAPE, seed=1)
    v = _jax_variables()
    kw = port_kw
    spec["state"] = _port_state(kw, v)

    def run():
        mesh = jax_make_mesh(dp=1, ep=S)
        part = jax_partition_nodes(jb, S)
        step = jax_np_train_step(jm_np, tx, _jax_loss, mesh,
                                 weight_decay=0.1, donate=False)
        new, loss, _ = step(_jax_state(v, tx), part, jnp.float32(LR))
        out_eval = (jax_np_eval_step(jm_np, mesh)(new, part) if opt == "sgd"
                    else None)
        return dict(loss=float(loss), eval=out_eval,
                    state=_port_state(kw, numpy_tree(
                        {"params": new.params,
                         "batch_stats": new.batch_stats})))

    return spec, run


def _single_device(spec):
    """The port's single-device step on the union batch, then its eval."""
    import torch_ranks
    from phc_gnn_torch.train import make_eval_step, make_train_step
    model, opt, loss_fn = torch_ranks.build(spec)
    batch = torch_ranks.batches(spec)[0]
    step = make_train_step(model, opt, loss_fn, weight_decay=spec["wd"],
                           device="cpu")
    loss, _ = step(batch, spec["lr"])
    out = make_eval_step(model, device="cpu")(batch)
    return dict(loss=float(loss), eval=out.numpy(),
                state={k: v.detach().numpy() for k, v in
                       model.state_dict().items()})


def bn_followed(key: str) -> bool:
    """The biases that a batch norm follows (test_torch_train.py's rule):
    their exact gradient is 0, so both frameworks' are rounding noise,
    which Adam turns into steps of up to lr (ROADMAP.md, section 3)."""
    return key.endswith(("transform.linear1.b", "transform.linear2.b")) or (
        key.startswith("downstream.affine_") and key.endswith(".b")
        and key != "downstream.affine_2.b")


def _check_against(got, want, what, start=None):
    """``got`` (rank 0's) against ``want``; with ``start`` (Adam) the
    batch-norm-followed biases are held to Adam's bound on one step,
    ``|p - p0| <= lr``, instead of to each other, and the eval outputs,
    which those biases move, are not compared (the SGD case holds the np
    eval)."""
    _close(got["losses"][0], want["loss"], REL_LOSS, 0.0, f"{what}: loss")
    for k, w in want["state"].items():
        if start is not None and bn_followed(k):
            assert np.abs(got["state"][k] - start[k]).max() <= LR * 1.001, k
            continue
        buf = k.endswith((".mean", ".var", ".cov"))
        rel, atol = (REL_STATS, ATOL_STATS) if buf else (REL_PARAM, ATOL_PARAM)
        _close(got["state"][k], w, rel, atol, f"{what}: {k}")
    if start is None:
        _close(got["eval"], want["eval"], REL_OUT, ATOL_OUT, f"{what}: eval")


# (norm, optimizer, held to JAX too): the quaternion step is held to the
# port's single-device step, which tests/test_torch_quat.py holds to JAX
CASES = (("naive-batch-norm", "sgd", True), ("naive-batch-norm", "adam", True),
         ("q-batch-norm", "sgd", False))


def test_np_steps_and_the_exchange_match_jax_and_union():
    """Two ranks, one a shard, started once for every check (a start costs
    seconds of imports a rank):

    - ``halo_exchange``: shard s's block t is shard t's rows
      ``halo_send[s]``, and its backward adds each peer's cotangent into
      the rows sent to it;
    - the np step (weight decay 0.1) with naive BN, its statistics over
      both shards, under SGD (JAX's halo tests' optimizer) and under Adam
      with the clip: the loss, every parameter and running stat, and the
      np eval after it, against JAX's ``make_np_train_step`` and
      ``make_np_eval_step`` on ``make_mesh(dp=1, ep=2)`` and against the
      port's single-device step on the union batch; with the quaternion
      whitening norm (psums of component-slice sums, the inline
      whitening) under SGD against the port's single-device step; the two
      ranks' states equal."""
    steps = [_jax_np_step(*case) for case in CASES]
    ranks = start_ranks("cases", S, {"cases": [
        ("halo_roundtrip", {"shape": (8, 256, 512)})]
        + [("grid_steps", spec) for spec, _ in steps]})
    # JAX works while the ranks run
    wants = [run() if run is not None else None for _, run in steps]
    res = ranks()

    ex = [r[0] for r in res]
    h = ex[0]["halo_send"].shape[1]
    for s, r in enumerate(ex):
        for t in range(S):
            want = ex[t]["x"][ex[t]["halo_send"][s]]
            np.testing.assert_array_equal(r["got"][t * h:(t + 1) * h], want)
        dx = np.zeros_like(r["x"], np.float64)
        for t in range(S):
            np.add.at(dx, r["halo_send"][t], ex[t]["w"][s * h:(s + 1) * h])
        _close(r["dx"], dx, 1e-6, 1e-6, f"dx of shard {s}")

    for i, ((norm, opt, _), (spec, _), want) in enumerate(zip(CASES, steps,
                                                               wants)):
        got = [r[i + 1] for r in res]
        for k in got[0]["state"]:
            np.testing.assert_array_equal(got[0]["state"][k],
                                          got[1]["state"][k])
        assert got[0]["losses"] == got[1]["losses"]
        start = spec["state"] if opt == "adam" else None
        if want is not None:
            _check_against(got[0], want, f"{norm} {opt}: jax", start)
        _check_against(got[0], _single_device(spec),
                       f"{norm} {opt}: single device", start)


def test_axes_that_are_not_ported_raise():
    """``node_axis`` builds, and so does ``edge_axis`` (the replicated
    scheme) since its slice: outside a step's mesh its collectives raise,
    and on a one-rank mesh its eval of one edge shard is JAX's eval of the
    batch (tests/test_torch_edge_partition.py holds it on ranks); a sharded
    norm outside a step's mesh raises."""
    kw = dict(MODEL, atom_input_dims=ZINC_ATOM_DIMS,
              bond_input_dims=ZINC_BOND_DIMS, device="cpu")
    ep_model = PHCGNN(**kw, edge_axis="ep")
    state = _port_state({k: v for k, v in kw.items() if k != "device"},
                        _jax_variables())
    ep_model.load_state_dict({k: torch.from_numpy(v)
                              for k, v in state.items()})
    edge_shard = P.edge_shard(synthetic_batch(*SHAPE, seed=1), 1, 0)
    with pytest.raises(RuntimeError, match="not bound"):
        ep_model(edge_shard)
    jm = JaxPHCGNN(**MODEL, atom_input_dims=J_ATOM, bond_input_dims=J_BOND)
    want = jm.apply(_jax_variables(), jax_synthetic_batch(*SHAPE, seed=1),
                    training=False)
    got = P.make_ep_eval_step(ep_model, P.make_mesh(1, 1), device="cpu")(
        edge_shard)
    _close(got.numpy(), np.asarray(want), REL_OUT, ATOL_OUT, "edge_axis eval")
    assert ep_model.set_edge_axis(None).edge_axis is None
    model = PHCGNN(**kw, node_axis="ep")
    shard = P.partition_nodes(synthetic_batch(*SHAPE, seed=1), S)[0]
    with pytest.raises(RuntimeError, match="not bound"):
        model(shard, training=True)
    assert model.set_node_axis(None).node_axis is None
    batch = attach_csr_plan(synthetic_batch(*SHAPE, seed=1))
    assert model(batch, training=True).shape == (SHAPE[0] + 1, 1)
