"""The port's composite route (``agg_kernel="xla"``) and the replicated
edge-partitioned scheme (parallel/edge_partition.py) against the JAX
package on the CPU.

JAX runs on the 8-device virtual CPU mesh of tests/conftest.py, under
``shard_map``; the port runs in gloo rank processes started with
``spawn`` (tests/torch_ranks.py, which imports no JAX), one an edge
shard, and the test process compares while they run.  Each world size
starts once in a pytest run (``torch_ranks.shared_ranks``): its ranks run
every case of the tests that need that size, in turn, whichever xdist
worker runs each test.  Sizes are those of
JAX's own edge-partition tests (tests/test_parallel.py): width 16, 2
layers, dropout off, ``synthetic_batch(6, 160, 382)`` (382 edges: 4
shards pad them to 384).  Tolerances, each beside its check:

- the composites over edge shards: JAX's ``REL_SHARD`` 1e-5 / ``ATOL_SHARD``
  1e-7 in float32 (test_parallel.py:168-169); the bf16 sum (bf16 partials,
  reduced in bf16 by gloo and by JAX's psum, each in its own order) within
  ``BF16_ULP`` 2^-7 of its largest entry, one bf16 rounding step, as
  tests/test_torch_bf16.py holds bf16 cotangents; ``E[m^2] - E[m]^2``
  cancels where a segment's var sits at rounding level, so the var within
  ``VAR_ATOL`` 1e-6 (two f32 ulps of ``E[m^2]``, at most ~4 here, in either
  summation order) and the std within ``KINK_FWD_ATOL`` 1e-4 (that rounding
  times d std / d var ~ 158 there), as tests/test_torch_pna_composite.py
  holds the std;
- the steps: JAX's ``REL_LOSS`` 1e-5 on the loss, ``REL_PARAM`` 5e-4 /
  ``ATOL_PARAM`` 1e-5 on the parameters after one SGD step
  (test_parallel.py:82-87), ``REL_STATS`` 1e-4 on the running stats,
  ``REL_OUT`` 1e-5 / ``ATOL_OUT`` 1e-6 on the evals (PNA's within
  ``REL_MODEL`` 1e-4 normwise, as tests/test_torch_pna.py holds its eval
  forward: the std's cancellation amplifies f32 rounding); the raw per-rank
  gradients apart by more than ``RAW_SPREAD`` 1e-3 while their mean is the
  single-device gradient within ``REL_GRAD`` 5e-4 / ``ATOL_GRAD`` 1e-6
  (test_parallel.py:131-139);
- the CLIs: each epoch's train loss within ``REL_TRAIN`` 1e-4, as
  tests/test_torch_trainer.py holds the Trainer (never two runs' eval
  metrics, ROADMAP.md section 3).
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import shard_map
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

from benchmarks import common as jcli
from phc_gnn_tpu.data import synthetic_batch as jax_synthetic_batch
from phc_gnn_tpu.graph import aggregators as jagg
from phc_gnn_tpu.graph import segment as jseg
from phc_gnn_tpu.models import PHCGNN as JaxPHCGNN
from phc_gnn_tpu.parallel import make_mesh as jax_make_mesh
from phc_gnn_tpu.parallel import partition_edges as jax_partition_edges
from phc_gnn_tpu.parallel import stack_batches as jax_stack_batches
from phc_gnn_tpu.parallel.edge_partition import (make_dp_ep_batch_specs,
                                                 make_dp_ep_eval_step,
                                                 make_dp_ep_train_step,
                                                 make_ep_eval_step,
                                                 make_ep_train_step)
from phc_gnn_torch import parallel as P
from phc_gnn_torch.cli import common as tcli
from phc_gnn_torch.data import ZINC_ATOM_DIMS, ZINC_BOND_DIMS, synthetic_batch
from phc_gnn_torch.graph import attach_csr_plan
from phc_gnn_torch.models import PHCGNN
from phc_gnn_torch.train import (make_accum_train_step, make_loss_and_grads,
                                 make_train_step)
import torch_ranks
from test_torch_dp import _init_pickle, _rows
from test_torch_halo import (J_ATOM, J_BOND, MODEL, _jax_loss, _jax_state,
                             _jax_variables, _port_state)
from torch_parity import assert_close, assert_leaf_close, numpy_tree
from torch_ranks import shared_ranks
from torch_threads import one_torch_thread  # noqa: F401

REL_SHARD, ATOL_SHARD = 1e-5, 1e-7
BF16_ULP = 2.0 ** -7
VAR_ATOL = 1e-6
KINK_FWD_ATOL = 1e-4
REL_LOSS = 1e-5
REL_PARAM, ATOL_PARAM = 5e-4, 1e-5
REL_STATS, ATOL_STATS = 1e-4, 1e-6
REL_OUT, ATOL_OUT = 1e-5, 1e-6
REL_MODEL = 1e-4
RAW_SPREAD = 1e-3
REL_GRAD, ATOL_GRAD = 5e-4, 1e-6
REL_TRAIN = 1e-4
LR = 1e-3
SHAPE = (6, 160, 382)
COMPOSITES = dict(seed=0, edges=96, nodes=20, dim=4)
PNA_DEG = {"lin": 2.4, "log": 1.1}
PNA_OVER = dict(msg_aggr="pna", mlp_mp=False, sc_type="last",
                avg_deg=PNA_DEG)


@pytest.fixture(scope="session")
def shared_dir(tmp_path_factory):
    """A directory that every xdist worker of the pytest run shares (the
    run's own where there are no workers)."""
    base = tmp_path_factory.getbasetemp()
    return str(base.parent if os.environ.get("PYTEST_XDIST_WORKER")
               else base)


def _world_cases(world):
    """The cases of ``world`` ranks, in their order: the composites, then
    on 2 ranks the ep step and PNA's eval under the scheme, on 4 the
    dp x ep step; last the np step whose bytes
    tests/test_torch_comm_model.py counts."""
    from test_torch_comm_model import count_spec
    if world == 4:
        return {"cases": [("composites", COMPOSITES),
                          ("replicated", _spec([1, 2], (2, 2))),
                          ("count_np_step", count_spec())]}
    spec, pna_spec = _ep_specs()
    return {"cases": [("composites", COMPOSITES), ("replicated", spec),
                      ("replicated", pna_spec),
                      ("count_np_step", count_spec())]}


def _ranks(shared_dir, world):
    """The one start of ``world`` ranks in the pytest run (``_world_cases``),
    shared with tests/test_torch_comm_model.py: a function that waits for
    each rank's case results."""
    return shared_ranks(shared_dir, f"ranks_{world}", "cases", world,
                        lambda: _world_cases(world))


def _close(got, want, rel, atol, name):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rel,
                               atol=atol, err_msg=name)


@pytest.mark.parametrize("shards", [2, 4])
def test_partition_edges_and_shards_match_jax(shards):
    """``partition_edges`` bit-equal to JAX's (382 edges round up to a
    multiple of the shards, the padding edges masked and pointing at the
    last node, the CSR plans stripped); ``edge_shard`` is JAX's
    ``edge_partition_specs`` split: slice e of the edge arrays, every node
    array whole."""
    jb = jax_partition_edges(jax_synthetic_batch(*SHAPE, seed=1), shards)
    tb = attach_csr_plan(synthetic_batch(*SHAPE, seed=1))
    got = P.partition_edges(tb, shards)
    assert got.rowptr is None and got.snd_perm is None
    assert got.num_edges == jb.senders.shape[0] == -(-382 // shards) * shards
    for name, t in got.tensors():
        np.testing.assert_array_equal(t.numpy(), np.asarray(getattr(jb, name)),
                                      err_msg=name)
    assert not got.edge_mask[382:].any()
    assert (got.senders[382:] == SHAPE[1] - 1).all()
    per = got.num_edges // shards
    for e in range(shards):
        shard = P.edge_shard(tb, shards, e)
        for name, t in shard.tensors():
            whole = getattr(got, name)
            want = (whole[e * per:(e + 1) * per]
                    if name in P.edge_partition.EDGE_FIELDS else whole)
            np.testing.assert_array_equal(t.numpy(), want.numpy(),
                                          err_msg=f"shard {e}: {name}")
    with pytest.raises(ValueError, match="edge shard"):
        P.edge_shard(tb, shards, shards)


def _jax_composites(world):
    """The composites of ``torch_ranks.composites`` under JAX's
    ``shard_map`` over ``world`` devices, edge arrays split over ep."""
    data = torch_ranks.composite_inputs(COMPOSITES)
    n = COMPOSITES["nodes"]
    mesh = jax_make_mesh(dp=1, ep=world)
    edge_keys = ("softmax_dm", "softmax_dbeta", "softmax_weights")

    def local(m, logits, recv, mask, w):
        out = {}
        for dt, name in ((jnp.float32, "float32"), (jnp.bfloat16, "bfloat16")):
            mm = m.astype(dt)
            for agg in (jagg.AGGREGATORS if name == "float32" else ("sum",)):
                out[f"{agg}/{name}"] = jagg.AGGREGATORS[agg](
                    mm, recv, n, mask, axis_name="ep")
            out[f"softmax_aggregate/{name}"] = jagg.softmax_aggregate(
                mm, recv, n, jnp.float32(0.7), mask, axis_name="ep")

        def f(m, beta):
            y = jagg.softmax_aggregate(m, recv, n, beta, mask,
                                       axis_name="ep")
            return (y * w).sum()

        out["softmax_dm"], db = jax.grad(f, argnums=(0, 1))(
            m, jnp.float32(0.7))
        out["softmax_dbeta"] = db[None]
        out["softmax_weights"] = jseg.segment_softmax_weights(
            logits, recv, n, mask, axis_name="ep")
        out["degrees"] = jagg.node_degrees(recv, n, mask, axis_name="ep")
        return out

    keys = [f"{a}/float32" for a in jagg.AGGREGATORS] + [
        "sum/bfloat16", "softmax_aggregate/float32",
        "softmax_aggregate/bfloat16", "degrees", *edge_keys]
    specs = {k: JP("ep") if k in edge_keys else JP() for k in keys}
    # jitted: an eager shard_map dispatches op by op, ~40 s here
    out = jax.jit(shard_map(local, mesh=mesh,
                            in_specs=(JP("ep"),) * 4 + (JP(),),
                            out_specs=specs, check_vma=False))(
        jnp.asarray(data["m"]), jnp.asarray(data["logits"]),
        jnp.asarray(data["recv"]), jnp.asarray(data["mask"]),
        jnp.asarray(data["w"]))
    return {k: np.asarray(v.astype(jnp.float32)) for k, v in out.items()}


def test_composites_over_edge_shards_match_jax(shared_dir):
    """graph/segment.py's and graph/aggregators.py's composites with
    ``axis_name`` on 2 and 4 gloo ranks (one start each, together) against
    JAX's same functions under ``shard_map`` on 2 and 4 devices: the sum,
    mean, max, min, var and std, the degrees, ``segment_softmax_weights``
    and ``softmax_aggregate`` with its per-rank gradients in the messages
    and beta (each rank's raw gradient, the psum transposed to a psum on
    both sides), in float32; the sum and the softmax aggregate on bf16
    messages too (gloo reduces the bf16 sum in bf16; the softmax promotes
    to float32; its bf16 cotangent is not compared: JAX rounds it to bf16
    on each of its two paths and adds in bf16, the port rounds once); the
    max's backward over the axis raises, as JAX's pmax has no derivative.
    Each rank's node arrays are equal, and equal to the unsharded
    composites."""
    from phc_gnn_torch.graph import aggregators as agg
    runs = {w: _ranks(shared_dir, w) for w in (2, 4)}
    wants = {w: _jax_composites(w) for w in runs}
    data = torch_ranks.composite_inputs(COMPOSITES)
    whole = agg.AGGREGATORS["mean"](
        torch.from_numpy(data["m"]), torch.from_numpy(data["recv"]),
        COMPOSITES["nodes"], torch.from_numpy(data["mask"]))
    for world, wait in runs.items():
        res, want = [r[0] for r in wait()], wants[world]
        for r in res:
            assert "Differentiation rule for 'pmax'" in r["max_backward"]
        for key, w in want.items():
            edge = key.startswith(("softmax_dm", "softmax_dbeta",
                                   "softmax_weights"))
            got = (np.concatenate([r[key].reshape((-1,) + w.shape[1:])
                                   for r in res]) if edge else res[0][key])
            if not edge:
                for r in res[1:]:
                    np.testing.assert_array_equal(r[key], got, err_msg=key)
            if key == "sum/bfloat16":
                assert_leaf_close(got, w, BF16_ULP, f"{world} ranks: {key}")
            elif key in ("var/float32", "std/float32"):
                _close(got, w, REL_SHARD, VAR_ATOL if key[0] == "v"
                       else KINK_FWD_ATOL, f"{world} ranks: {key}")
            else:
                _close(got, w, REL_SHARD, ATOL_SHARD, f"{world} ranks: {key}")
        _close(res[0]["mean/float32"], whole.numpy(), REL_SHARD, ATOL_SHARD,
               f"{world} ranks: the unsharded mean")


def _spec(seeds, mesh, **kw):
    model = dict(MODEL, norm_mp="naive-batch-norm",
                 atom_input_dims=tuple(J_ATOM), bond_input_dims=tuple(J_BOND))
    return dict(model=model, state=_port_state(model, _jax_variables()),
                opt="sgd", wd=0.1, lr=LR, shape=SHAPE, seeds=seeds,
                mesh=mesh, **kw)


def _jax_model(**over):
    return JaxPHCGNN(**{**MODEL, "norm_mp": "naive-batch-norm", **over},
                     atom_input_dims=J_ATOM, bond_input_dims=J_BOND)


def _port_grads(spec):
    """The port's single-device gradient of the whole batch on the
    composite route, numpy by parameter name."""
    model, _, loss_fn = torch_ranks.build(spec)
    model.set_composite(True)
    _, _, grads = make_loss_and_grads(model, loss_fn, spec["wd"])(
        torch_ranks.batches(spec)[0], spec["lr"])
    return {k: g.numpy() for k, g in grads.items()}


def _check_state(got, want, what):
    for k, w in want.items():
        buf = k.endswith((".mean", ".var", ".cov"))
        _close(got[k], w, REL_STATS if buf else REL_PARAM,
               ATOL_STATS if buf else ATOL_PARAM, f"{what}: {k}")


def _ep_specs():
    """The ep = 2 step's spec, and PNA's eval-only spec under the
    scheme."""
    spec = _spec([1], (1, 2))
    pna_model = dict(spec["model"], **PNA_OVER)
    return spec, dict(spec, model=pna_model,
                      state=_port_state(pna_model, _pna_variables()),
                      eval_only=True)


@functools.lru_cache(maxsize=None)
def _pna_variables():
    """JAX's initial variables of the test model with PNA aggregation."""
    jpna = _jax_model(**PNA_OVER)
    return numpy_tree(jax.jit(lambda k, b: jpna.init(k, b, training=False))(
        jax.random.key(0), jax_synthetic_batch(*SHAPE, seed=1)))


def test_ep_step_matches_jax_and_single_device(shared_dir):
    """ep = 2 (2 ranks, one edge shard each, one start): each rank's raw
    gradient differs from the other's by more than ``RAW_SPREAD`` while
    their mean is the single-device gradient (JAX's
    test_ep_pmean_grads_equal_single_device); one SGD step (weight decay
    0.1, naive BN) against JAX's ``make_ep_train_step`` on
    ``make_mesh(dp=1, ep=2)`` and against the port's single-device
    composite step, the loss, every parameter and running stat; the eval
    after it against JAX's ``make_ep_eval_step``; and PNA's eval under the
    scheme (its min and max over the axis, no derivative needed) against
    JAX's."""
    ranks = _ranks(shared_dir, 2)
    spec, pna_spec = _ep_specs()
    jb = jax_synthetic_batch(*SHAPE, seed=1)
    tx = optax.chain(optax.scale(-1.0))
    mesh = jax_make_mesh(dp=1, ep=2)
    part = jax_partition_edges(jb, 2)
    jm = _jax_model(edge_axis="ep")
    new, loss, _ = make_ep_train_step(jm, tx, _jax_loss, mesh,
                                      weight_decay=0.1, donate=False)(
        _jax_state(_jax_variables(), tx), part, jnp.float32(LR))
    jeval = np.asarray(make_ep_eval_step(jm, mesh)(new, part))
    want = _port_state(spec["model"], numpy_tree(
        {"params": new.params, "batch_stats": new.batch_stats}))
    jpna_eval = np.asarray(make_ep_eval_step(
        _jax_model(edge_axis="ep", **PNA_OVER), mesh)(
        _jax_state(_pna_variables(), tx), part))
    single = _port_grads(spec)
    res = [r[1:] for r in ranks()]
    steps = [r[0] for r in res]
    for r in steps[1:]:
        for k in r["state"]:
            np.testing.assert_array_equal(r["state"][k], steps[0]["state"][k])
    spread = max(float(np.abs(steps[0]["raw"][k] - steps[1]["raw"][k]).max())
                 for k in single)
    assert spread > RAW_SPREAD, spread
    for k, g in single.items():
        _close(np.mean([r["raw"][k] for r in steps], axis=0), g, REL_GRAD,
               ATOL_GRAD, f"raw gradient mean: {k}")
    _close(steps[0]["losses"][0], float(loss), REL_LOSS, 0.0, "jax: loss")
    _check_state(steps[0]["state"], want, "jax")
    _close(steps[0]["eval"], jeval, REL_OUT, ATOL_OUT, "jax: eval")
    assert_close(res[0][1]["eval"], jpna_eval, REL_MODEL)
    np.testing.assert_array_equal(res[0][1]["eval"], res[1][1]["eval"])

    model, opt, loss_fn = torch_ranks.build(spec)
    model.set_composite(True)
    loss1, _ = make_train_step(model, opt, loss_fn, weight_decay=0.1,
                               device="cpu")(torch_ranks.batches(spec)[0], LR)
    _close(steps[0]["losses"][0], float(loss1), REL_LOSS, 0.0, "single: loss")
    _check_state(steps[0]["state"], {k: v.numpy() for k, v in
                                     model.state_dict().items()}, "single")


def test_dp_ep_step_matches_jax_and_the_weighted_union(shared_dir):
    """dp = 2 x ep = 2 (4 ranks): two batches, each over 2 edge shards, one
    SGD step and the dp x ep eval, against JAX's ``make_dp_ep_train_step``
    and ``make_dp_ep_eval_step`` on ``make_mesh(dp=2, ep=2)``, and against
    the port's accumulated step over the two whole batches on the
    composite route (the same load-weighted gradient and node-weighted
    running stats); every rank's state equal."""
    ranks = _ranks(shared_dir, 4)
    spec = _spec([1, 2], (2, 2))
    tx = optax.chain(optax.scale(-1.0))
    mesh = jax_make_mesh(dp=2, ep=2)
    stacked = jax_stack_batches([jax_partition_edges(
        jax_synthetic_batch(*SHAPE, seed=s), 2) for s in (1, 2)])
    stacked = jax.tree_util.tree_map(
        lambda x, sp: jax.device_put(x, NamedSharding(mesh, sp)), stacked,
        make_dp_ep_batch_specs())
    jm = _jax_model(edge_axis="ep")
    new, loss, _ = make_dp_ep_train_step(jm, tx, _jax_loss, mesh,
                                         weight_decay=0.1, donate=False)(
        _jax_state(_jax_variables(), tx), stacked, jnp.float32(LR))
    jeval = np.asarray(make_dp_ep_eval_step(jm, mesh)(new, stacked))
    want = _port_state(spec["model"], numpy_tree(
        {"params": new.params, "batch_stats": new.batch_stats}))
    res = [r[1] for r in ranks()]
    for r in res[1:]:
        for k in r["state"]:
            np.testing.assert_array_equal(r["state"][k], res[0]["state"][k])
    _close(res[0]["losses"][0], float(loss), REL_LOSS, 0.0, "jax: loss")
    _check_state(res[0]["state"], want, "jax")
    _close(res[0]["eval"], jeval, REL_OUT, ATOL_OUT, "jax: eval")

    model, opt, loss_fn = torch_ranks.build(spec)
    model.set_composite(True)
    loss1, _ = make_accum_train_step(model, opt, loss_fn, weight_decay=0.1,
                                     device="cpu")(
        torch_ranks.batches(spec), LR)
    _close(res[0]["losses"][0], float(loss1), REL_LOSS, 0.0, "union: loss")
    _check_state(res[0]["state"], {k: v.numpy() for k, v in
                                   model.state_dict().items()}, "union")


def test_trainer_replicated_on_dp2_ep2_matches_jax(tmp_path, monkeypatch):
    """``python -m phc_gnn_torch.cli.train zinc --dp 2 --ep 2 --ep_scheme
    replicated --device cpu`` (4 gloo ranks that the CLI starts, a thread
    each: they inherit ``OMP_NUM_THREADS``) against JAX's CLI on its (2, 2)
    mesh, both from one ``init_from`` pickle, 2 epochs of tests/fixtures'
    ZINC: each epoch's train loss."""
    from test_torch_trainer import NO_DROPOUT, SMALL
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    argv = SMALL + NO_DROPOUT + ["--epochs", "2", "--dp", "2", "--ep", "2",
                                 "--ep_scheme", "replicated",
                                 "--init_from", _init_pickle(tmp_path)]
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    tcli.run_benchmark("zinc", argv + ["--save_dir", tdir, "--device", "cpu"])
    jcli.run_benchmark("zinc", argv + ["--save_dir", jdir])
    got, want = _rows(tdir), _rows(jdir)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g["epoch"] == w["epoch"]
        _close(g["train_loss"], w["train_loss"], REL_TRAIN, 0.0,
               f"epoch {g['epoch']}")


def test_cli_agg_kernel_xla_matches_jax(tmp_path):
    """``--agg_kernel xla`` on both sides (the port's composite route:
    the model reads no plan, the loaders build none), one ``init_from``
    pickle, 2 epochs of tests/fixtures' ZINC on one device: each epoch's
    train loss; the run's model is on the composite route."""
    from test_torch_trainer import NO_DROPOUT, SMALL
    argv = SMALL + NO_DROPOUT + ["--epochs", "2", "--agg_kernel", "xla",
                                 "--init_from", _init_pickle(tmp_path)]
    tdir, jdir = str(tmp_path / "torch"), str(tmp_path / "jax")
    targs = argv + ["--save_dir", tdir, "--device", "cpu"]
    trainer = tcli.build_trainer("zinc", tcli.get_parser("zinc").parse_args(
        targs))
    assert trainer.model.composite
    assert next(iter(trainer.train_batches(0))).rowptr is None
    tcli.run_benchmark("zinc", targs)
    jcli.run_benchmark("zinc", argv + ["--save_dir", jdir])
    got, want = _rows(tdir), _rows(jdir)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _close(g["train_loss"], w["train_loss"], REL_TRAIN, 0.0,
               f"epoch {g['epoch']}")
    with open(os.path.join(tdir, "params.json")) as f:
        assert json.load(f)["agg_kernel"] == "xla"


def test_default_route_off_the_cpu_without_a_plan_raises():
    """A batch on a device other than the CPU (here ``meta``) with no CSR
    plan raises on the default route, in the gather's backward, the
    softmax and a fixed aggregation; the composite route, asked for with
    ``set_composite`` (or ``edge_axis``), runs it."""
    kw = dict(MODEL, atom_input_dims=ZINC_ATOM_DIMS,
              bond_input_dims=ZINC_BOND_DIMS, device="cpu")
    batch = synthetic_batch(*SHAPE, seed=1).to("meta")
    for over, match in (({}, "softmax aggregation"),
                        ({"msg_aggr": "sum"}, "sum aggregation")):
        model = PHCGNN(**{**kw, **over}).to("meta")
        with pytest.raises(ValueError, match="sender plan"):
            model(batch)
        with torch.no_grad(), pytest.raises(ValueError, match=match):
            model(batch)
        out = model.set_composite(True)(batch)
        assert out.device.type == "meta" and out.shape == (SHAPE[0] + 1, 1)
        model.set_composite(False).set_edge_axis("ep")
        with P.mesh.bind(P.make_mesh(1, 1)):
            assert model(batch).shape == (SHAPE[0] + 1, 1)
