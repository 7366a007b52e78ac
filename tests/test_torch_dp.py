"""The port's load-weighted data parallelism (parallel/dp.py), the dp x ep
grid, the Trainer and the CLI on several ranks, against the JAX package
and the port's single-device steps on the CPU.

The ranks are gloo processes started with ``spawn`` (tests/torch_ranks.py,
which imports no JAX); JAX runs in the test process on the 8-device
virtual CPU mesh of tests/conftest.py.  Sizes are those of JAX's halo
tests: ``synthetic_batch(6, 160, 384)``, width 16, 2 layers, dropout off.
Tolerances, each beside its check: the rounding of a weighted mean of one
term, ``w g / w``, within ``REL_EXACT`` 1e-6; against JAX and against the
accumulated step, JAX's halo tests' ``REL_LOSS`` 1e-5 on the loss,
``REL_PARAM`` 5e-4 / ``ATOL_PARAM`` 1e-5 on the parameters, ``REL_STATS``
1e-4 on the running stats; the Trainer's epoch losses within
``REL_TRAIN`` 1e-4, as tests/test_torch_trainer.py holds the
single-device Trainer (three epochs of Adam).
"""

import concurrent.futures
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from benchmarks import common as jcli
from phc_gnn_tpu.data import synthetic_batch as jax_synthetic_batch
from phc_gnn_tpu.models import PHCGNN as JaxPHCGNN
from phc_gnn_tpu.parallel import make_mesh as jax_make_mesh
from phc_gnn_tpu.parallel import stack_batches as jax_stack_batches
from phc_gnn_tpu.parallel.halo import make_dp_np_batch_specs
from phc_gnn_tpu.parallel.halo import make_dp_np_eval_step as jax_dp_np_eval
from phc_gnn_tpu.parallel.halo import make_dp_np_train_step as jax_dp_np_step
from phc_gnn_tpu.parallel.halo import partition_nodes as jax_partition_nodes
from phc_gnn_torch import parallel as P
from phc_gnn_torch.cli import common as tcli
from phc_gnn_torch.models import PHCGNN
from phc_gnn_torch.parallel import mesh as mesh_lib
from phc_gnn_torch.train import make_accum_train_step, make_train_step
from phc_gnn_torch.train.config import ExperimentConfig
from phc_gnn_torch.train.trainer import Trainer
import torch_ranks
from test_torch_halo import (J_ATOM, J_BOND, MODEL, SHAPE, _jax_loss,
                             _jax_state, _jax_variables, _port_state)
from torch_parity import numpy_tree
from torch_ranks import run_ranks, start_ranks
from torch_threads import one_torch_thread  # noqa: F401

REL_EXACT = 1e-6
REL_LOSS = 1e-5
REL_PARAM, ATOL_PARAM = 5e-4, 1e-5
REL_STATS, ATOL_STATS = 1e-4, 1e-6
REL_OUT, ATOL_OUT = 1e-5, 1e-6
REL_TRAIN = 1e-4
LR = 1e-3
FIX = os.path.join(os.path.dirname(__file__), "fixtures")


def _spec(seeds, mesh, jax_init=True, **kw):
    """The ranks' spec: JAX's initial weights, or (``jax_init`` False, for
    checks without JAX) the port's own init from seed 0."""
    model = dict(MODEL, norm_mp="naive-batch-norm",
                 atom_input_dims=tuple(J_ATOM), bond_input_dims=tuple(J_BOND))
    state = (_port_state(model, _jax_variables())
             if jax_init else {k: v.numpy() for k, v in PHCGNN(
                 **model, device="cpu").state_dict().items()})
    return dict(model=model, state=state, opt="sgd", wd=0.1, lr=LR,
                shape=SHAPE, seeds=seeds, mesh=mesh, **kw)


def _close(got, want, rel, atol, name):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rel,
                               atol=atol, err_msg=name)


def _check_state(got, want, rel_p, atol_p, rel_s, atol_s, what):
    for k, w in want.items():
        buf = k.endswith((".mean", ".var", ".cov"))
        _close(got[k], w, rel_s if buf else rel_p, atol_s if buf else atol_p,
               f"{what}: {k}")


def test_dp_step_with_a_dummy_rank_is_the_single_device_step():
    """dp = 2, rank 1 on ``make_dummy_batch``'s fully masked batch: two
    scanned steps (``make_scan_dp_train_steps``) give rank 0's batch's
    single-device steps (loss, outputs, parameters, running stats) up to
    the rounding of ``w g / w``; the dummy's output slot is there, and both
    ranks hold the same state."""
    spec = _spec([1, None], (2, 1), jax_init=False, steps=2, scan=True)
    res = run_ranks("grid_steps", 2, spec)
    for k in res[0]["state"]:
        np.testing.assert_array_equal(res[0]["state"][k], res[1]["state"][k])
    model, opt, loss_fn = torch_ranks.build(spec)
    step = make_train_step(model, opt, loss_fn, weight_decay=spec["wd"],
                           device="cpu")
    batch = torch_ranks.batches(spec)[0]
    for t in range(2):
        loss, out = step(batch, LR)
        _close(res[0]["losses"][t], float(loss), REL_EXACT, 0.0, "loss")
        assert res[0]["outs"][t].shape == (2,) + tuple(out.shape)
        _close(res[0]["outs"][t][0], out.numpy(), REL_EXACT, 1e-7, "out")
    _check_state(res[0]["state"], {k: v.numpy() for k, v in
                                   model.state_dict().items()},
                 REL_EXACT, 1e-7, REL_EXACT, 1e-7, "single device")


def test_dp_ep_step_matches_jax_and_the_weighted_union():
    """dp = 2 x ep = 2 (4 ranks): two batches, each over 2 node shards, one
    SGD step and the dp x ep eval, against JAX's ``make_dp_np_train_step``
    and ``make_dp_np_eval_step`` on ``make_mesh(dp=2, ep=2)``, and against
    the port's accumulated step over the two whole batches (the same
    load-weighted gradient and node-weighted running stats)."""
    spec = _spec([1, 2], (2, 2))
    ranks = start_ranks("grid_steps", 4, spec)
    tx = optax.chain(optax.scale(-1.0))
    state = _jax_state(_jax_variables(), tx)
    jm = JaxPHCGNN(**MODEL, norm_mp="naive-batch-norm", node_axis="ep",
                   atom_input_dims=J_ATOM, bond_input_dims=J_BOND)
    mesh = jax_make_mesh(dp=2, ep=2)
    jbs = [jax_synthetic_batch(*SHAPE, seed=s) for s in (1, 2)]
    nat = [jax_partition_nodes(b, 2) for b in jbs]
    es = max(p.senders.shape[1] for p in nat)
    h = max(p.halo_send.shape[2] for p in nat)
    stacked = jax_stack_batches([jax_partition_nodes(b, 2, edge_slots=es,
                                                     halo_slots=h)
                                 for b in jbs])
    specs = make_dp_np_batch_specs()
    stacked = jax.tree_util.tree_map(
        lambda x, sp: jax.device_put(x, jax.sharding.NamedSharding(mesh, sp)),
        stacked, specs)
    new, loss, _ = jax_dp_np_step(jm, tx, _jax_loss, mesh, weight_decay=0.1,
                                  donate=False)(state, stacked,
                                                jnp.float32(LR))
    jeval = np.asarray(jax_dp_np_eval(jm, mesh)(new, stacked))
    want = _port_state(spec["model"], numpy_tree(
        {"params": new.params, "batch_stats": new.batch_stats}))
    res = ranks()
    for r in res[1:]:
        for k in r["state"]:
            np.testing.assert_array_equal(r["state"][k], res[0]["state"][k])
    _close(res[0]["losses"][0], float(loss), REL_LOSS, 0.0, "jax: loss")
    _check_state(res[0]["state"], want, REL_PARAM, ATOL_PARAM, REL_STATS,
                 ATOL_STATS, "jax")
    _close(res[0]["eval"], jeval, REL_OUT, ATOL_OUT, "jax: eval")

    model, opt, loss_fn = torch_ranks.build(spec)
    step = make_accum_train_step(model, opt, loss_fn, weight_decay=0.1,
                                 device="cpu")
    loss, _ = step(torch_ranks.batches(spec), LR)
    _close(res[0]["losses"][0], float(loss), REL_LOSS, 0.0, "union: loss")
    _check_state(res[0]["state"], {k: v.numpy() for k, v in
                                   model.state_dict().items()},
                 REL_PARAM, ATOL_PARAM, REL_STATS, ATOL_STATS, "union")


def _init_pickle(tmp_path):
    """test_torch_trainer.py's flax params pickle of its ZINC model, from
    one jitted init (a third of the eager init's time)."""
    from phc_gnn_tpu.data import ZINC_ATOM_DIMS, ZINC_BOND_DIMS
    from phc_gnn_tpu.train import build_model as jax_build_model
    from test_torch_trainer import NO_DROPOUT, SMALL
    cfg = jcli.config_from_args("zinc", jcli.get_parser("zinc").parse_args(
        SMALL + NO_DROPOUT))
    model = jax_build_model(cfg, ZINC_ATOM_DIMS, ZINC_BOND_DIMS)
    params = jax.jit(lambda key, b: model.init(key, b, training=False))(
        jax.random.key(0), jax_synthetic_batch(3, 256, 256, seed=0))["params"]
    path = str(tmp_path / "init.pkl")
    with open(path, "wb") as f:
        pickle.dump(numpy_tree(params), f)
    return path


def _rows(save_dir):
    with open(os.path.join(save_dir, "run_1", "scalars.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_trainer_on_dp2_ep2_matches_jax(tmp_path):
    """``python -m phc_gnn_torch.cli.train zinc --dp 2 --ep 2 --device cpu``
    (the CLI starts 4 gloo ranks) against JAX's CLI on its (2, 2) mesh, both
    from one ``init_from`` pickle, 2 epochs of tests/fixtures' ZINC (3
    batches an epoch: one full dp group and one padded with a dummy): each
    epoch's train loss; rank 0 alone wrote the run's files, one row an
    epoch."""
    from test_torch_trainer import NO_DROPOUT, SMALL
    argv = SMALL + NO_DROPOUT + ["--epochs", "2", "--dp", "2", "--ep", "2",
                                 "--init_from", _init_pickle(tmp_path)]
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        port = pool.submit(tcli.run_benchmark, "zinc",
                           argv + ["--save_dir", tdir, "--device", "cpu"])
        jcli.run_benchmark("zinc", argv + ["--save_dir", jdir])
        summary = port.result()
    got, want = _rows(tdir), _rows(jdir)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g["epoch"] == w["epoch"] and g["lr"] == w["lr"]
        _close(g["train_loss"], w["train_loss"], REL_TRAIN, 0.0,
               f"epoch {g['epoch']}")
    assert set(summary) == {"best_val", "test_bestval", "test_last"}
    with open(os.path.join(tdir, "run.log")) as f:
        assert f.read().count("epoch 1: train") == 1


def test_multi_rank_paths_that_refuse():
    """The replicated scheme, ported since its slice, gets as far as the
    halo scheme without a process group: its mesh needs one (its ranks
    are held to JAX's in tests/test_torch_edge_partition.py); another
    scheme raises naming the two; ``--device cuda`` with fewer cards than
    ranks raises and says so; a mesh of more than one rank needs a process
    group."""
    cfg = ExperimentConfig(dataset="zinc", ep=2, ep_scheme="replicated")
    model = PHCGNN(**_spec([1], (1, 2), jax_init=False)["model"],
                   device="cpu")
    with pytest.raises(RuntimeError, match="initialize"):
        Trainer(cfg, model, None, None, device="cpu")
    cfg.ep_scheme = "rows"
    with pytest.raises(ValueError, match="'halo' or 'replicated'"):
        Trainer(cfg, model, None, None, device="cpu")
    with pytest.raises(RuntimeError, match="need 2 GPUs"):
        tcli.run_benchmark("zinc", ["--dp", "2", "--data_root", FIX,
                                    "--device", "cuda"])
    with pytest.raises(RuntimeError, match="initialize"):
        P.make_mesh(2, 1, "gloo")


def test_one_rank_mesh_and_collectives():
    """At one rank no process group is needed: ``initialize`` is a no-op,
    the mesh is (1, 1), the collectives are identities, ``weighted_mean``
    of one term is the term."""
    assert P.initialize("gloo") == 1 and P.is_primary()
    mesh = P.make_mesh(1, 1)
    assert mesh.shape == (1, 1) and mesh.rank == 0 and mesh.size == 1
    x = torch.arange(6.0).view(3, 2).requires_grad_()
    assert mesh_lib.psum(x, mesh.ep) is x
    assert torch.equal(mesh_lib.all_to_all(x, mesh.ep), x)
    assert mesh_lib.all_gather(x, mesh.dp).shape == (1, 3, 2)
    got = P.weighted_mean([x.detach(), x.detach()[0]], torch.tensor(3.0),
                          mesh.dp)
    _close(got[0], x.detach(), REL_EXACT, 0.0, "weighted mean")
    with mesh_lib.bind(mesh):
        assert mesh_lib.axis("ep") is mesh.ep
    with pytest.raises(RuntimeError, match="not bound"):
        mesh_lib.axis("ep")
