"""The port's training harness (Trainer, checkpoints, evaluators, CLI)
against the JAX package's, on the CPU at fixture size.

The Trainer is held to JAX's ``Trainer`` on tests/fixtures' ZINC splits (8
train graphs in batches of 3, width 16, 2 layers, dropout 0, 3 epochs),
both sides started from ONE ``init_from`` pickle of flax params (their own
inits draw from different RNGs), on the plain path, the scanned one
(``scan_chunk`` 4) and the accumulated one (``grad_accum`` 2: the epoch's
3 batches make one full group and one padded with a dummy).  What the two
runs determine is held, not what rounding noise decides:

- each epoch's train loss within ``REL_TRAIN`` 1e-4 relative (measured up
  to 1.5e-6);
- after the 3 epochs every parameter within ``REL_PARAM`` 1e-3 of its
  leaf's largest entry (measured up to 4.8e-5 on the plain and scanned
  paths, 2.7e-4 on the accumulated one, both at a batch norm's ``bias``),
  except the biases whose exact gradient is 0 because a batch norm follows
  them: their gradients are rounding noise in both frameworks, which Adam
  turns into steps of +-lr, so the two runs' biases part by 1.2e-2 to
  3.5e-2 of the leaf.  They are found by that rule, from the port's
  float64 gradient on a train batch (at most 1e-10 of the largest leaf's,
  where the others' are above 1e-4 of it), not named;
- JAX's final state (its params and ``batch_stats``) and its best-epoch
  export, loaded into the port through ``convert.from_flax_variables``
  and evaluated by the port's Trainer on the valid and test splits, give
  JAX's ``valid_loss``, ``valid_metric``, ``test_last`` and
  ``test_bestval`` within ``REL_EVAL_STATE`` 1e-5 relative (measured up to
  7.4e-7).

The eval metrics of the two runs are not compared with each other: the
drifted biases shift the eval outputs where the running means absorb them
only in part (measured 2.6e-3 to 2.5e-2 apart), while with ``--lr 1e-9``
the two runs' evals agree to 5.4e-7.
"""

import json
import os
import pickle

import jax
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from benchmarks import common as jcli
from phc_gnn_tpu.data import ZINC_ATOM_DIMS, ZINC_BOND_DIMS
from phc_gnn_tpu.data import synthetic_batch as jax_synthetic_batch
from phc_gnn_tpu.train import build_model as jax_build_model
from phc_gnn_tpu.train import evaluators as jev
from phc_gnn_tpu.utils import oversmoothing as jos
from phc_gnn_torch.cli import common as tcli
from phc_gnn_torch.cli import inference as tinference
from phc_gnn_torch.convert import from_flax_variables
from phc_gnn_torch.train import evaluators as tev
from phc_gnn_torch.train.state import make_loss_and_grads
from phc_gnn_torch.train.trainer import Trainer
from phc_gnn_torch.utils import col_diff, row_diff
from torch_parity import assert_leaf_close, port_flat
from torch_threads import one_torch_thread  # noqa: F401

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
REL_TRAIN = 1e-4
REL_PARAM = 1e-3
REL_EVAL_STATE = 1e-5
ZERO_GRAD = 1e-10  # a float64 gradient this far under the largest is 0
SMALL = ["--data_root", FIX, "--batch_size", "3", "--input_embed_dim", "16",
         "--mp_units", "16,16", "--d_units", "16"]
NO_DROPOUT = ["--dropout_mpnn", "0,0", "--dropout_dn", "0"]
DROPOUT = ["--dropout_mpnn", "0.3,0.3", "--dropout_dn", "0.2"]
NOT_EXACT = ("wall_s", "steps_per_s", "edges_per_s")


def _rows(save_dir, run=1):
    with open(os.path.join(save_dir, f"run_{run}", "scalars.jsonl")) as f:
        return [json.loads(line) for line in f]


def _json(path):
    with open(path) as f:
        return json.load(f)


def _rel(got, want):
    return abs(got - want) / max(abs(want), 1e-12)


@pytest.mark.parametrize("metric", ["rocauc", "ap", "acc", "mae"])
def test_evaluators_match_jax(metric):
    rng = np.random.default_rng(7)
    n, t = 200, 5
    if metric == "acc":
        y = rng.integers(0, 4, size=(n, 1)).astype(np.float64)
        y[rng.random(n) < 0.1] = np.nan
        pred = rng.normal(size=(n, 4))
    else:
        y = (rng.random((n, t)) < 0.3).astype(np.float64)
        y[rng.random((n, t)) < 0.4] = np.nan
        y[:, 2] = np.nan  # a column without a label
        pred = rng.normal(size=(n, t))
        pred[:20, 1] = 0.5  # ties
    got = tev.get_evaluator(metric)(y, pred)
    want = jev.get_evaluator(metric)(y, pred)
    assert got == want and np.isfinite(got)


def _init_pickle(tmp_path):
    """A flax params tree of the test's ZINC model, as numpy arrays."""
    args = jcli.get_parser("zinc").parse_args(SMALL + NO_DROPOUT)
    cfg = jcli.config_from_args("zinc", args)
    model = jax_build_model(cfg, ZINC_ATOM_DIMS, ZINC_BOND_DIMS)
    v = model.init(jax.random.key(0), jax_synthetic_batch(3, 256, 256, seed=0),
                   training=False)

    def numpy_tree(t):
        return ({k: numpy_tree(x) for k, x in t.items()} if hasattr(t, "items")
                else np.array(t))

    path = str(tmp_path / "init.pkl")
    with open(path, "wb") as f:
        pickle.dump(numpy_tree(jax.device_get(v["params"])), f)
    return path


def _zero_grad_leaves(trainer):
    """The parameters whose gradient is 0 in exact arithmetic: those of the
    port's model whose float64 gradient of the training loss on the first
    train batch is at most ``ZERO_GRAD`` of the largest leaf's (the biases
    that a batch norm follows)."""
    model = trainer.model.double()
    try:
        batch = next(iter(trainer.train_batches(0)))
        batch = batch.replace(**{
            f: getattr(batch, f).double() for f in ("nodes", "edges", "y")
            if getattr(batch, f).is_floating_point()})
        _, _, grads = make_loss_and_grads(
            model, trainer.loss_fn, trainer.cfg.weightdecay)(batch, 1e-3)
    finally:
        model.float()
    top = {k: float(g.abs().max()) for k, g in grads.items()}
    return {k for k, v in top.items() if v <= ZERO_GRAD * max(top.values())}


def _restore_jax(save_dir, name):
    return ocp.StandardCheckpointer().restore(
        os.path.abspath(os.path.join(save_dir, "run_1", "ckpt", name)))


@pytest.mark.parametrize("path", ["plain", "scan_chunk4", "grad_accum2"])
def test_trainer_matches_jax(path, tmp_path):
    flags = {"plain": [], "scan_chunk4": ["--scan_chunk", "4"],
             "grad_accum2": ["--grad_accum", "2"]}[path]
    argv = SMALL + NO_DROPOUT + flags + ["--epochs", "3",
                                         "--init_from", _init_pickle(tmp_path)]
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jcli.run_benchmark("zinc", argv + ["--save_dir", jdir])
    tcli.run_benchmark("zinc", argv + ["--save_dir", tdir, "--device", "cpu"])
    got, want = _rows(tdir), _rows(jdir)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g["epoch"] == w["epoch"] and g["lr"] == w["lr"]
        assert _rel(g["train_loss"], w["train_loss"]) <= REL_TRAIN, (g, w)
    got_vt = _json(os.path.join(tdir, "run_1", "val_test.json"))
    want_vt = _json(os.path.join(jdir, "run_1", "val_test.json"))
    assert sorted(got_vt) == sorted(want_vt)

    trainer = tcli.build_trainer("zinc", tcli.get_parser("zinc").parse_args(
        argv + ["--save_dir", str(tmp_path / "eval"), "--device", "cpu"]))
    exempt = _zero_grad_leaves(trainer)
    assert exempt and all(k.endswith(".b") for k in exempt), exempt
    final = _restore_jax(jdir, "3/default")
    params = port_flat(final["params"])
    port = _ckpt(tdir, 3)["model"]
    names = [k for k, _ in trainer.model.named_parameters()]
    assert sorted(names) == sorted(params)
    for k in names:
        if k not in exempt:
            assert_leaf_close(port[k], params[k], REL_PARAM, k)

    # the port's eval of JAX's own states gives JAX's numbers
    model = trainer.model
    model.load_state_dict(from_flax_variables(
        {c: final[c] for c in ("params", "batch_stats")}, model))
    valid = trainer.evaluate(trainer.valid_batches())
    last = trainer.evaluate(trainer.test_batches())
    model.load_state_dict(from_flax_variables(_restore_jax(jdir, "best"),
                                              model))
    best = trainer.evaluate(trainer.test_batches())
    for got_v, want_v in ((valid["loss"], want[-1]["valid_loss"]),
                          (valid["mae"], want[-1]["valid_metric"]),
                          (last["mae"], want_vt["test_last"]),
                          (best["mae"], want_vt["test_bestval"])):
        assert _rel(got_v, want_v) <= REL_EVAL_STATE, (got_v, want_v)


def _ckpt(save_dir, step):
    return torch.load(os.path.join(save_dir, "run_1", "ckpt", f"step_{step}.pt"),
                      weights_only=True)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("path", ["scan_chunk2", "grad_accum2"])
def test_resume_is_exact(path, tmp_path):
    """2 epochs, then a resume for 1, against 3 epochs straight, dropout
    on: every checkpointed tensor (parameters, running stats, Adam's
    moments and lr, the dropout generator), the scheduler's state, every
    scalars row (its timings aside) and the tests bit-equal."""
    flags = {"scan_chunk2": ["--scan_chunk", "2"],
             "grad_accum2": ["--grad_accum", "2"]}[path]
    argv = SMALL + DROPOUT + flags + ["--device", "cpu"]
    a, b = str(tmp_path / "resumed"), str(tmp_path / "straight")
    tcli.run_benchmark("zinc", argv + ["--save_dir", a, "--epochs", "2"])
    tcli.run_benchmark("zinc", argv + ["--save_dir", a, "--epochs", "3",
                                       "--resume"])
    tcli.run_benchmark("zinc", argv + ["--save_dir", b, "--epochs", "3"])
    got, want = _flat(_ckpt(a, 3)), _flat(_ckpt(b, 3))
    assert sorted(got) == sorted(want)
    assert any("adam/mu" in k for k in want) and "generator/" in want
    for k, w in want.items():
        if isinstance(w, torch.Tensor):
            assert torch.equal(got[k], w), k
        else:
            assert got[k] == w, k
    for name in ("trainer_state.json", "val_test.json"):
        assert (_json(os.path.join(a, "run_1", name))
                == _json(os.path.join(b, "run_1", name))), name
    ra, rb = _rows(a), _rows(b)
    assert [r["epoch"] for r in ra] == [0, 1, 2]
    for g, w in zip(ra, rb):
        assert ({k: v for k, v in g.items() if k not in NOT_EXACT}
                == {k: v for k, v in w.items() if k not in NOT_EXACT})
    assert ra[2]["train_loss"] != ra[1]["train_loss"]


@pytest.mark.parametrize("dataset", sorted(tcli.DATASETS))
def test_parser_matches_jax(dataset):
    """The same dests and defaults as benchmarks/common.py's parser, with
    ``--device`` (default cuda) the one addition."""
    got = vars(tcli.get_parser(dataset).parse_args([]))
    want = vars(jcli.get_parser(dataset).parse_args([]))
    assert got.pop("device") == "cuda"
    assert got == want
    assert tcli.config_from_args(dataset, tcli.get_parser(dataset).parse_args(
        ["--mp_units", "8,8"])).to_json() == jcli.config_from_args(
        dataset, jcli.get_parser(dataset).parse_args(["--mp_units", "8,8"])
        ).to_json()


def _tree(root):
    """Every file under ``root`` but the checkpoints' own (orbax's layout
    against torch.save's)."""
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files
                  if "ckpt" not in os.path.relpath(d, root).split(os.sep))


def test_cli_writes_jax_files(tmp_path):
    """``run_benchmark`` end to end, 2 runs of 2 epochs with dropout and
    weight logging: the same files and keys as JAX's CLI, finite values,
    each run re-seeded (its first loss differs)."""
    argv = SMALL + DROPOUT + ["--epochs", "2", "--n_runs", "2",
                              "--log_weights", "true"]
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jsum = jcli.run_benchmark("zinc", argv + ["--save_dir", jdir])
    tsum = tcli.run_benchmark("zinc", argv + ["--save_dir", tdir,
                                              "--device", "cpu"])
    assert _tree(tdir) == _tree(jdir)
    assert sorted(tsum) == sorted(jsum)
    assert (sorted(_json(os.path.join(tdir, "params.json")))
            == sorted(_json(os.path.join(jdir, "params.json"))))
    for run in (1, 2):
        rows, jrows = _rows(tdir, run), _rows(jdir, run)
        assert [sorted(r) for r in rows] == [sorted(r) for r in jrows]
        assert all(np.isfinite(v) for r in rows for v in r.values())
        arrays = np.load(os.path.join(tdir, f"run_{run}", "arrays.npy"),
                         allow_pickle=True).item()
        jarrays = np.load(os.path.join(jdir, f"run_{run}", "arrays.npy"),
                          allow_pickle=True).item()
        assert {k: len(v) for k, v in arrays.items()} == {
            k: len(v) for k, v in jarrays.items()}
    assert _rows(tdir, 1)[0]["train_loss"] != _rows(tdir, 2)[0]["train_loss"]


def test_inference_reproduces_test_bestval(tmp_path, capsys):
    """``cli.inference`` on a run's best export reproduces its
    ``test_bestval``; the run's ``--profile_steps`` trace (on a throwaway
    copy) is written and leaves the run as it was."""
    argv = SMALL + DROPOUT + ["--epochs", "3", "--device", "cpu",
                              "--save_dir", str(tmp_path / "exp")]
    summary = tcli.run_benchmark("zinc", argv)
    profiled = tcli.run_benchmark("zinc", argv[:-1] + [
        str(tmp_path / "profiled"), "--profile_steps", "2"])
    assert os.path.exists(tmp_path / "profiled" / "run_1" / "profile" /
                          "trace.json")
    assert profiled == summary
    capsys.readouterr()
    result = tinference.main(["zinc", "--run", "1"] + argv)
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == result
    assert sorted(result) == ["dataset", "loss", "mae", "run"]
    assert result["mae"] == summary["test_bestval"]["mean"]


@pytest.mark.parametrize("case", ["dp", "ep", "num_devices", "xla", "cuda",
                                  "pna_edge_axis"])
def test_trainer_raises(case, monkeypatch, tmp_path):
    """What the port refuses, and what it no longer does: ``dp``, ``ep``
    and ``num_devices`` above 1 run on ranks (tests/test_torch_dp.py) and
    raise without a process group, naming the call that makes one; under
    ep the replicated scheme does too, and a CLI run of it on 2 ranks
    trains; ``agg_kernel="xla"`` trains on the composite route (its loaders
    build no plan); ``device="cuda"`` without a card raises; training PNA
    under ``edge_axis`` raises in both frameworks, as ``pmax`` and
    ``pmin`` have no derivative in JAX (its eval works,
    tests/test_torch_edge_partition.py)."""
    from phc_gnn_torch.train.config import ExperimentConfig
    from phc_gnn_torch.train.trainer import build_model
    if case == "pna_edge_axis":
        _pna_under_edge_axis_raises()
        return
    cfg = ExperimentConfig(input_embed_dim=8, mp_units=(8,), d_units=(8,),
                           dropout_mpnn=(0.0,), dropout_dn=(0.0,))
    model = build_model(cfg, [28], [4], device="cpu")
    if case == "cuda":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Trainer(cfg, model, None, None, device="cuda")
        return
    if case == "xla":
        summary = tcli.run_benchmark("zinc", SMALL + NO_DROPOUT + [
            "--epochs", "1", "--agg_kernel", "xla", "--device", "cpu",
            "--save_dir", str(tmp_path)])
        assert np.isfinite(summary["test_last"]["mean"])
        assert _json(tmp_path / "params.json")["agg_kernel"] == "xla"
        return
    setattr(cfg, case, 2)
    with pytest.raises(RuntimeError, match="initialize"):
        Trainer(cfg, model, None, None, device="cpu")
    if case == "ep":
        cfg.ep_scheme = "replicated"
        with pytest.raises(RuntimeError, match="initialize"):
            Trainer(cfg, model, None, None, device="cpu")
        monkeypatch.setenv("OMP_NUM_THREADS", "1")  # a thread a rank
        summary = tcli.run_benchmark("zinc", SMALL + NO_DROPOUT + [
            "--epochs", "1", "--ep", "2", "--ep_scheme", "replicated",
            "--device", "cpu", "--save_dir", str(tmp_path)])
        assert np.isfinite(summary["test_last"]["mean"])
        assert len(_rows(tmp_path)) == 1


def _pna_under_edge_axis_raises():
    """One train step of a PNA model (mean, min, max, std) under
    ``edge_axis`` on a one-device mesh: JAX's ``make_ep_train_step`` raises
    in its differentiation of ``pmin`` or ``pmax``, and so does the
    port's ``make_ep_train_step``, in the backward."""
    import optax
    from phc_gnn_tpu.models import PHCGNN as JaxPHCGNN
    from phc_gnn_tpu.parallel import make_mesh as jax_make_mesh
    from phc_gnn_tpu.parallel import make_ep_train_step as jax_ep_step
    from phc_gnn_tpu.train.loss import masked_l1 as jax_l1
    from phc_gnn_tpu.train.state import TrainState
    from phc_gnn_torch import parallel as P
    from phc_gnn_torch.data import synthetic_batch
    from phc_gnn_torch.models import PHCGNN
    from phc_gnn_torch.train import make_optimizer
    from phc_gnn_torch.train.loss import masked_l1
    kw = dict(phm_dim=4, atom_input_dims=list(ZINC_ATOM_DIMS),
              bond_input_dims=list(ZINC_BOND_DIMS), atom_encoded_dim=8,
              mp_layers=(8,), dropout_mpnn=(0.0,), downstream_layers=(8,),
              dropout_dn=(0.0,), msg_aggr="pna", sc_type="last",
              avg_deg={"lin": 2.4, "log": 1.1})
    jb = jax_synthetic_batch(4, 128, 256, seed=0)
    tx = optax.chain(optax.scale(-1.0))
    # one jitted init compiles in a third of the eager init's time
    v = jax.jit(lambda key, b: JaxPHCGNN(**kw).init(key, b, training=False))(
        jax.random.key(0), jb)
    state = TrainState(params=v["params"], batch_stats=v["batch_stats"],
                       opt_state=tx.init(v["params"]), rng=jax.random.key(1),
                       step=np.zeros((), np.int32))
    step = jax_ep_step(JaxPHCGNN(**kw, edge_axis="ep"), tx,
                       lambda out, b: jax_l1(out, b.y),
                       jax_make_mesh(dp=1, ep=1), donate=False)
    rule = r"Differentiation rule for 'pm(in|ax)' not implemented"
    with pytest.raises(NotImplementedError, match=rule):
        step(state, jb, np.float32(1e-3))
    model = PHCGNN(**kw, edge_axis="ep", device="cpu")
    opt = make_optimizer(dict(model.named_parameters()))
    tstep = P.make_ep_train_step(model, opt, lambda out, b: masked_l1(out,
                                                                       b.y),
                                 P.make_mesh(1, 1), device="cpu")
    with pytest.raises(NotImplementedError, match=rule):
        tstep(P.edge_shard(synthetic_batch(4, 128, 256, seed=0), 1, 0), 1e-3)


@pytest.mark.parametrize("fn", ["row_diff", "col_diff"])
def test_oversmoothing_matches_jax(fn):
    x = np.random.default_rng(1).normal(size=(37, 12)).astype(np.float32)
    got = {"row_diff": row_diff, "col_diff": col_diff}[fn](torch.from_numpy(x))
    want = np.asarray(getattr(jos, fn)(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
