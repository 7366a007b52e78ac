"""The port's trained convergence (``phc_gnn_torch.cli.parity``, the
counterpart of scripts/run_convergence_parity.py) on the CPU.

- The card's records (``phc_gnn_torch/parity_records/<task>.json``, made by
  ``python -m phc_gnn_torch.cli.parity --task all`` on an H100) name the
  card and its power limit, ran the committed records' hyperparameters and
  dataset, and hold every bar of their task against the reference's
  committed half.
- ``hold`` is the bars of tests/test_convergence_parity_record.py: it passes
  JAX's committed half, and it names each bar for a copy moved just past
  it, and not for one moved just inside.
- ``HPARAMS`` equals every committed ``record.json["hparams"]``.
- The committed inits (quat, concat) load strictly into the port's models
  built from the records' hyperparameters, and the port's eval forward on a
  parity batch equals JAX's ``PHCGNN`` from the same pickle, normwise within
  ``REL_INIT``.
- ``cli_argv`` gives the flags of the JAX script's ``run_ours`` (written out
  below), and the runner writes a whole record at ``--smoke`` scale on the
  CPU.
"""

import json
import math
import os
import pickle
import re

import jax
import numpy as np
import pytest
import torch

from benchmarks import common as jcli
from phc_gnn_tpu.data import loader as jloader
from phc_gnn_tpu.train import build_model as jax_build_model
from phc_gnn_torch.cli import common as tcli
from phc_gnn_torch.cli import parity
from phc_gnn_torch.convert import from_flax_params
from phc_gnn_torch.data import loader as tloader
from phc_gnn_torch.data.parity import make_parity_graphs
from phc_gnn_torch.train import make_eval_step
from phc_gnn_torch.train.trainer import build_model
from torch_parity import assert_close
from torch_threads import one_torch_thread  # noqa: F401

REL_INIT = 1e-5  # eval forward from one init, JAX against the port, normwise
HALF_KEYS = {"val_metric", "train_loss", "lr", "best_val", "test_bestval",
             "test_last", "seconds", "s_per_epoch", "card", "torch"}
RECORD_KEYS = {"task", "hparams", "dataset", "generator_seed", "init", "port",
               "misses"}


def _card_record(task):
    with open(os.path.join(parity.CARD_RECORDS, f"{task}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("task", parity.TASKS)
def test_card_records_are_card_runs(task):
    """Each card record names an H100 and its power limit, ran the committed
    record's hyperparameters, dataset and init, and carries its misses."""
    rec = _card_record(task)
    committed = parity.committed_record(task)
    assert set(rec) == RECORD_KEYS and set(rec["port"]) == HALF_KEYS
    card = rec["port"]["card"]
    assert "H100" in card and re.search(r"\d+(\.\d+)? W$", card), card
    assert rec["hparams"] == parity.HPARAMS[task] == committed["hparams"]
    assert rec["dataset"] == committed["dataset"]
    assert rec["generator_seed"] == parity.GENERATOR_SEED
    assert rec["init"] == ("committed" if parity.init_path(task) else "seed0")
    assert len(rec["port"]["val_metric"]) == rec["hparams"]["epochs"]
    assert rec["misses"] == parity.hold(task, rec["port"],
                                        committed["reference"])


# The card's misses, searched for a fault and none found (CHANGES.md, PR 20;
# ROADMAP §3): both tasks start from the port's seed-0 init, not the
# reference's, whose pickle was not kept.
CARD_MISSES = {
    "zinc": "trajectory: the running medians' worst ratio 1.630 (epoch 14) "
            ">= 1.4; three later card runs from the same init read 1.375, "
            "1.259, 1.283: the run-to-run spread of an L1 task whose loss "
            "parts by 1e-2 at a 1-ulp change of the init",
    "hiv": "best_val 0.8575 against the reference's 0.8414 (|diff| 0.0161 "
           ">= 0.015) and trajectory 0.0853 (epoch 3) >= 0.05: the seed-0 "
           "init climbs faster (epoch 3 AUC 0.807; 0.804 on the CPU, 0.753 "
           "from a JAX-made init, the reference 0.721)",
}


@pytest.mark.parametrize("task", [
    pytest.param(t, marks=pytest.mark.xfail(strict=True,
                                            reason=CARD_MISSES[t]))
    if t in CARD_MISSES else t for t in parity.TASKS])
def test_card_records_hold(task):
    rec = _card_record(task)
    committed = parity.committed_record(task)
    assert parity.hold(task, rec["port"], committed["reference"]) == []


def _moved(half, **changes):
    out = dict(half)
    out.update(changes)
    return out


def _cases(task, ref, ours):
    """(bar, a copy of JAX's half moved just past the bar, one moved just
    inside it) for each bar of ``task``."""
    bars = parity.BARS[task]
    val, n = list(ours["val_metric"]), bars["epochs"]
    yield "epochs", _moved(ours, val_metric=val[:n - 1]), \
        _moved(ours, val_metric=val[:n])
    e = bars["endpoint"]
    for key in ("best_val", "test_bestval"):
        yield key, _moved(ours, **{key: ref[key] + e * 1.001}), \
            _moved(ours, **{key: ref[key] - e * 0.999})
    if bars["floor"] is not None:
        f = bars["floor"]
        yield "floor", _moved(ours, best_val=f - 1e-4), \
            _moved(ours, best_val=f + 1e-4)
    kind, limit = bars["trajectory"]
    rv = np.asarray(ref["val_metric"], np.float64)
    if kind == "ratio":
        past, inside = rv * limit * 1.001, rv * limit * 0.999
    else:
        past, inside = rv + limit * 1.001, rv + limit * 0.999
    yield "trajectory", _moved(ours, val_metric=past.tolist()), \
        _moved(ours, val_metric=inside.tolist())
    kind, limit = bars["gain"]
    best = ours["best_val"]
    if kind == "ratio":
        first_past, first_inside = best * limit * 0.999, best * limit * 1.001
    else:
        first_past, first_inside = best - limit * 0.999, best - limit * 1.001
    yield "non_vacuous", _moved(ours, val_metric=[first_past] + val[1:]), \
        _moved(ours, val_metric=[first_inside] + val[1:])


def _bars_missed(misses):
    return {m.split(":")[0] for m in misses}


@pytest.mark.parametrize("task", parity.TASKS)
def test_hold_is_the_record_tests_bars(task):
    committed = parity.committed_record(task)
    ref, ours = committed["reference"], committed["ours"]
    assert parity.hold(task, ours, ref) == []
    bars = []
    for bar, past, inside in _cases(task, ref, ours):
        assert bar in _bars_missed(parity.hold(task, past, ref)), bar
        assert bar not in _bars_missed(parity.hold(task, inside, ref)), bar
        bars.append(bar)
    want = {"epochs", "best_val", "test_bestval", "trajectory", "non_vacuous"}
    assert set(bars) == want | ({"floor"} if task == "hiv" else set())


def test_hparams_match_records():
    for task in parity.TASKS:
        assert parity.HPARAMS[task] == parity.committed_record(task)["hparams"]


def _configs(task, init):
    """JAX's and the port's configurations of ``task`` from the runner's
    flags (JAX's CLI takes them but ``--device``)."""
    hp = parity.HPARAMS[task]
    script = hp.get("script", task)
    argv = parity.cli_argv(task, hp, "unused", "unused", init, "cpu")
    jcfg = jcli.config_from_args(script, jcli.get_parser(script).parse_args(
        argv[:-2]))
    tcfg = tcli.config_from_args(script, tcli.get_parser(script).parse_args(
        argv))
    return script, jcfg, tcfg


@pytest.mark.parametrize("task", ["quat", "concat"])
def test_committed_inits_load(task):
    init = parity.init_path(task)
    with open(init, "rb") as f:
        params = pickle.load(f)
    script, jcfg, tcfg = _configs(task, init)
    graphs = make_parity_graphs(script, seed=parity.GENERATOR_SEED, splits={
        "train": 24, "valid": 8, "test": 8})["train"]
    if script == "zinc":
        atom, bond = tcli.ZINC_ATOM_DIMS, tcli.ZINC_BOND_DIMS
    else:
        atom, bond = tcli.ATOM_FEATURE_DIMS, tcli.BOND_FEATURE_DIMS
    td = tcli.label_dim(tcfg)
    jb = next(iter(jloader.PaddedLoader(graphs, jloader.compute_bucket_spec(
        graphs, 24, target_dim=td))))
    tb = next(iter(tloader.PaddedLoader(graphs, tloader.compute_bucket_spec(
        graphs, 24, target_dim=td), csr_plan=True)))

    model = build_model(tcfg, atom, bond, device="cpu")
    state = from_flax_params(params, model)
    model.load_state_dict(state, strict=True)
    n_params = sum(p.numel() for p in model.parameters())
    assert n_params == {"quat": 30433, "concat": 20242}[task]

    jm = jax_build_model(jcfg, atom, bond)

    @jax.jit
    def forward(p, b):  # the fresh running stats, as the warm start keeps
        stats = jm.init(jax.random.key(0), b, training=False)["batch_stats"]
        return jm.apply({"params": p, "batch_stats": stats}, b,
                        training=False)

    want = np.asarray(forward(params, jb))
    got = make_eval_step(model, device="cpu")(tb)
    assert got.shape == want.shape == (24 + 1, tcfg.target_dim)
    assert np.all(np.isfinite(want))
    assert_close(got, want, REL_INIT)


# scripts/run_convergence_parity.py's run_ours flags for JAX's CLI
# (:393-428) with data_root "D", save dir "S" and init "I", written out
RUN_OURS = {
    "zinc": [
        "--data_root", "D", "--save_dir", "S", "--init_from", "I",
        "--n_runs", "1", "--seed", "0", "--batch_size", "128",
        "--phm_dim", "4", "--input_embed_dim", "96",
        "--mp_units", "96,96,96", "--d_units", "96,48", "--mlp_mp", "True",
        "--dropout_mpnn", "0.0,0.0,0.0", "--dropout_dn", "0.2,0.1",
        "--weightdecay", "0.01", "--weightdecay2", "0.0",
        "--regularization", "2", "--grad_clipping", "2.0", "--lr", "0.001",
        "--patience", "5", "--factor", "0.5", "--epochs", "40",
        "--min_lr", "1e-06", "--aggr_msg", "sum", "--aggr_node", "sum",
        "--sc_type", "last", "--pooling", "softattention",
        "--target_dim", "1"],
    "hiv": [
        "--data_root", "D", "--save_dir", "S", "--init_from", "I",
        "--n_runs", "1", "--seed", "0", "--batch_size", "128",
        "--phm_dim", "4", "--input_embed_dim", "96",
        "--mp_units", "96,96", "--d_units", "64,32", "--mlp_mp", "True",
        "--dropout_mpnn", "0.2,0.2", "--dropout_dn", "0.3,0.1",
        "--weightdecay", "0.1", "--weightdecay2", "0.0",
        "--regularization", "2", "--grad_clipping", "2.0", "--lr", "0.001",
        "--patience", "5", "--factor", "0.75", "--epochs", "35",
        "--min_lr", "1e-06", "--aggr_msg", "softmax",
        "--aggr_node", "softmax", "--sc_type", "first",
        "--pooling", "softattention", "--target_dim", "1"],
    "pcba": [
        "--data_root", "D", "--save_dir", "S", "--init_from", "I",
        "--n_runs", "1", "--seed", "0", "--batch_size", "128",
        "--phm_dim", "2", "--input_embed_dim", "64",
        "--mp_units", "64,64", "--d_units", "96,48", "--mlp_mp", "False",
        "--dropout_mpnn", "0.1,0.1", "--dropout_dn", "0.3,0.1",
        "--weightdecay", "0.0001", "--weightdecay2", "0.0",
        "--regularization", "2", "--grad_clipping", "2.0", "--lr", "0.001",
        "--patience", "5", "--factor", "0.75", "--epochs", "30",
        "--min_lr", "1e-06", "--aggr_msg", "sum", "--aggr_node", "sum",
        "--sc_type", "last", "--pooling", "softattention",
        "--target_dim", "8"],
    "concat": [
        "--data_root", "D", "--save_dir", "S", "--init_from", "I",
        "--n_runs", "1", "--seed", "0", "--batch_size", "128",
        "--phm_dim", "4", "--input_embed_dim", "48",
        "--mp_units", "48,48", "--d_units", "64,32", "--mlp_mp", "False",
        "--dropout_mpnn", "0.1,0.1", "--dropout_dn", "0.3,0.1",
        "--weightdecay", "0.0001", "--weightdecay2", "0.0",
        "--regularization", "2", "--grad_clipping", "2.0", "--lr", "0.001",
        "--patience", "5", "--factor", "0.75", "--epochs", "30",
        "--min_lr", "1e-06", "--aggr_msg", "softmax",
        "--aggr_node", "softmax", "--sc_type", "first",
        "--pooling", "softattention", "--target_dim", "8",
        "--type", "concat"],
    "quat": [
        "--data_root", "D", "--save_dir", "S", "--init_from", "I",
        "--n_runs", "1", "--seed", "0", "--batch_size", "128",
        "--phm_dim", "4", "--input_embed_dim", "96",
        "--mp_units", "96,96,96", "--d_units", "96,48", "--mlp_mp", "True",
        "--dropout_mpnn", "0.0,0.0,0.0", "--dropout_dn", "0.2,0.1",
        "--weightdecay", "0.01", "--weightdecay2", "0.0",
        "--regularization", "2", "--grad_clipping", "2.0", "--lr", "0.001",
        "--patience", "5", "--factor", "0.5", "--epochs", "40",
        "--min_lr", "1e-06", "--aggr_msg", "sum", "--aggr_node", "sum",
        "--sc_type", "first", "--pooling", "softattention",
        "--target_dim", "1", "--norm_mp", "q-batch-norm",
        "--norm_dn", "naive-batch-norm"],
}


# the settings of the records' runs that the pcba defaults no longer give
PCBA_RECORDED = ["--grad_accum", "1", "--max_nodes", "0", "--max_edges", "0",
                 "--eval_batch_size", "0"]
BUCKET_FIELDS = ("max_nodes", "max_edges", "eval_batch_size")  # 0 or None:
                                                               # from the data


@pytest.mark.parametrize("task", parity.TASKS)
def test_runner_runs_the_records_config(task):
    """The port's configuration from the runner's flags is the one JAX's
    record run read (``parity_runs/<task>/ours/params.json``), field for
    field but the paths."""
    _, _, tcfg = _configs(task, "I")
    got = json.loads(tcfg.to_json())
    with open(os.path.join(parity.REFERENCE_RECORDS, task, "ours",
                           "params.json")) as f:
        want = json.load(f)
    assert set(got) == set(want)
    for key in sorted(set(want) - {"save_dir", "init_from"}):
        g, w = got[key], want[key]
        if key in BUCKET_FIELDS:
            g, w = g or None, w or None
        assert g == w, (key, g, w)


def test_runner_smoke_on_cpu(tmp_path):
    hp = parity.HPARAMS["quat"]
    for task in parity.TASKS:
        argv = parity.cli_argv(task, parity.HPARAMS[task], "D", "S", "I",
                               "cpu")
        extra = PCBA_RECORDED if task in ("pcba", "concat") else []
        assert argv == RUN_OURS[task] + extra + ["--device", "cpu"], task
    assert parity.cli_argv("zinc", parity.HPARAMS["zinc"], "D", "S", None,
                           "cuda")[:5] == ["--data_root", "D", "--save_dir",
                                           "S", "--n_runs"]
    _, _, tcfg = _configs("quat", "I")
    assert (tcfg.norm_mp, tcfg.norm_dn, tcfg.mp_units) == (
        hp["norm_mp"], hp["norm_dn"], (96, 96, 96))
    with pytest.raises(RuntimeError, match="CUDA"):
        parity.main(["--task", "quat", "--smoke"])  # --device cuda, no card

    out = str(tmp_path / "records")
    records = parity.main(["--task", "quat", "--smoke", "--device", "cpu",
                           "--out", out])
    with open(os.path.join(out, "quat.json")) as f:
        rec = json.load(f)
    assert rec == json.loads(json.dumps(records["quat"]))
    assert set(rec) == RECORD_KEYS and set(rec["port"]) == HALF_KEYS
    assert rec["hparams"] == {**hp, "epochs": parity.SMOKE_EPOCHS}
    assert rec["dataset"] == parity.SMOKE_SPLITS
    assert (rec["init"], rec["generator_seed"]) == ("committed", 7)
    port = rec["port"]
    assert port["card"] == "cpu"
    for key in ("val_metric", "train_loss", "lr"):
        assert len(port[key]) == parity.SMOKE_EPOCHS
        assert all(math.isfinite(v) for v in port[key]), key
    for key in ("best_val", "test_bestval", "test_last", "seconds",
                "s_per_epoch"):
        assert math.isfinite(port[key]) and port[key] > 0, key
    assert port["best_val"] == min(port["val_metric"])
    # 3 epochs cannot reach 35: the bars miss by design at this scale
    assert rec["misses"] == parity.hold(
        "quat", port, parity.committed_record("quat")["reference"])
    assert "epochs" in _bars_missed(rec["misses"])
