"""Trained convergence of the port on the five parity tasks: the counterpart
of scripts/run_convergence_parity.py without its reference half.

    python -m phc_gnn_torch.cli.parity --task {zinc,hiv,pcba,concat,quat,all} \\
        [--device cuda|cpu] [--out DIR] [--smoke]

The reference's training loop runs only where the reference is installed,
so its half of each comparison is read from the committed records
(``parity_runs/<task>/record.json``, made by the JAX script, which ran the
reference and JAX's CLI on the same data from the same init).  For each
task this module generates the deterministic parity dataset
(``data.parity``, generator seed 7) in a temporary directory, trains the
port's CLI on it (``cli.common.run_benchmark`` in process, with the CLI's
defaults: on the card the CSR plans and graphed steps) with the record's
hyperparameters and the settings its run read (``RECORDED_FLAGS``), reads the run's ``scalars.jsonl`` and ``val_test.json``
into the keys of the JAX script's ``ours`` half, and holds it to the
reference's half with the bars of tests/test_convergence_parity_record.py
(``hold``).  The init is the committed ``parity_runs/<task>/init_params.pkl``
where there is one (quat, concat: the init both the reference and JAX
started from), else the port's own seed-0 init; the record says which.

Each task writes ``<out>/<task>.json`` (``task``, ``hparams``,
``dataset``, ``generator_seed``, ``init``, ``port``, ``misses``) and
prints the reference's, JAX's and the port's validation metric epoch by
epoch, then the endpoints.  A miss is reported, not raised.  ``--smoke``
trains on 200 / 64 / 64 graphs for 3 epochs, a check of the plumbing
whose bars miss by design.  ``--device`` defaults to ``cuda`` and raises
without a card.  The card's records are committed under
``phc_gnn_torch/parity_records/``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import tempfile
import time

import numpy as np
import torch

from phc_gnn_torch.device import resolve_device

__all__ = ["TASKS", "HPARAMS", "BARS", "RECORDED_FLAGS", "SMOKE_SPLITS",
           "SMOKE_EPOCHS", "GENERATOR_SEED", "REFERENCE_RECORDS",
           "CARD_RECORDS", "committed_record", "init_path", "cli_argv",
           "rmed", "hold", "card_name", "run_port", "run_task", "main"]

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# the JAX script's records and inits, read-only
REFERENCE_RECORDS = os.path.join(_REPO, "parity_runs")
# the port's records, made on the card by --task all
CARD_RECORDS = os.path.join(_REPO, "phc_gnn_torch", "parity_records")

TASKS = ("zinc", "hiv", "pcba", "concat", "quat")
GENERATOR_SEED = 7
SMOKE_SPLITS = {"train": 200, "valid": 64, "test": 64}
SMOKE_EPOCHS = 3

# A copy of the JAX script's table (scripts/run_convergence_parity.py:101-153),
# key for key: "script" is the dataset (and loss) family, "family" the
# reference's model class, "ref_target_dim" what the reference's constructor
# got; "model_type", "norm_mp" and "norm_dn" go to the CLI.
HPARAMS = {
    "zinc": dict(phm_dim=4, input_embed_dim=96, mp_units="96,96,96",
                 d_units="96,48", mlp_mp=True, aggr_msg="sum",
                 aggr_node="sum", sc_type="last", pooling="softattention",
                 dropout_mpnn="0.0,0.0,0.0", dropout_dn="0.2,0.1",
                 weightdecay=0.01, weightdecay2=0.0, regularization=2,
                 grad_clipping=2.0, lr=1e-3, patience=5, factor=0.5,
                 batch_size=128, epochs=40, seed=0, min_lr=1e-6,
                 atom_dims=[28], bond_dims=[4], target_dim=1,
                 metric="mae", mode="min"),
    "pcba": dict(phm_dim=2, input_embed_dim=64, mp_units="64,64",
                 d_units="96,48", mlp_mp=False, aggr_msg="sum",
                 aggr_node="sum", sc_type="last", pooling="softattention",
                 dropout_mpnn="0.1,0.1", dropout_dn="0.3,0.1",
                 weightdecay=1e-4, weightdecay2=0.0, regularization=2,
                 grad_clipping=2.0, lr=1e-3, patience=5, factor=0.75,
                 batch_size=128, epochs=30, seed=0, min_lr=1e-6,
                 atom_dims=[119, 5, 12, 12, 10, 6, 6, 2, 2],
                 bond_dims=[5, 6, 2], target_dim=8,
                 metric="ap", mode="max"),
    "hiv": dict(phm_dim=4, input_embed_dim=96, mp_units="96,96",
                d_units="64,32", mlp_mp=True, aggr_msg="softmax",
                aggr_node="softmax", sc_type="first", pooling="softattention",
                dropout_mpnn="0.2,0.2", dropout_dn="0.3,0.1",
                weightdecay=0.1, weightdecay2=0.0, regularization=2,
                grad_clipping=2.0, lr=1e-3, patience=5, factor=0.75,
                batch_size=128, epochs=35, seed=0, min_lr=1e-6,
                atom_dims=[119, 5, 12, 12, 10, 6, 6, 2, 2],
                bond_dims=[5, 6, 2], target_dim=1,
                metric="rocauc", mode="max"),
    "concat": dict(script="pcba", family="phm-concat", phm_dim=4,
                   input_embed_dim=48, mp_units="48,48", d_units="64,32",
                   mlp_mp=False, aggr_msg="softmax", aggr_node="softmax",
                   sc_type="first", pooling="softattention",
                   dropout_mpnn="0.1,0.1", dropout_dn="0.3,0.1",
                   weightdecay=1e-4, weightdecay2=0.0, regularization=2,
                   grad_clipping=2.0, lr=1e-3, patience=5, factor=0.75,
                   batch_size=128, epochs=30, seed=0, min_lr=1e-6,
                   atom_dims=[119, 5, 12, 12, 10, 6, 6, 2, 2],
                   bond_dims=[5, 6, 2], ref_target_dim=2, target_dim=8,
                   model_type="concat", metric="ap", mode="max"),
    "quat": dict(script="zinc", family="quat-add", phm_dim=4,
                 input_embed_dim=96, mp_units="96,96,96", d_units="96,48",
                 mlp_mp=True, aggr_msg="sum", aggr_node="sum",
                 sc_type="first", pooling="softattention",
                 dropout_mpnn="0.0,0.0,0.0", dropout_dn="0.2,0.1",
                 weightdecay=0.01, weightdecay2=0.0, regularization=2,
                 grad_clipping=2.0, lr=1e-3, patience=5, factor=0.5,
                 batch_size=128, epochs=40, seed=0, min_lr=1e-6,
                 atom_dims=[28], bond_dims=[4], target_dim=1,
                 norm_mp="q-batch-norm", norm_dn="naive-batch-norm",
                 metric="mae", mode="min"),
}

# The bars of tests/test_convergence_parity_record.py, task by task: the
# least epochs on each side; the endpoints (best_val, test_bestval) within
# "endpoint"; the 5-epoch running medians within a ratio (MAE, from epoch 4)
# or an absolute difference (AUC, AP); hiv's floor under both best_vals; and
# the non-vacuous gain of each side from epoch 0, a ratio val[0] / best (MAE)
# or a difference best - val[0].
_MAE = dict(epochs=35, endpoint=0.015, trajectory=("ratio", 1.4),
            floor=None, gain=("ratio", 4.0))
_AP = dict(epochs=30, endpoint=0.02, trajectory=("diff", 0.05),
           floor=None, gain=("diff", 0.1))
BARS = {"zinc": _MAE,
        "hiv": dict(epochs=35, endpoint=0.015, trajectory=("diff", 0.05),
                    floor=0.80, gain=("diff", 0.2)),
        "pcba": _AP, "concat": _AP, "quat": _MAE}


# What the records' runs read that the CLI's defaults no longer give, by
# dataset: JAX's runs trained the pcba family (pcba, concat) with one
# optimizer step a 128-graph batch and buckets sized from the data
# (parity_runs/{pcba,concat}/ours/params.json: grad_accum 1, max_nodes,
# max_edges and eval_batch_size null), as the reference does; the pcba
# defaults have since taken grad_accum 4, a 4,096 / 8,192 bucket and
# 512-graph eval batches.  A size of 0 sizes the bucket from the data.
RECORDED_FLAGS = {"pcba": ["--grad_accum", "1", "--max_nodes", "0",
                           "--max_edges", "0", "--eval_batch_size", "0"]}


def committed_record(task: str) -> dict:
    """The JAX script's committed record of ``task``: its ``hparams``,
    ``dataset`` and the ``reference`` and ``ours`` (JAX) halves."""
    with open(os.path.join(REFERENCE_RECORDS, task, "record.json")) as f:
        return json.load(f)


def init_path(task: str):
    """The committed init of ``task`` (a pickled flax params tree of numpy
    arrays), or None where none was kept."""
    path = os.path.join(REFERENCE_RECORDS, task, "init_params.pkl")
    return path if os.path.exists(path) else None


def cli_argv(task: str, hp: dict, data_root: str, save_dir: str, init_path,
             device: str) -> list:
    """The port CLI's flags for ``task``, as the JAX script's ``run_ours``
    builds them for JAX's CLI (:392-428), then ``RECORDED_FLAGS`` of its
    dataset and ``--device``; no ``--init_from`` where ``init_path`` is
    None."""
    argv = ["--data_root", data_root, "--save_dir", save_dir]
    if init_path is not None:
        argv += ["--init_from", init_path]
    argv += ["--n_runs", "1",
             "--seed", str(hp["seed"]),
             "--batch_size", str(hp["batch_size"]),
             "--phm_dim", str(hp["phm_dim"]),
             "--input_embed_dim", str(hp["input_embed_dim"]),
             "--mp_units", hp["mp_units"],
             "--d_units", hp["d_units"],
             "--mlp_mp", str(hp["mlp_mp"]),
             "--dropout_mpnn", hp["dropout_mpnn"],
             "--dropout_dn", hp["dropout_dn"],
             "--weightdecay", str(hp["weightdecay"]),
             "--weightdecay2", str(hp["weightdecay2"]),
             "--regularization", str(hp["regularization"]),
             "--grad_clipping", str(hp["grad_clipping"]),
             "--lr", str(hp["lr"]),
             "--patience", str(hp["patience"]),
             "--factor", str(hp["factor"]),
             "--epochs", str(hp["epochs"]),
             "--min_lr", str(hp["min_lr"]),
             "--aggr_msg", hp["aggr_msg"],
             "--aggr_node", hp["aggr_node"],
             "--sc_type", hp["sc_type"],
             "--pooling", hp["pooling"],
             "--target_dim", str(hp.get("target_dim", 1))]
    if "model_type" in hp:
        argv += ["--type", hp["model_type"]]
    if "norm_mp" in hp:
        argv += ["--norm_mp", hp["norm_mp"]]
    if "norm_dn" in hp:
        argv += ["--norm_dn", hp["norm_dn"]]
    return (argv + RECORDED_FLAGS.get(hp.get("script", task), [])
            + ["--device", device])


def rmed(x, k: int = 5) -> np.ndarray:
    """The running median over ``k`` epochs, the ends padded with the edge
    values (the record test's ``rmed``)."""
    x = np.asarray(x, np.float64)
    xp = np.pad(x, k // 2, mode="edge")
    return np.array([np.median(xp[i:i + k]) for i in range(len(x))])


def hold(task: str, port: dict, reference: dict) -> list:
    """The bars of ``task`` that ``port`` misses against ``reference`` (each
    a half with ``val_metric``, ``best_val`` and ``test_bestval``), as
    ``"<bar>: <numbers>"`` strings; bars: ``epochs``, ``best_val``,
    ``test_bestval``, ``floor``, ``trajectory``, ``non_vacuous``.  An empty
    list holds every bar."""
    bars = BARS[task]
    sides = (("reference", reference), ("port", port))
    misses = []
    for side, half in sides:
        n = len(half["val_metric"])
        if n < bars["epochs"]:
            misses.append(f"epochs: the {side} ran {n} < {bars['epochs']}")
    for key in ("best_val", "test_bestval"):
        diff = abs(reference[key] - port[key])
        if not diff < bars["endpoint"]:
            misses.append(f"{key}: reference {reference[key]:.6g}, port "
                          f"{port[key]:.6g}, |diff| {diff:.6g} >= "
                          f"{bars['endpoint']}")
    if bars["floor"] is not None:
        for side, half in sides:
            if not half["best_val"] > bars["floor"]:
                misses.append(f"floor: the {side}'s best_val "
                              f"{half['best_val']:.6g} <= {bars['floor']}")
    a, b = rmed(reference["val_metric"]), rmed(port["val_metric"])
    n = min(len(a), len(b))
    kind, limit = bars["trajectory"]
    if kind == "ratio":
        dev = np.maximum(a[4:n], b[4:n]) / np.minimum(a[4:n], b[4:n])
    else:
        dev = np.abs(a[:n] - b[:n])
    worst = float(np.max(dev)) if dev.size else float("inf")
    if not worst < limit:
        misses.append(f"trajectory: running medians' worst {kind} "
                      f"{worst:.6g} >= {limit}")
    kind, limit = bars["gain"]
    for side, half in sides:
        first, best = half["val_metric"][0], half["best_val"]
        gain = first / best if kind == "ratio" else best - first
        if not gain > limit:
            misses.append(f"non_vacuous: the {side}'s gain from epoch 0 "
                          f"({kind}) {gain:.6g} <= {limit}")
    return misses


def card_name(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them, or
    ``"cpu"``."""
    if device.type != "cuda":
        return "cpu"
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=60, check=True)
        return smi.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{torch.cuda.get_device_name(device)}, power limit not read"


def run_port(task: str, hp: dict, data_root: str, save_dir: str, init,
             device: torch.device):
    """Train the port's CLI on ``task`` and return ``(half, rows)``: the
    keys of the JAX script's ``ours`` half (``val_metric``, ``train_loss``,
    ``lr``, ``best_val``, ``test_bestval``, ``test_last``) with
    ``seconds``, ``s_per_epoch``, ``card`` and ``torch``, and the run's
    ``scalars.jsonl`` rows.  The run's checkpoints are deleted."""
    from phc_gnn_torch.cli.common import run_benchmark

    argv = cli_argv(task, hp, data_root, save_dir, init, device.type)
    t0 = time.perf_counter()
    run_benchmark(hp.get("script", task), argv)
    seconds = time.perf_counter() - t0
    run_dir = os.path.join(save_dir, "run_1")
    with open(os.path.join(run_dir, "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    with open(os.path.join(run_dir, "val_test.json")) as f:
        val_test = json.load(f)
    shutil.rmtree(os.path.join(run_dir, "ckpt"), ignore_errors=True)
    half = {"val_metric": [r["valid_metric"] for r in rows],
            "train_loss": [r["train_loss"] for r in rows],
            "lr": [r["lr"] for r in rows],
            "best_val": val_test["best_val"],
            "test_bestval": val_test["test_bestval"],
            "test_last": val_test["test_last"],
            "seconds": seconds, "s_per_epoch": seconds / len(rows),
            "card": card_name(device), "torch": torch.__version__}
    return half, rows


def run_task(task: str, device="cuda", smoke: bool = False, out=None):
    """Train the port on ``task``'s parity dataset and hold it to the
    committed reference: returns ``(record, rows)`` and, with ``out``,
    writes the record to ``<out>/<task>.json``."""
    device = resolve_device(device)
    from phc_gnn_torch.data.parity import (PARITY_SPLITS,
                                           generate_parity_dataset)

    hp = dict(HPARAMS[task])
    splits = dict(PARITY_SPLITS)
    if smoke:
        splits, hp["epochs"] = dict(SMOKE_SPLITS), SMOKE_EPOCHS
    init = init_path(task)
    with tempfile.TemporaryDirectory(prefix=f"phc_parity_{task}_") as tmp:
        root = generate_parity_dataset(hp.get("script", task),
                                       os.path.join(tmp, "data"),
                                       seed=GENERATOR_SEED, splits=splits)
        port, rows = run_port(task, hp, root, os.path.join(tmp, "port"),
                              init, device)
    committed = committed_record(task)
    record = {"task": task, "hparams": hp, "dataset": splits,
              "generator_seed": GENERATOR_SEED,
              "init": "committed" if init else "seed0", "port": port,
              "misses": hold(task, port, committed["reference"])}
    if out is not None:
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, f"{task}.json"), "w") as f:
            json.dump(record, f, indent=2)
            f.write("\n")
    return record, rows


def report(record: dict, committed: dict) -> None:
    """Print the reference's, JAX's and the port's validation metric epoch by
    epoch, then the three endpoints and the misses."""
    ref, jax_, port = (committed["reference"], committed["ours"],
                       record["port"])
    print(f"{record['task']} ({record['init']} init, {port['card']}, "
          f"{port['seconds']:.1f} s, {port['s_per_epoch']:.3f} s an epoch)")
    print(f"{'epoch':>5} {'reference':>10} {'jax':>10} {'port':>10}")
    n = max(len(ref["val_metric"]), len(jax_["val_metric"]),
            len(port["val_metric"]))

    def at(half, i):
        v = half["val_metric"]
        return f"{v[i]:>10.4f}" if i < len(v) else f"{'':>10}"

    for i in range(n):
        print(f"{i:>5} {at(ref, i)} {at(jax_, i)} {at(port, i)}")
    for key in ("best_val", "test_bestval", "test_last"):
        print(f"{key:<13} reference {ref[key]:.4f}   jax {jax_[key]:.4f}   "
              f"port {port[key]:.4f}")
    print(f"misses: {record['misses'] or 'none'}", flush=True)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m phc_gnn_torch.cli.parity",
        description="train the port on the parity tasks and hold it to the "
                    "reference's committed records")
    ap.add_argument("--task", choices=TASKS + ("all",), required=True)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (raises without a card) or cpu")
    ap.add_argument("--out", default=None,
                    help="where <task>.json goes (default: a new temporary "
                         "directory)")
    ap.add_argument("--smoke", action="store_true",
                    help="200 / 64 / 64 graphs and 3 epochs: plumbing only")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    out = args.out or tempfile.mkdtemp(prefix="phc_parity_records_")
    records = {}
    for task in (TASKS if args.task == "all" else (args.task,)):
        records[task], _ = run_task(task, args.device, args.smoke, out)
        report(records[task], committed_record(task))
    print(f"records -> {out}", flush=True)
    return records


if __name__ == "__main__":
    main()
