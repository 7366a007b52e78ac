"""Deterministic synthetic molecular datasets for full-pipeline runs: a
copy of phc_gnn_tpu/data/parity.py with the same ``np.random.default_rng``
call order, so both packages write the same datasets, byte for byte, from
one seed.

~6k molecular-like graphs a task whose targets come from a fixed "teacher"
function of graph structure (learnable signal), so a trained run moves the
validation metric far from its first epoch's, with nothing downloaded.

Three tasks, mirroring the reference configurations:

- ``zinc``: the ZINC-subset schema (1 categorical atom column with 28
  types, 1 bond column with 4 types, a scalar regression target), written
  as the ``zinc_{train,valid,test}.npz`` files ``load_npz_dataset`` reads;
- ``hiv``: the ogbg-molhiv schema (9 OGB atom columns, 3 bond columns, one
  binary target), written as an OGB-format ``raw/ + split/scaffold/``
  directory (``load_ogb_graphproppred``);
- ``pcba``: the hiv featurization with 8 binary tasks, 5 % of the labels
  flipped and half of them missing (NaN), as an ``ogbg_molpcba`` directory.

Topology: a random tree (recency-biased attachment, chain-like as molecules
are) plus 0-2 ring-closing edges; every edge stored in both directions (OGB
convention).
"""

from __future__ import annotations

import gzip
import os
from typing import Dict, List

import numpy as np

from phc_gnn_torch.data.features import (
    ATOM_FEATURE_DIMS,
    BOND_FEATURE_DIMS,
    ZINC_ATOM_DIMS,
    ZINC_BOND_DIMS,
)

__all__ = ["make_parity_graphs", "write_zinc_npz", "write_ogb_dir",
           "generate_parity_dataset", "PARITY_SPLITS"]

PARITY_SPLITS = {"train": 6000, "valid": 800, "test": 800}


def _topology(rng) -> tuple:
    """Random molecule-like graph: tree + ring closures, undirected.

    Returns (pairs [m, 2] one direction each, n_nodes, n_rings)."""
    n = 9 + int(min(rng.poisson(9), 29))  # 9..38 heavy atoms
    parents = np.array([int(rng.integers(max(0, i - 4), i))
                        for i in range(1, n)], np.int64)
    pairs = {(p, c + 1) for c, p in enumerate(parents)}
    n_rings = int(rng.binomial(3, 0.35))
    made = 0
    for _ in range(n_rings):
        a, b = sorted(rng.integers(0, n, size=2).tolist())
        if a != b and (a, b) not in pairs and (b, a) not in pairs:
            pairs.add((a, b))
            made += 1
    arr = np.array(sorted(pairs), np.int64)
    return arr, n, made


def _both_dirs(pairs: np.ndarray) -> np.ndarray:
    """[m, 2] one-direction pairs -> [2, 2m] edge_index, interleaved like the
    OGB raw files (u->v immediately followed by v->u)."""
    fwd = pairs.T
    bwd = pairs[:, ::-1].T
    ei = np.empty((2, 2 * pairs.shape[0]), np.int64)
    ei[:, 0::2] = fwd
    ei[:, 1::2] = bwd
    return ei


# Teacher weights are drawn once from fixed sub-seeds so targets are a stable
# function of the graph regardless of how many graphs are generated.
_ZINC_W = np.random.default_rng(714).normal(size=ZINC_ATOM_DIMS[0])
_ZINC_B = np.random.default_rng(715).normal(size=ZINC_BOND_DIMS[0])
_HIV_W = np.random.default_rng(716).normal(size=ATOM_FEATURE_DIMS[0])
_PCBA_NT = 8  # multi-task count of the pcba-like parity task
_PCBA_W = np.random.default_rng(923).normal(
    size=(_PCBA_NT, ATOM_FEATURE_DIMS[0]))
_PCBA_C = np.random.default_rng(531).normal(size=(_PCBA_NT, 3))


def _zinc_graph(rng) -> dict:
    pairs, n, rings = _topology(rng)
    # skewed atom-type distribution (carbon-heavy, like ZINC)
    x = np.minimum(rng.geometric(0.35, size=n) - 1, ZINC_ATOM_DIMS[0] - 1)
    ea_half = np.minimum(rng.geometric(0.55, size=pairs.shape[0]) - 1,
                         ZINC_BOND_DIMS[0] - 1)
    ei = _both_dirs(pairs)
    edge_attr = np.repeat(ea_half, 2)
    deg = np.bincount(ei[1], minlength=n)
    y = (_ZINC_W[x].sum() / np.sqrt(n)
         + 0.6 * _ZINC_B[ea_half].mean()
         + 0.9 * rings
         + 0.4 * float(deg.std())
         + rng.normal() * 0.05)
    return {"x": x.reshape(-1, 1).astype(np.int64),
            "edge_index": ei,
            "edge_attr": edge_attr.reshape(-1, 1).astype(np.int64),
            "y": np.array([y], np.float32)}


def _hiv_graph(rng) -> dict:
    pairs, n, rings = _topology(rng)
    x = np.empty((n, len(ATOM_FEATURE_DIMS)), np.int64)
    x[:, 0] = np.minimum(rng.geometric(0.30, size=n) - 1,
                         ATOM_FEATURE_DIMS[0] - 1)
    for c, d in enumerate(ATOM_FEATURE_DIMS[1:], start=1):
        x[:, c] = rng.integers(0, d, size=n)
    m = pairs.shape[0]
    e_half = np.empty((m, len(BOND_FEATURE_DIMS)), np.int64)
    for c, d in enumerate(BOND_FEATURE_DIMS):
        e_half[:, c] = rng.integers(0, d, size=m)
    ei = _both_dirs(pairs)
    edge_attr = np.repeat(e_half, 2, axis=0)
    deg = np.bincount(ei[1], minlength=n)
    score = (_HIV_W[x[:, 0]].sum() / np.sqrt(n)
             + 0.8 * rings
             + 0.5 * float(deg.std())
             + 0.3 * float(x[:, 3].mean())
             + rng.normal() * 0.35)
    return {"x": x, "edge_index": ei,
            "edge_attr": edge_attr,
            "_score": score}


def _pcba_graph(rng) -> dict:
    """hiv-like featurization with _PCBA_NT per-task teacher scores (each
    task mixes its own atom-type weights with ring/degree/column-3 structure
    — reference benchmarks/train_pcba.py's multi-task setting)."""
    g = _hiv_graph(rng)
    x, ei = g["x"], g["edge_index"]
    n = x.shape[0]
    deg = np.bincount(ei[1], minlength=n)
    base = np.array([float(deg.std()), float(x[:, 3].mean()), 1.0])
    g.pop("_score")  # drop _hiv_graph's single-task teacher
    feats = _PCBA_W[:, x[:, 0]].sum(axis=1) / np.sqrt(n)
    g["_scores"] = (feats + _PCBA_C @ base
                    + rng.normal(size=_PCBA_NT) * 0.35)
    return g


def make_parity_graphs(task: str, seed: int = 0,
                       splits: Dict[str, int] = None) -> Dict[str, List[dict]]:
    """Generate the split dict deterministically.  For the hiv task, the
    binary threshold is the train-split score median (≈50 % positives) and
    5 % label noise is injected — an irreducible error floor that keeps
    ROC-AUC off 1.0 and the comparison honest."""
    splits = dict(PARITY_SPLITS if splits is None else splits)
    out: Dict[str, List[dict]] = {}
    for si, (part, count) in enumerate(sorted(splits.items())):
        rng = np.random.default_rng(seed * 1009 + 17 * si + 3)
        gen = {"zinc": _zinc_graph, "hiv": _hiv_graph,
               "pcba": _pcba_graph}[task]
        out[part] = [gen(rng) for _ in range(count)]
    if task == "zinc":
        # standardize by train statistics: the raw teacher carries a large
        # type-frequency offset; centered targets make MAE read like ZINC's
        # (random ≈ 1, trained ≪ 1) instead of measuring bias-learning
        ys = np.array([g["y"][0] for g in out["train"]])
        mu, sd = float(ys.mean()), float(ys.std())
        for graphs in out.values():
            for g in graphs:
                g["y"] = ((g["y"] - mu) / sd).astype(np.float32)
    if task == "hiv":
        thr = float(np.median([g["_score"] for g in out["train"]]))
        for si, (part, graphs) in enumerate(sorted(out.items())):
            rng = np.random.default_rng(seed * 2017 + 31 * si + 5)
            for g in graphs:
                label = float(g.pop("_score") > thr)
                if rng.random() < 0.05:
                    label = 1.0 - label
                g["y"] = np.array([label], np.float32)
    if task == "pcba":
        # per-task median thresholds + 5 % flip noise + 50 % NaN holes (the
        # molpcba label pattern the masked-BCE / AP path must handle)
        scores = np.stack([g["_scores"] for g in out["train"]])
        thr = np.median(scores, axis=0)
        for si, (part, graphs) in enumerate(sorted(out.items())):
            rng = np.random.default_rng(seed * 3023 + 41 * si + 7)
            for g in graphs:
                y = (g.pop("_scores") > thr).astype(np.float32)
                flip = rng.random(_PCBA_NT) < 0.05
                y[flip] = 1.0 - y[flip]
                y[rng.random(_PCBA_NT) < 0.5] = np.nan
                g["y"] = y
    return out


def write_zinc_npz(root: str, data: Dict[str, List[dict]]) -> None:
    """Write load_npz_dataset's schema (datasets.py:111-145)."""
    os.makedirs(root, exist_ok=True)
    for part, graphs in data.items():
        node_ptr = np.cumsum([0] + [g["x"].shape[0] for g in graphs])
        edge_ptr = np.cumsum([0] + [g["edge_index"].shape[1] for g in graphs])
        ei = np.concatenate(
            [g["edge_index"] + off for g, off in zip(graphs, node_ptr[:-1])],
            axis=1)
        np.savez(os.path.join(root, f"zinc_{part}.npz"),
                 x=np.concatenate([g["x"] for g in graphs]),
                 edge_index=ei,
                 edge_attr=np.concatenate([g["edge_attr"] for g in graphs]),
                 y=np.stack([g["y"] for g in graphs]),
                 node_ptr=node_ptr, edge_ptr=edge_ptr)


def _write_csv_gz(path: str, arr: np.ndarray, fmt: str) -> None:
    with gzip.open(path, "wt", newline="") as f:
        np.savetxt(f, np.atleast_2d(arr.T if arr.ndim == 1 else arr),
                   fmt=fmt, delimiter=",")


def write_ogb_dir(root: str, data: Dict[str, List[dict]]) -> None:
    """Write the official OGB graph-prop-pred raw/ + split/ layout
    (what load_ogb_graphproppred parses and PygGraphPropPredDataset ships)."""
    raw = os.path.join(root, "raw")
    spl = os.path.join(root, "split", "scaffold")
    os.makedirs(raw, exist_ok=True)
    os.makedirs(spl, exist_ok=True)
    order = ["train", "valid", "test"]
    all_graphs = [g for part in order for g in data[part]]
    _write_csv_gz(os.path.join(raw, "edge.csv.gz"),
                  np.concatenate([g["edge_index"].T for g in all_graphs]),
                  "%d")
    _write_csv_gz(os.path.join(raw, "node-feat.csv.gz"),
                  np.concatenate([g["x"] for g in all_graphs]), "%d")
    _write_csv_gz(os.path.join(raw, "edge-feat.csv.gz"),
                  np.concatenate([g["edge_attr"] for g in all_graphs]), "%d")
    _write_csv_gz(os.path.join(raw, "num-node-list.csv.gz"),
                  np.array([g["x"].shape[0] for g in all_graphs]), "%d")
    _write_csv_gz(os.path.join(raw, "num-edge-list.csv.gz"),
                  np.array([g["edge_index"].shape[1] for g in all_graphs]),
                  "%d")
    _write_csv_gz(os.path.join(raw, "graph-label.csv.gz"),
                  np.stack([g["y"] for g in all_graphs]), "%g")
    off = 0
    for part in order:
        idx = np.arange(off, off + len(data[part]))
        _write_csv_gz(os.path.join(spl, f"{part}.csv.gz"), idx, "%d")
        off += len(data[part])


def generate_parity_dataset(task: str, root: str, seed: int = 0,
                            splits: Dict[str, int] = None) -> str:
    """Generate + write; returns the directory our CLI's --data_root needs."""
    data = make_parity_graphs(task, seed=seed, splits=splits)
    if task == "zinc":
        write_zinc_npz(root, data)
        return root
    dirname = {"hiv": "ogbg_molhiv", "pcba": "ogbg_molpcba"}[task]
    write_ogb_dir(os.path.join(root, dirname), data)
    return root
