"""Dataset readers and statistics: a copy of phc_gnn_tpu/data/datasets.py
(numpy only, no ogb or torch_geometric).

Each reader parses a dataset's standard on-disk format from a local
directory:

- OGB graph-prop-pred (ogbg-molhiv, ogbg-molpcba, ogbg-ppa): the official
  ``raw/*.csv.gz`` layout (edge.csv.gz, node-feat.csv.gz, edge-feat.csv.gz,
  num-node-list.csv.gz, num-edge-list.csv.gz, graph-label.csv.gz) plus
  ``split/<name>/{train,valid,test}.csv.gz``, as
  ``ogb.graphproppred.PygGraphPropPredDataset`` downloads it;
- ZINC-subset, MNIST and CIFAR10 superpixels: one ``.npz`` a split
  (``load_npz_dataset``), convertible from the PyG datasets with
  ``scripts/convert_pyg_dataset.py``.

Readers return ``{"train": [graph...], "valid": [...], "test": [...]}``,
each graph a dict ``{"x", "edge_index", "edge_attr", "y", ["pos"]}``.
``degree_histogram`` and ``avg_deg_from_histogram`` give the PNA conv's
degree statistics.
"""

from __future__ import annotations

import csv
import gzip
import os
from typing import Dict, List

import numpy as np

__all__ = ["load_ogb_graphproppred", "load_npz_dataset", "dataset_stats",
           "degree_histogram", "avg_deg_from_histogram"]


def _read_csv_gz(path: str, dtype=np.int64) -> np.ndarray:
    """Read a (possibly gzipped) headerless numeric csv into a 2-D array."""
    opener = gzip.open if path.endswith(".gz") else open
    rows: List[List[float]] = []
    with opener(path, "rt", newline="") as f:
        for row in csv.reader(f):
            if row:
                rows.append([float(v) if v not in ("", "nan") else np.nan
                             for v in row])
    arr = np.asarray(rows)
    # cast to the integer dtype only when the data is genuinely integral
    # (ogbg-ppa ships continuous float edge features in the same layout)
    if not np.isnan(arr).any() and np.array_equal(arr, np.round(arr)):
        arr = arr.astype(dtype)
    return arr


def load_ogb_graphproppred(root: str, split_name: str = "scaffold",
                           undirected_already: bool = True
                           ) -> Dict[str, List[dict]]:
    """Parse an OGB graph-property-prediction dataset directory.

    ``root`` is the dataset dir containing ``raw/`` and ``split/``
    (e.g. <data>/ogbg_molhiv).  Edge lists in OGB raw files already contain
    both directions for molecular graphs."""
    raw = os.path.join(root, "raw")
    if not os.path.isdir(raw):
        raise FileNotFoundError(
            f"OGB raw dir not found at {raw}; download the dataset with the "
            "ogb package elsewhere and point root at it")
    edges = _read_csv_gz(os.path.join(raw, "edge.csv.gz"), np.int32)
    num_nodes = _read_csv_gz(os.path.join(raw, "num-node-list.csv.gz"),
                             np.int64).ravel()
    num_edges = _read_csv_gz(os.path.join(raw, "num-edge-list.csv.gz"),
                             np.int64).ravel()
    labels = _read_csv_gz(os.path.join(raw, "graph-label.csv.gz"), np.float32)
    node_feat_p = os.path.join(raw, "node-feat.csv.gz")
    edge_feat_p = os.path.join(raw, "edge-feat.csv.gz")
    node_feat = (_read_csv_gz(node_feat_p, np.int32)
                 if os.path.exists(node_feat_p) else None)
    edge_feat = (_read_csv_gz(edge_feat_p, np.int32)
                 if os.path.exists(edge_feat_p) else None)

    graphs: List[dict] = []
    n_off = e_off = 0
    for n, e in zip(num_nodes, num_edges):
        n, e = int(n), int(e)
        graphs.append({
            "x": (node_feat[n_off:n_off + n] if node_feat is not None
                  else np.zeros((n, 1), np.int32)),
            "edge_index": edges[e_off:e_off + e].T.astype(np.int32),  # [2, e]
            "edge_attr": (edge_feat[e_off:e_off + e] if edge_feat is not None
                          else np.zeros((e, 1), np.int32)),
            "y": labels[len(graphs)],
        })
        n_off += n
        e_off += e

    split_dir = os.path.join(root, "split", split_name)
    out: Dict[str, List[dict]] = {}
    for part in ("train", "valid", "test"):
        idx = _read_csv_gz(os.path.join(split_dir, f"{part}.csv.gz"),
                           np.int64).ravel()
        out[part] = [graphs[int(i)] for i in idx]
    return out


def load_npz_dataset(root: str, name: str) -> Dict[str, List[dict]]:
    """Load ``<root>/<name>_{train,valid,test}.npz``, each with the arrays
    ``x`` [total_nodes, Fx], ``edge_index`` [2, total_edges] (graph-local
    after the node offset is subtracted), ``edge_attr`` [total_edges, Fe],
    ``y`` [num_graphs, T], ``node_ptr`` and ``edge_ptr`` [num_graphs + 1],
    and for superpixels ``pos`` [total_nodes, 2]."""
    out: Dict[str, List[dict]] = {}
    for part in ("train", "valid", "test"):
        path = os.path.join(root, f"{name}_{part}.npz")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"{path} missing; create it with scripts/convert_pyg_dataset.py")
        z = np.load(path, allow_pickle=False)
        node_ptr, edge_ptr = z["node_ptr"], z["edge_ptr"]
        x, ei, ea, y = z["x"], z["edge_index"], z["edge_attr"], z["y"]
        pos = z["pos"] if "pos" in z else None
        graphs = []
        for gi in range(len(node_ptr) - 1):
            nlo, nhi = int(node_ptr[gi]), int(node_ptr[gi + 1])
            elo, ehi = int(edge_ptr[gi]), int(edge_ptr[gi + 1])
            g = {"x": x[nlo:nhi], "edge_index": ei[:, elo:ehi] - nlo,
                 "edge_attr": ea[elo:ehi], "y": y[gi]}
            if pos is not None:
                g["pos"] = pos[nlo:nhi]
            graphs.append(g)
        out[part] = graphs
    return out


def dataset_stats(graphs: List[dict]) -> dict:
    """Graph count and the mean and largest node and edge counts."""
    n = np.asarray([g["x"].shape[0] for g in graphs])
    e = np.asarray([g["edge_index"].shape[1] for g in graphs])
    return {"num_graphs": len(graphs), "nodes_mean": float(n.mean()),
            "nodes_max": int(n.max()), "edges_mean": float(e.mean()),
            "edges_max": int(e.max())}


def degree_histogram(graphs: List[dict], max_degree: int = 64) -> np.ndarray:
    """In-degree histogram ``[max_degree + 1]`` over every node of
    ``graphs``, degrees above ``max_degree`` counted at it."""
    hist = np.zeros(max_degree + 1, np.int64)
    for g in graphs:
        deg = np.bincount(g["edge_index"][1], minlength=g["x"].shape[0])
        deg = np.clip(deg, 0, max_degree)
        hist += np.bincount(deg, minlength=max_degree + 1)
    return hist


def avg_deg_from_histogram(hist: np.ndarray) -> dict:
    """PNA degree statistics ``{lin, log, exp}``: the mean of the degree,
    of ``log(deg + 1)`` and of ``exp(min(deg, 30))`` under the histogram
    (reference: messagepassing.py:376-381)."""
    deg = np.arange(len(hist), dtype=np.float64)
    weights = hist / max(hist.sum(), 1)
    return {
        "lin": float((deg * weights).sum()),
        "log": float((np.log(deg + 1) * weights).sum()),
        "exp": float((np.exp(np.minimum(deg, 30)) * weights).sum()),
    }
