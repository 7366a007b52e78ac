"""Dataset statistics the models need at build time.

A copy of ``degree_histogram`` and ``avg_deg_from_histogram`` from
phc_gnn_tpu/data/datasets.py:156-177 (numpy only): the PNA conv's degree
statistics from the in-degree histogram of a list of graph dicts (``{"x":
[n, F], "edge_index": [2, e], ...}``, as ``data.synthetic.random_graph``
makes them).
"""

from __future__ import annotations

from typing import List

import numpy as np

__all__ = ["degree_histogram", "avg_deg_from_histogram"]


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
