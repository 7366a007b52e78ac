"""Synthetic molecular-like graphs for tests and benchmarks.

A copy of phc_gnn_tpu/data/synthetic.py: the same ``np.random.default_rng``
call sequence, so both packages build bit-identical batches from one seed.
ZINC-shaped: ~23 nodes and ~50 directed edges per graph, categorical atom and
bond features.
"""

from __future__ import annotations

from typing import List

import numpy as np

from phc_gnn_torch.graph.batch import GraphsTuple, batch_graphs

__all__ = ["random_graph", "synthetic_batch"]


def random_graph(rng: np.random.Generator, num_atom_types: int = 28,
                 num_bond_types: int = 4, mean_nodes: int = 23,
                 target_dim: int = 1, num_node_feats: int = 1,
                 num_edge_feats: int = 1) -> dict:
    n = max(2, int(rng.poisson(mean_nodes)))
    # random connected-ish molecular graph: a path + random extra edges
    src = list(range(n - 1))
    dst = list(range(1, n))
    extra = max(0, int(rng.poisson(n * 0.15)))
    for _ in range(extra):
        a, b = rng.integers(0, n, 2)
        if a != b:
            src.append(int(a))
            dst.append(int(b))
    # undirected -> both directions
    senders = np.asarray(src + dst, np.int32)
    receivers = np.asarray(dst + src, np.int32)
    e = senders.shape[0]
    x = rng.integers(0, num_atom_types, size=(n, num_node_feats)).astype(np.int32)
    edge_attr = rng.integers(0, num_bond_types, size=(e, num_edge_feats)).astype(np.int32)
    # target correlated with graph size (learnable signal)
    y = np.asarray([n / mean_nodes - 1.0] * target_dim, np.float32)
    return {"x": x, "edge_index": np.stack([senders, receivers]),
            "edge_attr": edge_attr, "y": y}


def synthetic_batch(batch_size: int = 32, num_nodes: int = 1024,
                    num_edges: int = 2048, seed: int = 0,
                    target_dim: int = 1, **kwargs) -> GraphsTuple:
    """A padded batch of ``batch_size`` random graphs, on the CPU."""
    rng = np.random.default_rng(seed)
    graphs: List[dict] = [random_graph(rng, target_dim=target_dim, **kwargs)
                          for _ in range(batch_size)]
    return batch_graphs(graphs, num_nodes=num_nodes, num_edges=num_edges,
                        num_graphs=batch_size + 1, y_shape=(target_dim,))
