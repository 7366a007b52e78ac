"""Host-side per-graph transforms (numpy), applied before padding: a copy
of phc_gnn_tpu/data/transforms.py.

Counterparts of the reference's dataset transforms:
- remove_isolated_nodes: CustomRemoveIsolatedNodes (benchmarks/utils.py:39-52,
  applied per batch in train_hiv.py:457,172)
- concat_x_pos: MNIST/CIFAR superpixels x <- [x, pos], edge_attr unsqueeze
  (train_mnist.py:165-171)
- add_zeros: ogbg-ppa all-zero categorical node feature (train_ppa.py:158-160)
- extract_node_feature: ogbg-ppa node features from aggregated incoming edge
  features (train_ppa.py:163-172)
- add_virtual_node: an OGB-baseline virtual node per graph
"""

from __future__ import annotations

import numpy as np

__all__ = ["remove_isolated_nodes", "concat_x_pos", "add_zeros",
           "extract_node_feature", "add_virtual_node",
           "grow_vocab_for_virtual_node"]


def remove_isolated_nodes(graph: dict) -> dict:
    """Drop nodes with no incident edges, remapping edge indices."""
    n = graph["x"].shape[0]
    ei = graph["edge_index"]
    used = np.zeros(n, bool)
    used[ei[0]] = True
    used[ei[1]] = True
    if used.all():
        return graph
    new_idx = np.cumsum(used) - 1
    out = dict(graph)
    out["x"] = graph["x"][used]
    out["edge_index"] = new_idx[ei]
    if graph.get("pos") is not None:
        out["pos"] = graph["pos"][used]
    return out


def concat_x_pos(graph: dict) -> dict:
    """x <- concat(x, pos) as float; edge_attr gets a trailing feature axis."""
    out = dict(graph)
    x = np.asarray(graph["x"], np.float32)
    if x.ndim == 1:
        x = x[:, None]
    pos = np.asarray(graph["pos"], np.float32)
    out["x"] = np.concatenate([x, pos], axis=-1)
    ea = np.asarray(graph["edge_attr"], np.float32)
    if ea.ndim == 1:
        ea = ea[:, None]
    out["edge_attr"] = ea
    return out


def add_zeros(graph: dict) -> dict:
    """All-zero single categorical node feature (ppa 'simple' mode)."""
    out = dict(graph)
    n = (graph["x"].shape[0] if graph.get("x") is not None
         else int(graph["num_nodes"]))
    out["x"] = np.zeros((n, 1), np.int32)
    return out


def extract_node_feature(graph: dict, reduce: str = "add") -> dict:
    """Node features = segment-reduce of incoming edge features (ppa)."""
    assert reduce in ("add", "mean", "max")
    n = (graph["x"].shape[0] if graph.get("x") is not None
         else int(graph["num_nodes"]))
    ea = np.asarray(graph["edge_attr"], np.float32)
    if ea.ndim == 1:
        ea = ea[:, None]
    recv = graph["edge_index"][0]  # reference uses edge_index[0]
    feat = np.zeros((n, ea.shape[1]), np.float32)
    if reduce == "max":
        np.maximum.at(feat, recv, ea)
    else:
        np.add.at(feat, recv, ea)
        if reduce == "mean":
            cnt = np.bincount(recv, minlength=n).astype(np.float32)
            feat /= np.maximum(cnt, 1)[:, None]
    out = dict(graph)
    out["x"] = feat
    return out


def add_virtual_node(graph: dict, atom_vocab_sizes=None,
                     bond_vocab_sizes=None) -> dict:
    """Append a virtual node connected to every real node in both
    directions (OGB-baseline style).  Its categorical features, and its
    edges', take one extra vocabulary index a column (the original vocab
    size), so callers grow ``atom_input_dims`` / ``bond_input_dims`` by one
    (``grow_vocab_for_virtual_node``)."""
    x = np.asarray(graph["x"])
    if x.ndim == 1:
        x = x[:, None]
    n = x.shape[0]
    ea = np.asarray(graph["edge_attr"])
    if ea.ndim == 1:
        ea = ea[:, None]
    if np.issubdtype(x.dtype, np.integer):
        sizes = (atom_vocab_sizes if atom_vocab_sizes is not None
                 else x.max(axis=0) + 1)
        vnode = np.asarray(sizes, x.dtype).reshape(1, -1)
    else:
        vnode = np.zeros((1, x.shape[1]), x.dtype)
    if np.issubdtype(ea.dtype, np.integer):
        esizes = (bond_vocab_sizes if bond_vocab_sizes is not None
                  else (ea.max(axis=0) + 1 if ea.size else np.ones(ea.shape[1])))
        vedge = np.asarray(esizes, ea.dtype).reshape(1, -1)
    else:
        vedge = np.zeros((1, ea.shape[1]), ea.dtype)

    out = dict(graph)
    out["x"] = np.concatenate([x, vnode])
    vn = n  # virtual node index
    new_send = np.concatenate([np.arange(n), np.full(n, vn)]).astype(np.int32)
    new_recv = np.concatenate([np.full(n, vn), np.arange(n)]).astype(np.int32)
    ei = np.asarray(graph["edge_index"])
    out["edge_index"] = np.concatenate(
        [ei, np.stack([new_send, new_recv])], axis=1).astype(np.int32)
    out["edge_attr"] = np.concatenate([ea, np.repeat(vedge, 2 * n, axis=0)])
    return out


def grow_vocab_for_virtual_node(dims):
    """Vocab sizes grown by one for the virtual-node sentinel index."""
    if isinstance(dims, int):
        return dims
    return [d + 1 for d in dims]
