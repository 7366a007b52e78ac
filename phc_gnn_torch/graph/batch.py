"""Statically padded edge-list graph batches, and the CSR plan of the kernels.

Counterpart of phc_gnn_tpu/graph/batch.py.  A batch of disjoint graphs is
padded to fixed ``(num_nodes, num_edges, num_graphs)`` bucket sizes:

- padding *nodes* live at the tail, assigned to the padding graph (the last
  graph slot) with ``node_mask=False``;
- padding *edges* point sender and receiver at the last (padding) node with
  ``edge_mask=False``;
- padding *graphs* carry ``graph_mask=False`` and NaN labels.

``attach_csr_plan`` is the counterpart of ``attach_scan_plan``
(phc_gnn_tpu/ops/stream_scan.py:261): it adds the CSR ``rowptr`` that the
segment kernels walk.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["GraphsTuple", "batch_graphs", "build_csr_rowptr", "attach_csr_plan"]


@dataclasses.dataclass(frozen=True)
class GraphsTuple:
    """A padded batch of disjoint graphs; edge arrays are receiver-sorted."""

    nodes: torch.Tensor       # [N_pad, ...] node features (int categorical or float)
    edges: torch.Tensor       # [E_pad, ...] edge features
    senders: torch.Tensor     # [E_pad] int32 source node index
    receivers: torch.Tensor   # [E_pad] int32 destination node index
    graph_ids: torch.Tensor   # [N_pad] int32 node -> graph index
    node_mask: torch.Tensor   # [N_pad] bool
    edge_mask: torch.Tensor   # [E_pad] bool
    graph_mask: torch.Tensor  # [G_pad] bool
    y: Optional[torch.Tensor] = None       # [G_pad, target_dim] (NaN = missing)
    # CSR over the receiver-sorted edges (attach_csr_plan): node n's segment
    # is edges rowptr[n]..rowptr[n+1]; the trailing padding run is in none
    rowptr: Optional[torch.Tensor] = None  # [N_pad + 1] int32

    @property
    def num_nodes(self) -> int:
        return self.nodes.shape[0]

    @property
    def num_edges(self) -> int:
        return self.senders.shape[0]

    @property
    def num_graphs(self) -> int:
        return self.graph_mask.shape[0]

    def count_edges(self) -> int:
        return int(self.edge_mask.sum())

    def replace(self, **changes) -> "GraphsTuple":
        return dataclasses.replace(self, **changes)

    def to(self, device, non_blocking: bool = False) -> "GraphsTuple":
        """A copy with every tensor on ``device``."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device, non_blocking=non_blocking)
            for f in dataclasses.fields(self)
            if getattr(self, f.name) is not None})


def batch_graphs(
    graphs: Sequence[dict],
    num_nodes: int,
    num_edges: int,
    num_graphs: int,
    y_shape: Optional[tuple] = None,
    node_dtype=None,
    edge_dtype=None,
    sort_edges_by_receiver: bool = True,
) -> GraphsTuple:
    """Host-side collation of per-graph dicts into one padded GraphsTuple on
    the CPU (phc_gnn_tpu/graph/batch.py:86-167).

    Each graph dict: {"x": [n, Fx], "edge_index": [2, e] (senders; receivers),
    "edge_attr": [e, Fe], "y": [target]}.  Edges are sorted by receiver (stable)
    unless ``sort_edges_by_receiver`` is False.  Padding edges attach to the
    last node slot; padding nodes to the last graph.
    """
    assert len(graphs) <= num_graphs - 1 or all(
        g["x"].shape[0] > 0 for g in graphs
    ), "reserve one padding graph slot"
    total_n = sum(int(g["x"].shape[0]) for g in graphs)
    total_e = sum(int(g["edge_index"].shape[1]) for g in graphs)
    if total_n > num_nodes - 1 or total_e > num_edges or len(graphs) > num_graphs - 1:
        raise ValueError(
            f"batch does not fit bucket: nodes {total_n}/{num_nodes - 1}, "
            f"edges {total_e}/{num_edges}, graphs {len(graphs)}/{num_graphs - 1}")

    fx = graphs[0]["x"].shape[1:] if graphs[0]["x"].ndim > 1 else ()
    fe = graphs[0]["edge_attr"].shape[1:] if graphs[0]["edge_attr"].ndim > 1 else ()

    def _feat_dtype(explicit, arr):
        # keep integer features int32, continuous features float32
        if explicit is not None:
            return explicit
        return (np.int32 if np.issubdtype(np.asarray(arr).dtype, np.integer)
                else np.float32)

    node_dtype = _feat_dtype(node_dtype, graphs[0]["x"])
    edge_dtype = _feat_dtype(edge_dtype, graphs[0]["edge_attr"])
    nodes = np.zeros((num_nodes,) + fx, dtype=node_dtype)
    edges = np.zeros((num_edges,) + fe, dtype=edge_dtype)
    senders = np.full((num_edges,), num_nodes - 1, dtype=np.int32)
    receivers = np.full((num_edges,), num_nodes - 1, dtype=np.int32)
    graph_ids = np.full((num_nodes,), num_graphs - 1, dtype=np.int32)
    node_mask = np.zeros((num_nodes,), dtype=bool)
    edge_mask = np.zeros((num_edges,), dtype=bool)
    graph_mask = np.zeros((num_graphs,), dtype=bool)

    y = None
    if y_shape is not None:
        y = np.full((num_graphs,) + tuple(y_shape), np.nan, dtype=np.float32)

    n_off = e_off = 0
    for gi, g in enumerate(graphs):
        n, e = int(g["x"].shape[0]), int(g["edge_index"].shape[1])
        nodes[n_off:n_off + n] = g["x"]
        graph_ids[n_off:n_off + n] = gi
        node_mask[n_off:n_off + n] = True
        if e:
            edges[e_off:e_off + e] = g["edge_attr"]
            senders[e_off:e_off + e] = g["edge_index"][0] + n_off
            receivers[e_off:e_off + e] = g["edge_index"][1] + n_off
            edge_mask[e_off:e_off + e] = True
        graph_mask[gi] = True
        if y is not None and g.get("y") is not None:
            y[gi] = np.asarray(g["y"], dtype=np.float32).reshape(y_shape)
        n_off += n
        e_off += e

    if sort_edges_by_receiver:
        order = np.argsort(receivers, kind="stable")
        edges, senders, receivers, edge_mask = (
            edges[order], senders[order], receivers[order], edge_mask[order])

    t = torch.from_numpy
    return GraphsTuple(
        nodes=t(nodes), edges=t(edges), senders=t(senders),
        receivers=t(receivers), graph_ids=t(graph_ids),
        node_mask=t(node_mask), edge_mask=t(edge_mask),
        graph_mask=t(graph_mask), y=t(y) if y is not None else None)


def build_csr_rowptr(receivers: np.ndarray, num_nodes: int,
                     edge_mask: Optional[np.ndarray] = None) -> np.ndarray:
    """CSR row pointers [num_nodes + 1] (int32) over receiver-sorted edges.

    The mask-aware rule of ``build_scan_plan``
    (phc_gnn_tpu/ops/stream_scan.py:202-227): with ``edge_mask``, the
    TRAILING all-masked run (the batcher's padding edges, all pointing at the
    last node) is excluded from every segment, so ``rowptr[-1]`` is one past
    the last real edge.  Masked edges among real ones stay in their segment;
    the kernels mask them."""
    receivers = np.asarray(receivers, np.int64)
    if receivers.ndim != 1 or np.any(receivers[1:] < receivers[:-1]):
        raise ValueError("the CSR plan needs receiver-sorted edges")
    if receivers.size and (receivers[0] < 0 or receivers[-1] >= num_nodes):
        raise ValueError("receiver index out of range")
    if receivers.shape[0] >= 2 ** 31:
        raise ValueError("the CSR plan indexes edges with int32")
    split = receivers.shape[0]
    if edge_mask is not None:
        nz = np.nonzero(np.asarray(edge_mask, bool))[0]
        split = int(nz[-1]) + 1 if nz.size else 0
    rowptr = np.zeros(num_nodes + 1, np.int32)
    rowptr[1:] = np.cumsum(np.bincount(receivers[:split], minlength=num_nodes))
    return rowptr


def attach_csr_plan(batch: GraphsTuple) -> GraphsTuple:
    """Host-side: a copy of ``batch`` carrying its CSR ``rowptr`` (on the
    device of ``batch.receivers``)."""
    rowptr = build_csr_rowptr(batch.receivers.cpu().numpy(), batch.num_nodes,
                              batch.edge_mask.cpu().numpy())
    return batch.replace(
        rowptr=torch.from_numpy(rowptr).to(batch.receivers.device))
