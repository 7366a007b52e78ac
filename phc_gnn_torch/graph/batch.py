"""Statically padded edge-list graph batches, and the CSR plan of the kernels.

Counterpart of phc_gnn_tpu/graph/batch.py.  A batch of disjoint graphs is
padded to fixed ``(num_nodes, num_edges, num_graphs)`` bucket sizes:

- padding *nodes* live at the tail, assigned to the padding graph (the last
  graph slot) with ``node_mask=False``;
- padding *edges* point sender and receiver at the last (padding) node with
  ``edge_mask=False``;
- padding *graphs* carry ``graph_mask=False`` and NaN labels.

``attach_csr_plan`` is the counterpart of ``attach_scan_plan``
(phc_gnn_tpu/ops/stream_scan.py:261): it adds the receiver CSR ``rowptr``
that the softmax kernels walk, and the sender CSR (``snd_perm``,
``snd_rowptr``) that the backward of the message gather walks.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["GraphsTuple", "batch_graphs", "build_csr_rowptr", "build_sender_csr",
           "attach_csr_plan", "pad_graph_batch", "stack_batches",
           "unstack_batches"]


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
    # CSR over the edges in sender order (build_sender_csr): sender n's edges
    # are snd_perm[snd_rowptr[n]:snd_rowptr[n+1]]; masked edges are in none
    snd_perm: Optional[torch.Tensor] = None    # [E_pad] int32
    snd_rowptr: Optional[torch.Tensor] = None  # [N_pad + 1] int32

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

    def tensors(self):
        """``(name, tensor)`` of every field that holds a tensor."""
        return [(f.name, getattr(self, f.name))
                for f in dataclasses.fields(self)
                if getattr(self, f.name) is not None]

    def shape_key(self) -> tuple:
        """Every tensor field's name, shape and dtype: batches with equal
        keys fit the same static buffers (``copy_``)."""
        return tuple((name, tuple(t.shape), t.dtype)
                     for name, t in self.tensors())

    def empty_like(self, device) -> "GraphsTuple":
        """A batch of new, uninitialised tensors of this batch's shapes and
        dtypes on ``device``: static buffers for ``copy_``.  Each is a fresh
        allocation, so it starts on a 16-byte boundary (the caching
        allocator's blocks are 512-byte aligned), as the kernels' plans
        assume of an eager batch's tensors."""
        return dataclasses.replace(self, **{
            name: torch.empty(t.shape, dtype=t.dtype, device=device)
            for name, t in self.tensors()})

    def copy_(self, src: "GraphsTuple") -> "GraphsTuple":
        """Copy ``src``'s tensors into this batch's own, in place (CSR plans
        included), without a host sync; raises unless ``src`` has the same
        ``shape_key``."""
        if src.shape_key() != self.shape_key():
            raise ValueError(f"batch of shapes {src.shape_key()} does not fit "
                             f"buffers of shapes {self.shape_key()}")
        for name, t in self.tensors():
            t.copy_(getattr(src, name), non_blocking=True)
        return self


def stack_batches(batches: Sequence[GraphsTuple]) -> GraphsTuple:
    """Same-shape batches stacked along a new leading step axis [S, ...] (the
    scanned steps' input layout in JAX); ``unstack_batches`` undoes it."""
    if not batches:
        raise ValueError("no batches to stack")
    key = batches[0].shape_key()
    for b in batches[1:]:
        if b.shape_key() != key:
            raise ValueError(f"batches of different shapes: {b.shape_key()} "
                             f"and {key}")
    return dataclasses.replace(batches[0], **{
        name: torch.stack([getattr(b, name) for b in batches])
        for name, _ in batches[0].tensors()})


def unstack_batches(stacked: GraphsTuple) -> list:
    """The batches of a stack made by ``stack_batches``, as views."""
    fields = stacked.tensors()
    return [dataclasses.replace(stacked, **{name: t[i] for name, t in fields})
            for i in range(stacked.senders.shape[0])]


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


def pad_graph_batch(batch: GraphsTuple, num_nodes: int, num_edges: int,
                    num_graphs: int) -> GraphsTuple:
    """Pad an existing batch up to larger static sizes (a bucket promote;
    phc_gnn_tpu/graph/batch.py:170-190), with the batcher's fills: padding
    edges point at the new last node, padding nodes belong to the new last
    graph, masks False, labels NaN.  The CSR plans do not survive re-padding
    and are dropped, as JAX drops its scan plan; ``attach_csr_plan`` makes
    the new batch's."""
    def pad_to(t, size, fill=0):
        pad = size - t.shape[0]
        if pad <= 0:
            return t
        tail = torch.full((pad,) + tuple(t.shape[1:]), fill, dtype=t.dtype,
                          device=t.device)
        return torch.cat([t, tail])

    return GraphsTuple(
        nodes=pad_to(batch.nodes, num_nodes),
        edges=pad_to(batch.edges, num_edges),
        senders=pad_to(batch.senders, num_edges, num_nodes - 1),
        receivers=pad_to(batch.receivers, num_edges, num_nodes - 1),
        graph_ids=pad_to(batch.graph_ids, num_nodes, num_graphs - 1),
        node_mask=pad_to(batch.node_mask, num_nodes, False),
        edge_mask=pad_to(batch.edge_mask, num_edges, False),
        graph_mask=pad_to(batch.graph_mask, num_graphs, False),
        y=(pad_to(batch.y, num_graphs, float("nan"))
           if batch.y is not None else None))


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


def build_sender_csr(senders: np.ndarray, num_nodes: int,
                     edge_mask: Optional[np.ndarray] = None):
    """The sender plan of the message gather's backward: ``(perm [E] int32,
    rowptr [num_nodes + 1] int32)``.

    The rule of ``build_sender_plan`` (phc_gnn_tpu/ops/stream_scan.py:230-258):
    ``perm`` is a stable sort by sender in which EVERY masked edge sorts last,
    whatever its sender, and ``rowptr`` covers the sorted real edges only, so
    ``rowptr[-1]`` is the number of real edges and masked edges belong to no
    segment (their cotangents never reach ``dx``)."""
    senders = np.asarray(senders, np.int64)
    if senders.ndim != 1:
        raise ValueError("senders must be 1-D")
    if senders.shape[0] >= 2 ** 31:
        raise ValueError("the sender plan indexes edges with int32")
    real = (np.ones(senders.shape, bool) if edge_mask is None
            else np.asarray(edge_mask, bool))
    if np.any(senders[real] < 0) or np.any(senders[real] >= num_nodes):
        raise ValueError("sender index out of range")
    perm = np.argsort(np.where(real, senders, num_nodes), kind="stable")
    rowptr = np.zeros(num_nodes + 1, np.int32)
    rowptr[1:] = np.cumsum(np.bincount(senders[real], minlength=num_nodes))
    return perm.astype(np.int32), rowptr


def attach_csr_plan(batch: GraphsTuple) -> GraphsTuple:
    """Host-side: a copy of ``batch`` carrying its receiver CSR ``rowptr`` and
    its sender CSR ``snd_perm`` / ``snd_rowptr`` (on the device of
    ``batch.receivers``)."""
    emask = batch.edge_mask.cpu().numpy()
    rowptr = build_csr_rowptr(batch.receivers.cpu().numpy(), batch.num_nodes,
                              emask)
    perm, snd_rowptr = build_sender_csr(batch.senders.cpu().numpy(),
                                        batch.num_nodes, emask)
    dev = batch.receivers.device
    return batch.replace(rowptr=torch.from_numpy(rowptr).to(dev),
                         snd_perm=torch.from_numpy(perm).to(dev),
                         snd_rowptr=torch.from_numpy(snd_rowptr).to(dev))
