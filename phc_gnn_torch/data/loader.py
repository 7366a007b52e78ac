"""Bucketed padded batch loader: the counterpart of
phc_gnn_tpu/data/loader.py:29-178.

Packs shuffled graph lists into fixed-size padded ``GraphsTuple`` buckets,
so that every train step of one bucket replays one CUDA graph.  Bucket
sizing: ``batch_size`` graphs, node and edge budgets from dataset statistics
times a safety factor; a batch that would overflow its bucket is closed
early, so no graph is dropped and shapes stay static.  The packing, the
bucket ladder and the shuffle are JAX's, so both loaders emit the same
batches from one seed.  Batches are CPU tensors; with ``csr_plan`` each
carries the receiver and sender CSR plans of ``graph.attach_csr_plan``,
which the port's kernels need on the card (JAX's ``scan_plan`` and
``scan_block`` are the TPU's plan and have no counterpart).

Integer features are packed by the native C++ batcher (``data/native.py``),
others by ``graph.batch_graphs``, as JAX chooses (loader.py:139-144); the
native packer raises where it cannot be built instead of falling back.
"""

from __future__ import annotations

import time
from typing import Callable, Iterator, List, Optional, Sequence

import numpy as np
import torch

from phc_gnn_torch.data import native
from phc_gnn_torch.graph.batch import GraphsTuple, attach_csr_plan, batch_graphs
from phc_gnn_torch.utils import round_up

__all__ = ["BucketSpec", "compute_bucket_spec", "PaddedLoader"]


class BucketSpec:
    """Static padded sizes for one loader."""

    def __init__(self, num_nodes: int, num_edges: int, num_graphs: int,
                 target_dim: Optional[int] = None):
        self.num_nodes = int(num_nodes)
        self.num_edges = int(num_edges)
        self.num_graphs = int(num_graphs)
        self.target_dim = target_dim

    def __repr__(self):
        return (f"BucketSpec(nodes={self.num_nodes}, edges={self.num_edges}, "
                f"graphs={self.num_graphs})")


def compute_bucket_spec(graphs: Sequence[dict], batch_size: int,
                        target_dim: Optional[int] = None,
                        safety: float = 1.15, align: int = 128) -> BucketSpec:
    """Size buckets from dataset statistics: batch_size * mean size *
    safety, aligned to ``align``; also covers the single largest graph."""
    n_sizes = np.asarray([g["x"].shape[0] for g in graphs])
    e_sizes = np.asarray([g["edge_index"].shape[1] for g in graphs])
    nodes = max(batch_size * float(n_sizes.mean()) * safety,
                float(n_sizes.max()) + 1)
    edges = max(batch_size * float(e_sizes.mean()) * safety,
                float(e_sizes.max()))
    return BucketSpec(
        num_nodes=round_up(int(nodes) + 1, align),
        num_edges=round_up(int(edges), align),
        num_graphs=batch_size + 1,
        target_dim=target_dim)


def _integer(a) -> bool:
    return np.issubdtype(np.asarray(a).dtype, np.integer)


class PaddedLoader:
    """Iterable over padded ``GraphsTuple`` batches on the CPU.

    Greedy packing: walk the (optionally shuffled) graph list; close the
    batch when the graph, node or edge budget would overflow.  With
    ``sub_buckets`` > 1 a ladder of smaller buckets (halving node and edge
    budgets) is kept and each closed batch is emitted at the smallest
    bucket it fits.  ``pack_s``, ``plan_s`` and
    ``batches`` count the host seconds spent packing (plans included), of
    them on the plans, and the batches emitted, over every pass."""

    def __init__(self, graphs: Sequence[dict], bucket: BucketSpec,
                 shuffle: bool = False, seed: int = 0,
                 transform: Optional[Callable[[dict], dict]] = None,
                 drop_last: bool = False, sub_buckets: int = 1,
                 align: int = 128, csr_plan: bool = False):
        self.graphs = graphs
        self.bucket = bucket
        self.shuffle = shuffle
        self.seed = seed
        self.transform = transform
        self.drop_last = drop_last
        self.csr_plan = csr_plan
        self.pack_s = 0.0
        self.plan_s = 0.0
        self.batches = 0
        self.ladder = [bucket]
        for _ in range(sub_buckets - 1):
            prev = self.ladder[-1]
            nodes = round_up(max(prev.num_nodes // 2, align), align)
            edges = round_up(max(prev.num_edges // 2, align), align)
            if nodes == prev.num_nodes and edges == prev.num_edges:
                break
            self.ladder.append(BucketSpec(nodes, edges, prev.num_graphs,
                                          prev.target_dim))

    def _smallest_fit(self, n_sum: int, e_sum: int, k: int) -> BucketSpec:
        for b in reversed(self.ladder):
            if (n_sum <= b.num_nodes - 1 and e_sum <= b.num_edges
                    and k <= b.num_graphs - 1):
                return b
        return self.bucket

    def __iter__(self) -> Iterator[GraphsTuple]:
        order = np.arange(len(self.graphs))
        if self.shuffle:
            np.random.default_rng(self.seed).shuffle(order)
        b = self.bucket
        cur: List[dict] = []
        n_sum = e_sum = 0
        for idx in order:
            g = self.graphs[idx]
            if self.transform is not None:
                g = self.transform(g)
            gn = g["x"].shape[0]
            ge = g["edge_index"].shape[1]
            if cur and (len(cur) + 1 > b.num_graphs - 1
                        or n_sum + gn > b.num_nodes - 1
                        or e_sum + ge > b.num_edges):
                yield self._pack(cur, self._smallest_fit(n_sum, e_sum, len(cur)))
                cur, n_sum, e_sum = [], 0, 0
            cur.append(g)
            n_sum += gn
            e_sum += ge
        if cur and not self.drop_last:
            yield self._pack(cur, self._smallest_fit(n_sum, e_sum, len(cur)))

    def _pack(self, graphs: List[dict], b: BucketSpec) -> GraphsTuple:
        t0 = time.perf_counter()
        out = self._pack_raw(graphs, b)
        t1 = time.perf_counter()
        if self.csr_plan:
            out = attach_csr_plan(out)
        t2 = time.perf_counter()
        self.pack_s += t2 - t0
        self.plan_s += t2 - t1
        self.batches += 1
        return out

    def _pack_raw(self, graphs: List[dict], b: BucketSpec) -> GraphsTuple:
        y_shape = (b.target_dim,) if b.target_dim else None
        if not (all(_integer(g["x"]) for g in graphs)
                and all(_integer(g["edge_attr"]) for g in graphs)):
            return batch_graphs(graphs, b.num_nodes, b.num_edges, b.num_graphs,
                                y_shape=y_shape)
        node_feats = np.concatenate(
            [(g["x"] if g["x"].ndim == 2 else g["x"][:, None])
             for g in graphs]).astype(np.int32)
        edge_feats = np.concatenate(
            [(g["edge_attr"] if g["edge_attr"].ndim == 2
              else g["edge_attr"][:, None]) for g in graphs]).astype(np.int32)
        senders = np.concatenate([g["edge_index"][0] for g in graphs])
        receivers = np.concatenate([g["edge_index"][1] for g in graphs])
        node_off = np.concatenate(
            [[0], np.cumsum([g["x"].shape[0] for g in graphs])])
        edge_off = np.concatenate(
            [[0], np.cumsum([g["edge_index"].shape[1] for g in graphs])])
        out = native.pack_batch_native(
            node_feats, edge_feats, senders, receivers, node_off, edge_off,
            b.num_nodes, b.num_edges, b.num_graphs)
        y = None
        if y_shape is not None:
            y = np.full((b.num_graphs,) + y_shape, np.nan, np.float32)
            for gi, g in enumerate(graphs):
                if g.get("y") is not None:
                    y[gi] = np.asarray(g["y"], np.float32).reshape(y_shape)
        t = torch.from_numpy
        return GraphsTuple(
            nodes=t(out["nodes"]), edges=t(out["edges"]),
            senders=t(out["senders"]), receivers=t(out["receivers"]),
            graph_ids=t(out["graph_ids"]),
            node_mask=t(out["node_mask"].astype(bool)),
            edge_mask=t(out["edge_mask"].astype(bool)),
            graph_mask=t(out["graph_mask"].astype(bool)),
            y=t(y) if y is not None else None)
