"""Node-sharded graph parallelism with a boundary (halo) exchange.

Counterpart of phc_gnn_tpu/parallel/halo.py.  The padded batch's nodes are
cut into ``S`` contiguous ranges over the mesh's ``ep`` axis (node ``g``
lives on shard ``g // NS``) and every edge lives with the shard that owns
its receiver, so every segment reduction is local to a shard.  What
crosses shards a layer is the halo: the rows of ``x`` that another
shard's edges read as senders.  ``partition_nodes`` (on the host, in
numpy) lists them per ordered shard pair, padded to a static width
``H``; ``halo_exchange`` ships them with one ``all_to_all`` of
``[S*H, d]`` rows over the ``ep`` group, and the conv gathers its
messages from ``concat([x, x_remote])`` (``ops.segment_sum.
halo_gather_split``, whose backward is kernel C's halo role).  The norms
of the layers take their statistics over the shards and the pooling sums
the ``[G, d]`` partial graph sums over them (``PHCGNN(node_axis="ep")``).

The steps run one process a rank (``parallel.mesh``): rank ``(d, e)`` calls
``step(shard, lr)`` with shard ``e`` of its dp batch ``d``, and every rank
of the mesh calls it at the same time.  The loss is the same on every
shard of a batch (the pooling's psum), so each shard's raw gradient is S
times its own nodes' contribution, the forward psum transposing to a psum:
the mean over ``ep`` is the exact gradient of the batch, as in JAX
(halo.py:351-370).  JAX overlaps the exchange with local work through
TPU compiler options; the port's exchange is a blocking collective.
JAX jits each step and scans T of them; over NCCL on a CUDA device the
port captures one step, its exchanges included, in a CUDA graph a shard
shape and replays it (``parallel.dp.grid_scan_train_steps``); on gloo and
on the CPU the steps run eagerly.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Union

import numpy as np
import torch

from phc_gnn_torch.graph.batch import (GraphsTuple, build_csr_rowptr,
                                       build_sender_csr)
from phc_gnn_torch.parallel import mesh as mesh_lib
from phc_gnn_torch.parallel.mesh import Axis, Mesh
from phc_gnn_torch.utils import round_up

__all__ = ["SlotOverflow", "partition_nodes", "slot_needs", "halo_exchange",
           "make_np_train_step", "make_np_eval_step", "make_dp_np_train_step",
           "make_dp_np_eval_step", "make_scan_np_train_steps",
           "make_scan_dp_np_train_steps"]


class SlotOverflow(ValueError):
    """A fixed ``edge_slots`` / ``halo_slots`` capacity is too small for a
    batch (halo.py:95-102): it carries both sizes the batch needs, so that
    the Trainer grows its rungs once and partitions again."""

    def __init__(self, needed_edge_slots: int, needed_halo_slots: int,
                 msg: str):
        super().__init__(msg)
        self.needed_edge_slots = needed_edge_slots
        self.needed_halo_slots = needed_halo_slots


def _cut(batch: GraphsTuple, S: int, halo_align: int, edge_align: int):
    """How ``partition_nodes`` cuts ``batch`` into ``S`` node shards: the
    shard rows ``NS``, the real edges' receivers and senders, each edge
    shard's start in them, the sorted unique senders that each shard t
    sends to each shard s (``send_lists[t][s]``) and the widths ``ES`` and
    ``H`` the batch needs."""
    NS = round_up(-(-batch.num_nodes // S), 8)
    recv = batch.receivers.cpu().numpy().astype(np.int64)
    send = batch.senders.cpu().numpy().astype(np.int64)
    if np.any(recv[1:] < recv[:-1]):
        raise ValueError("partition_nodes needs receiver-sorted edges")
    # the real edges only: the batch's padding edges all point at the last
    # node, which would pile them on the last shard
    edge_mask = batch.edge_mask.cpu().numpy()
    recv, send = recv[edge_mask], send[edge_mask]
    owner_e = np.minimum(recv // NS, S - 1)
    counts = np.bincount(owner_e, minlength=S)
    ES = round_up(max(int(counts.max()), 1), edge_align)
    e_starts = np.concatenate([[0], np.cumsum(counts)])

    # for each (source shard t, edge shard s) the sorted unique t-owned
    # senders of s's edges
    send_lists = [[None] * S for _ in range(S)]
    max_cut = 0
    for s in range(S):
        es_send = send[e_starts[s]:e_starts[s + 1]]
        es_owner = np.minimum(es_send // NS, S - 1)
        for t in range(S):
            if t != s:
                uniq = np.unique(es_send[es_owner == t])
                send_lists[t][s] = uniq
                max_cut = max(max_cut, len(uniq))
    H = round_up(max(max_cut, 1), halo_align)
    return NS, recv, send, e_starts, send_lists, ES, H


def slot_needs(batch: GraphsTuple, num_shards: int, halo_align: int = 8,
               edge_align: int = 128) -> tuple:
    """``(edge_slots, halo_slots)``: the ``ES`` and ``H`` that
    ``partition_nodes(batch, num_shards)`` takes without fixed widths,
    without building the shards (the Trainer grows its rungs from every
    batch of a dp group with it)."""
    return _cut(batch, num_shards, halo_align, edge_align)[-2:]


def partition_nodes(batch: GraphsTuple, num_shards: int, halo_align: int = 8,
                    edge_align: int = 128, edge_slots: Optional[int] = None,
                    halo_slots: Optional[int] = None, csr_plan: bool = True
                    ) -> List[GraphsTuple]:
    """The ``num_shards`` node shards of a receiver-sorted batch, on the
    host (halo.py:103-273: the same arrays, bit for bit, as JAX's stacked
    ones).  Shard ``s`` holds nodes ``[s*NS, (s+1)*NS)`` (``NS = roundup(
    ceil(N / S), 8)``) and the real edges they receive (a contiguous slice
    of the sorted list, ``ES`` slots, its padding tail masked and pointing
    at the last local row); ``receivers`` are local, and ``senders`` index
    the augmented rows ``[NS + S*H]``: a local node, or row ``NS + t*H + i``,
    the i-th halo row received from shard t.  ``halo_send`` [S, H] lists
    the local rows the shard sends to each shard.  ``graph_mask`` and ``y``
    are the batch's own, shared by every shard.

    ``edge_slots`` / ``halo_slots`` fix ``ES`` and ``H`` (the Trainer's
    rungs) and raise ``SlotOverflow`` where the batch needs more.  With
    ``csr_plan`` each shard carries its receiver CSR over its ``NS`` rows
    and its sender CSR over the ``NS + S*H`` augmented rows, as
    ``graph.attach_csr_plan`` builds them for one device (JAX's
    ``scan_plan=True`` builds its streaming plans the same way), so that
    the kernels run unchanged inside each shard."""
    S = num_shards
    N = batch.num_nodes
    nodes = batch.nodes.cpu().numpy()
    edges = batch.edges.cpu().numpy()
    edge_mask = batch.edge_mask.cpu().numpy()
    node_mask = batch.node_mask.cpu().numpy()
    graph_ids = batch.graph_ids.cpu().numpy()
    G = batch.num_graphs
    edges = edges[edge_mask]
    NS, recv, send, e_starts, send_lists, ES, H = _cut(
        batch, S, halo_align, edge_align)
    if ((edge_slots is not None and ES > edge_slots)
            or (halo_slots is not None and H > halo_slots)):
        raise SlotOverflow(ES, H, (
            f"shard needs edge_slots={ES} (fixed {edge_slots}), "
            f"halo_slots={H} (fixed {halo_slots})"))
    ES = ES if edge_slots is None else edge_slots
    H = H if halo_slots is None else halo_slots

    out_nodes = np.zeros((S, NS) + nodes.shape[1:], nodes.dtype)
    out_nmask = np.zeros((S, NS), bool)
    out_gids = np.full((S, NS), G - 1, np.int32)
    out_edges = np.zeros((S, ES) + edges.shape[1:], edges.dtype)
    out_emask = np.zeros((S, ES), bool)
    out_send = np.zeros((S, ES), np.int32)
    out_recv = np.full((S, ES), NS - 1, np.int32)
    halo_send = np.zeros((S, S, H), np.int32)
    for t in range(S):
        for s in range(S):
            uniq = send_lists[t][s]
            if t != s and len(uniq):
                halo_send[t, s, :len(uniq)] = uniq - t * NS

    for s in range(S):
        lo_n = s * NS
        n_here = max(0, min(N - lo_n, NS))
        if n_here > 0:
            out_nodes[s, :n_here] = nodes[lo_n:lo_n + n_here]
            out_nmask[s, :n_here] = node_mask[lo_n:lo_n + n_here]
            out_gids[s, :n_here] = graph_ids[lo_n:lo_n + n_here]
        lo, hi = e_starts[s], e_starts[s + 1]
        ne = hi - lo
        if ne == 0:
            continue
        out_edges[s, :ne] = edges[lo:hi]
        out_emask[s, :ne] = True
        out_recv[s, :ne] = recv[lo:hi] - lo_n
        es_send = send[lo:hi]
        es_owner = np.minimum(es_send // NS, S - 1)
        aug = np.zeros(ne, np.int32)
        local = es_owner == s
        aug[local] = es_send[local] - lo_n
        for t in range(S):
            sel = es_owner == t
            if t != s and sel.any():
                aug[sel] = NS + t * H + np.searchsorted(send_lists[t][s],
                                                        es_send[sel])
        out_send[s, :ne] = aug

    t = torch.from_numpy
    shards = []
    for s in range(S):
        shard = GraphsTuple(
            nodes=t(out_nodes[s]), edges=t(out_edges[s]),
            senders=t(out_send[s]), receivers=t(out_recv[s]),
            graph_ids=t(out_gids[s]), node_mask=t(out_nmask[s]),
            edge_mask=t(out_emask[s]), graph_mask=batch.graph_mask.cpu(),
            y=batch.y.cpu() if batch.y is not None else None,
            halo_send=t(halo_send[s]))
        if csr_plan:
            perm, snd_rowptr = build_sender_csr(out_send[s], NS + S * H,
                                                out_emask[s])
            shard = shard.replace(
                rowptr=t(build_csr_rowptr(out_recv[s], NS, out_emask[s])),
                snd_perm=t(perm), snd_rowptr=t(snd_rowptr))
        shards.append(shard)
    return shards


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, halo_send, ax):
        idx = halo_send.reshape(-1).long()
        ctx.save_for_backward(idx)
        ctx.ax, ctx.rows = ax, x.shape[0]
        return mesh_lib.all_to_all(x.index_select(0, idx), ax)

    @staticmethod
    def backward(ctx, g):
        # the reverse exchange returns each peer's cotangent of the rows we
        # sent it; the transpose of the take adds them into those rows (one
        # row may go to several peers, and the padding slots name row 0
        # with a zero cotangent)
        (idx,) = ctx.saved_tensors
        gbuf = mesh_lib.all_to_all(g, ctx.ax)
        dx = torch.zeros((ctx.rows,) + tuple(g.shape[1:]), dtype=g.dtype,
                         device=g.device)
        return dx.index_add_(0, idx, gbuf), None, None


def halo_exchange(x: torch.Tensor, halo_send: torch.Tensor, ax: Axis
                  ) -> torch.Tensor:
    """Ship this shard's boundary rows to every peer of ``ax`` and receive
    theirs (halo.py:276-286): ``halo_send`` [S, H] lists the local rows of
    ``x`` [NS, d] for each shard; the result [S*H, d] holds in rows
    ``[t*H, (t+1)*H)`` shard t's rows for this one, which ``senders``
    index as ``NS + t*H + i``.  Differentiable in ``x``: the backward is
    the reverse exchange, then an ``index_add_`` into the sent rows."""
    if halo_send.shape[0] != ax.size:
        raise ValueError(f"halo_send lists {halo_send.shape[0]} shards, the "
                         f"{ax.name} axis has {ax.size}")
    return _HaloExchange.apply(x, halo_send, ax)


def make_np_train_step(model, optimizer, loss_fn: Callable, mesh: Mesh,
                       weight_decay: float = 0.0, weight_decay2: float = 0.0,
                       reg_p: int = 2, seed: int = 0,
                       device: Union[str, torch.device] = "cuda"):
    """The node-parallel train step over ``ep`` (halo.py:351-370):
    ``step(shard, lr) -> (loss, out [G, T])``, called by every rank with its
    shard of one batch.  The model has ``node_axis="ep"``; the gradients
    are averaged over ``ep`` and one Adam step follows on every rank;
    the norms' running stats are the whole batch's already, and stay as
    they are.  Arguments as ``train.make_train_step``."""
    from phc_gnn_torch.parallel.dp import grid_train_step
    _one_row(mesh)
    return grid_train_step(model, optimizer, loss_fn, mesh, weight_decay,
                           weight_decay2, reg_p, "l1", seed, device)


def make_dp_np_train_step(model, optimizer, loss_fn: Callable, mesh: Mesh,
                          weight_decay: float = 0.0, weight_decay2: float = 0.0,
                          reg_p: int = 2, loss_name: str = "l1", seed: int = 0,
                          device: Union[str, torch.device] = "cuda"):
    """Data and node parallelism over the ``(dp, ep)`` mesh
    (halo.py:488-528): ``step(shard, lr) -> (loss, outs [dp, G, T])``;
    rank ``(d, e)`` passes shard ``e`` of batch ``d``.  Each batch's
    gradient is the mean over its shards, then the batches combine with
    their load weights (``parallel.dp.loss_weight``), and the running
    stats with their batch's real nodes, summed over its shards."""
    from phc_gnn_torch.parallel.dp import grid_train_step
    return grid_train_step(model, optimizer, loss_fn, mesh, weight_decay,
                           weight_decay2, reg_p, loss_name, seed, device)


def make_np_eval_step(model, mesh: Mesh,
                      device: Union[str, torch.device] = "cuda"):
    """``step(shard) -> out [G, T]``: the eval forward of one batch over its
    node shards (halo.py:437-450); every shard gets the whole output."""
    from phc_gnn_torch.parallel.dp import grid_eval_step
    _one_row(mesh)
    return grid_eval_step(model, mesh, device)


def make_dp_np_eval_step(model, mesh: Mesh,
                         device: Union[str, torch.device] = "cuda"):
    """``step(shard) -> outs [dp, G, T]``: the eval forward of dp batches,
    each over its node shards (halo.py:453-466)."""
    from phc_gnn_torch.parallel.dp import grid_eval_step
    return grid_eval_step(model, mesh, device)


def make_scan_np_train_steps(model, optimizer, loss_fn: Callable, mesh: Mesh,
                             weight_decay: float = 0.0,
                             weight_decay2: float = 0.0, reg_p: int = 2,
                             seed: int = 0,
                             device: Union[str, torch.device] = "cuda"):
    """``steps(shards, lr) -> (losses [T], outs [T, G, T'])``: T
    ``make_np_train_step`` steps, one after another, over this rank's
    shards of T batches (halo.py:395-417, a ``lax.scan`` there)."""
    from phc_gnn_torch.parallel.dp import grid_scan_train_steps
    _one_row(mesh)
    return grid_scan_train_steps(model, optimizer, loss_fn, mesh,
                                 weight_decay, weight_decay2, reg_p, "l1",
                                 seed, device)


def make_scan_dp_np_train_steps(model, optimizer, loss_fn: Callable,
                                mesh: Mesh, weight_decay: float = 0.0,
                                weight_decay2: float = 0.0, reg_p: int = 2,
                                loss_name: str = "l1", seed: int = 0,
                                device: Union[str, torch.device] = "cuda"):
    """``steps(shards, lr) -> (losses [T], outs [T, dp, G, T'])``: T
    ``make_dp_np_train_step`` steps over this rank's shards of T dp groups
    (halo.py:531-555)."""
    from phc_gnn_torch.parallel.dp import grid_scan_train_steps
    return grid_scan_train_steps(model, optimizer, loss_fn, mesh,
                                 weight_decay, weight_decay2, reg_p,
                                 loss_name, seed, device)


def _one_row(mesh: Mesh) -> None:
    if mesh.dp.size != 1:
        raise ValueError(f"the np steps run on a (1, ep) mesh, got "
                         f"{mesh.shape}: make_dp_np_* take dp > 1")
