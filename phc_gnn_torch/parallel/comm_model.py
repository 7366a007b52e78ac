"""Analytic communication volume of the halo node-sharding scheme.

Counterpart of phc_gnn_tpu/parallel/comm_model.py, in numpy on the port's
``GraphsTuple``: closed-form wire bytes of the collectives that one train
step of the halo scheme (parallel/halo.py) sends, per shard, and the
scaling efficiency they predict.  It models what JAX's models, and that
alone: the halo scheme, not the replicated one (parallel/edge_partition.py).

Per train step of a PHC-GNN with L message-passing layers on S node shards:

- L halo ``all_to_all``s of ``[S*H, d_i]`` (``d_i`` the layer's input
  width), one a conv, and their reverses in the backward;
- per batch norm of width d, ``2 * (2d + 1)`` elements: the count, the mean
  and the sum of squares, in each direction;
- the pooling's ``psum`` of the ``[G, d_pool]`` partial graph sums, and its
  transpose;
- outside the model: the gradient reduction, parameter-sized, as in plain
  data parallelism.

tests/test_torch_comm_model.py holds the model to the bytes that the
port's collectives send over one step on gloo ranks.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from phc_gnn_torch.graph.batch import GraphsTuple
from phc_gnn_torch.utils import round_up

__all__ = ["boundary_cuts", "halo_volume", "step_comm_volume",
           "predict_scaling_efficiency"]


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def boundary_cuts(batch: GraphsTuple, num_shards: int) -> np.ndarray:
    """``cut[t, s]``: the distinct t-owned sender nodes that the real edges
    owned by shard s read (s != t), under ``partition_nodes``' ownership:
    contiguous node ranges of ``NS = round_up(ceil(N / S), 8)`` rows, an
    edge owned by its receiver's owner (comm_model.py:44-65)."""
    S = num_shards
    NS = round_up(-(-batch.num_nodes // S), 8)
    emask = _np(batch.edge_mask)
    recv = _np(batch.receivers).astype(np.int64)[emask]
    send = _np(batch.senders).astype(np.int64)[emask]
    owner_e = np.minimum(recv // NS, S - 1)
    owner_s = np.minimum(send // NS, S - 1)
    cut = np.zeros((S, S), np.int64)
    for s in range(S):
        es_send = send[owner_e == s]
        es_owner = owner_s[owner_e == s]
        for t in range(S):
            if t != s:
                cut[t, s] = len(np.unique(es_send[es_owner == t]))
    return cut


def halo_volume(batch: GraphsTuple, num_shards: int,
                layer_dims: Sequence[int], dtype_bytes: int = 4,
                halo_align: int = 8) -> dict:
    """The halo ``all_to_all``s' wire bytes of one train step (forward and
    backward) per shard (comm_model.py:68-96): ``H`` (the static halo width,
    ``round_up(max cut, halo_align)``), ``max_cut``, the worst shard's
    received rows a layer, ``useful_bytes`` (those rows), ``padded_bytes``
    (``S * H`` rows a layer, what the wire carries) and their ratio."""
    S = num_shards
    cut = boundary_cuts(batch, num_shards)
    H = round_up(max(int(cut.max()), 1), halo_align)
    # shard s receives cut[t, s] rows from each t; the buffer is S*H rows
    max_rows_useful = int(cut.sum(axis=0).max())
    useful = sum(max_rows_useful * d for d in layer_dims)
    padded = sum(S * H * d for d in layer_dims)
    return {
        "H": H,
        "max_cut": int(cut.max()),
        "useful_rows_per_layer": max_rows_useful,
        "useful_bytes": 2 * useful * dtype_bytes,
        "padded_bytes": 2 * padded * dtype_bytes,
        "padding_overhead": padded / max(useful, 1),
    }


def step_comm_volume(batch: GraphsTuple, num_shards: int,
                     layer_dims: Sequence[int], pooled_dim: int,
                     bn_dims: Sequence[int] = (), dtype_bytes: int = 4,
                     halo_align: int = 8) -> dict:
    """The modelled wire bytes per shard of one halo train step
    (comm_model.py:99-113): ``halo_volume``'s keys, the norms'
    ``bn_psum_bytes``, the pooling's ``pooling_psum_bytes`` (forward and
    backward each) and their ``total_bytes``; the gradient reduction is not
    counted."""
    halo = halo_volume(batch, num_shards, layer_dims, dtype_bytes,
                       halo_align)
    bn = sum(2 * (2 * d + 1) * dtype_bytes for d in bn_dims)
    pool = 2 * batch.num_graphs * pooled_dim * dtype_bytes
    return {
        **halo,
        "bn_psum_bytes": bn,
        "pooling_psum_bytes": pool,
        "total_bytes": halo["padded_bytes"] + bn + pool,
    }


def predict_scaling_efficiency(step_time_1chip_s: float,
                               comm_bytes_per_shard: float, num_shards: int,
                               ici_bytes_per_s: float = 4.5e10,
                               overlap: float = 0.0) -> dict:
    """The scaling efficiency that the modelled bytes predict
    (comm_model.py:116-160): the compute splits ``1/S``, the
    communication takes ``comm_bytes_per_shard / ici_bytes_per_s``, of
    which ``1 - overlap`` is exposed; ``efficiency = T1 / (S * T_S)`` with
    ``T_S = T1 / S + exposed``, beside the bounds with no overlap and with
    all of it.  ``ici_bytes_per_s`` defaults to the JAX package's constant,
    one TPU v5e ICI link a direction (45 GB/s): a caller on other links
    passes their rate."""
    t_comp = step_time_1chip_s / num_shards
    t_comm = comm_bytes_per_shard / ici_bytes_per_s
    exposed = (1.0 - overlap) * t_comm
    t_s = t_comp + exposed
    return {
        "t_comp_s": t_comp,
        "t_comm_s": t_comm,
        "t_comm_exposed_s": exposed,
        "step_time_s": t_s,
        "efficiency": t_comp / t_s,
        "efficiency_no_overlap": t_comp / (t_comp + t_comm),
        "efficiency_full_overlap": 1.0,
    }
