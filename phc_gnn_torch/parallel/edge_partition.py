"""Edge-partitioned model parallelism: the replicated scheme.

Counterpart of phc_gnn_tpu/parallel/edge_partition.py.  One padded batch's
edge set is cut into ``S`` equal contiguous slices over the mesh's ``ep``
axis: rank ``e`` holds slice ``e`` of the edge arrays (features, senders,
receivers, mask) and every node array whole.  The model runs with
``edge_axis="ep"`` (``PHCGNN.set_edge_axis``): each conv's composite
aggregation reduces its rank's edges into a partial node array, which the
collectives of graph/segment.py combine over the axis exactly (``psum`` of
the sums and counts, ``pmax`` of the softmax's detached max); the node
compute, the norms and the pooling are replicated.  The batch's CSR plans
are dropped: the composites read none.

Gradients (edge_partition.py:106-114): the port's ``psum`` transposes to
the same sum (parallel/mesh.py), so each rank's raw gradient is ``S`` times
its own edge slice's part of the whole, and the ranks' gradients differ; the
mean over ``ep`` that ``parallel.dp.grid_train_step`` takes is the exact
gradient of the batch.  Every ``ep`` rank of a batch draws the same dropout
masks (``fold_seed`` folds in the dp index alone), as the replicated node
compute must agree.  With dp the batches combine by their load weights, as
the halo scheme's do (parallel/dp.py).

A min or max aggregation (PNA) cannot be trained under the scheme: ``pmax``
and ``pmin`` have no derivative in JAX, and the port's raise in the
backward likewise; their eval works.  As JAX's Trainer, the port keeps one
step a batch for this scheme (trainer.py:245-250): no scanned form.
"""

from __future__ import annotations

from typing import Callable, Union

import torch

from phc_gnn_torch.graph.batch import GraphsTuple
from phc_gnn_torch.parallel.mesh import Mesh

__all__ = ["partition_edges", "edge_shard", "make_ep_train_step",
           "make_ep_eval_step", "make_dp_ep_train_step",
           "make_dp_ep_eval_step"]

# the edge arrays that the ranks split; every other field is replicated
EDGE_FIELDS = ("edges", "senders", "receivers", "edge_mask")


def partition_edges(batch: GraphsTuple, num_shards: int) -> GraphsTuple:
    """``batch`` with its edge arrays rounded up to a multiple of
    ``num_shards`` (edge_partition.py:38-57): the padding edges point
    sender and receiver at the last node and are masked.  The CSR plans
    are stripped: they are single-device structures, and the sharded path
    runs the composites."""
    batch = batch.replace(rowptr=None, snd_perm=None, snd_rowptr=None)
    e = batch.num_edges
    pad = -e % num_shards
    if pad == 0:
        return batch
    last = batch.num_nodes - 1

    def pad_edges(t, fill):
        tail = torch.full((pad,) + tuple(t.shape[1:]), fill, dtype=t.dtype,
                          device=t.device)
        return torch.cat([t, tail])

    return batch.replace(edges=pad_edges(batch.edges, 0),
                         senders=pad_edges(batch.senders, last),
                         receivers=pad_edges(batch.receivers, last),
                         edge_mask=pad_edges(batch.edge_mask, False))


def edge_shard(batch: GraphsTuple, num_shards: int, index: int
               ) -> GraphsTuple:
    """Rank ``index``'s part of ``batch`` on an ``ep`` axis of
    ``num_shards``: slice ``index`` of ``partition_edges(batch,
    num_shards)``'s edge arrays, the node arrays, graph mask and labels
    whole, as ``shard_map`` splits JAX's ``edge_partition_specs`` (:63-69;
    ``make_dp_ep_batch_specs`` :167-174 adds the dp axis, which the port's
    ranks take by holding their dp batch)."""
    if not 0 <= index < num_shards:
        raise ValueError(f"edge shard {index} of {num_shards}")
    parted = partition_edges(batch, num_shards)
    per = parted.num_edges // num_shards
    cut = slice(index * per, (index + 1) * per)
    return parted.replace(**{f: getattr(parted, f)[cut] for f in EDGE_FIELDS})


def _check(model, mesh: Mesh) -> None:
    if mesh.ep.size > 1 and getattr(model, "edge_axis", None) != "ep":
        raise ValueError(
            "the replicated scheme's steps need the model's edges "
            "partitioned over 'ep' (PHCGNN(edge_axis='ep') or "
            "model.set_edge_axis('ep'))")


def make_ep_train_step(model, optimizer, loss_fn: Callable, mesh: Mesh,
                       weight_decay: float = 0.0, weight_decay2: float = 0.0,
                       reg_p: int = 2, seed: int = 0,
                       device: Union[str, torch.device] = "cuda"):
    """The edge-partitioned train step over ``ep`` (edge_partition.py:
    92-119): ``step(shard, lr) -> (loss, out [G, T])``, called by every
    rank of the ``(1, ep)`` ``mesh`` with its ``edge_shard`` of one batch.
    The gradients are averaged over ``ep`` (the exact gradient, module
    docstring), one Adam step follows on every rank, and the running stats,
    the whole batch's on every rank, stay as they are.  Arguments as
    ``train.make_train_step``."""
    from phc_gnn_torch.parallel.dp import grid_train_step
    _check(model, mesh)
    if mesh.dp.size != 1:
        raise ValueError(f"the ep steps run on a (1, ep) mesh, got "
                         f"{mesh.shape}: make_dp_ep_* take dp > 1")
    return grid_train_step(model, optimizer, loss_fn, mesh, weight_decay,
                           weight_decay2, reg_p, "l1", seed, device)


def make_ep_eval_step(model, mesh: Mesh,
                      device: Union[str, torch.device] = "cuda"):
    """``step(shard) -> out [G, T]``: the eval forward of one batch over its
    edge shards (edge_partition.py:138-149); the output is the same on
    every rank."""
    from phc_gnn_torch.parallel.dp import grid_eval_step
    _check(model, mesh)
    return grid_eval_step(model, mesh, device)


def make_dp_ep_train_step(model, optimizer, loss_fn: Callable, mesh: Mesh,
                          weight_decay: float = 0.0, weight_decay2: float = 0.0,
                          reg_p: int = 2, loss_name: str = "l1", seed: int = 0,
                          device: Union[str, torch.device] = "cuda"):
    """Data and edge parallelism over the ``(dp, ep)`` mesh
    (edge_partition.py:177-212): ``step(shard, lr) -> (loss, outs [dp, G,
    T])``; rank ``(d, e)`` passes ``edge_shard(batch_d, ep, e)``.  Each
    batch's gradient is the mean over its edge shards, then the batches
    combine with their load weights (``parallel.dp.loss_weight``), and the
    running stats with their batch's real nodes."""
    from phc_gnn_torch.parallel.dp import grid_train_step
    _check(model, mesh)
    return grid_train_step(model, optimizer, loss_fn, mesh, weight_decay,
                           weight_decay2, reg_p, loss_name, seed, device)


def make_dp_ep_eval_step(model, mesh: Mesh,
                         device: Union[str, torch.device] = "cuda"):
    """``step(shard) -> outs [dp, G, T]``: the eval forward of dp batches,
    each over its edge shards (edge_partition.py:152-164)."""
    from phc_gnn_torch.parallel.dp import grid_eval_step
    _check(model, mesh)
    return grid_eval_step(model, mesh, device)
