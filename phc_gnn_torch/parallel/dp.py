"""Load-weighted data parallelism over the ``dp`` axis of a mesh, and the
multi-rank steps that the node-sharded path shares with it.

Counterpart of phc_gnn_tpu/parallel/dp.py:36-171.  Each rank of the
``(dp, ep)`` mesh (``parallel.mesh``) holds one batch (or, with ep > 1,
one node shard of it, parallel/halo.py), runs the training forward and
backward on it, and every rank then applies the same Adam update to the
same gradient, so the replicas stay equal.  The reductions are
load-weighted, not plain means: with ``w_i = loss_weight(batch_i)`` the
number of valid loss terms, ``grad = sum w_i g_i / sum w_i`` is the
gradient of the union batch, exactly, and a rank that holds
``make_dummy_batch``'s fully masked batch (w = 0) adds nothing, which is
how the Trainer pads an epoch's last partial group.  The batch-norm
running stats are weighted by each batch's real nodes likewise.  The
loss comes back weighted the same way; the outputs of the dp batches are
gathered, ``[dp, G, T]`` on every rank.

The reductions run over the whole grid: the loss, its weight and the
running stats are equal on the ep shards of one batch (the pooling and
the norms sum over them), so ``weighted_mean`` of the gradients with
weight ``w / S`` and of the stats with the shards' own node counts, over
every rank, gives the mean over each batch's shards, weighted over the
batches, as JAX's ``pmean`` over ep then ``weighted_mean`` over dp do
(halo.py:488-528).
With dp = 1 the gradients are averaged over the ep shards and the stats,
the whole batch's already, stay as they are (halo.py:351-370).

As JAX's, the dp steps keep ``grad_accum`` single-device: the Trainer
ignores it under dp and ep.

JAX jits every step of the mesh and scans T of them in one dispatch.  The
port's counterpart is ``grid_scan_train_steps``: over NCCL on a CUDA
device, one CUDA graph a bucket shape holds a whole step with its
collectives, captured at the same call on every rank and replayed; on
gloo and on the CPU the steps run eagerly (``graphed_on``).
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Union

import torch

from phc_gnn_torch.graph.batch import GraphsTuple
from phc_gnn_torch.parallel import mesh as mesh_lib
from phc_gnn_torch.parallel.mesh import Axis, Mesh

__all__ = ["loss_weight", "make_dummy_batch", "weighted_mean",
           "make_dp_train_step", "make_dp_eval_step",
           "make_scan_dp_train_steps", "grid_train_step", "grid_eval_step",
           "grid_scan_train_steps", "grid_scan_eval_steps", "graphed_on",
           "fold_seed"]


def make_dummy_batch(batch: GraphsTuple) -> GraphsTuple:
    """A fully masked clone of ``batch`` (same shapes, dtypes and device):
    every mask False, float labels NaN, so its loss weight is 0 and it adds
    nothing to a weighted combination.  It pads the last partial group of
    an epoch (the accumulated step's K sub-batches, the dp groups).  Where
    ``batch`` carries CSR plans, the clone carries the plans of its own
    masks, what ``graph.attach_csr_plan`` builds for them (no real edge in
    any segment, the sender order the identity), made on the batch's
    device without a host sync."""
    y = batch.y
    if y is not None and y.is_floating_point():
        y = torch.full_like(y, float("nan"))
    out = batch.replace(node_mask=torch.zeros_like(batch.node_mask),
                        edge_mask=torch.zeros_like(batch.edge_mask),
                        graph_mask=torch.zeros_like(batch.graph_mask), y=y)
    if batch.rowptr is not None:
        out = out.replace(
            rowptr=torch.zeros_like(batch.rowptr),
            snd_perm=torch.arange(batch.num_edges, dtype=torch.int32,
                                  device=batch.senders.device),
            snd_rowptr=torch.zeros_like(batch.snd_rowptr))
    return out


def loss_weight(batch: GraphsTuple, loss: str) -> torch.Tensor:
    """The number of valid loss terms in ``batch``, as a float32 device
    scalar: the weight that makes the weighted mean over batches equal the
    union batch's mean loss and gradient.  Cross-entropy (integer labels)
    counts the real graphs; the float losses count the finite label entries
    of the real graphs (multi-task BCE counts entries, as its loss does)."""
    if loss == "ce" or batch.y is None:
        return batch.graph_mask.sum(dtype=torch.float32)
    return (torch.isfinite(batch.y)
            & batch.graph_mask[:, None]).sum(dtype=torch.float32)


def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat(flat: torch.Tensor, like: Sequence[torch.Tensor]
            ) -> List[torch.Tensor]:
    parts = flat.split([t.numel() for t in like])
    return [p.view(t.shape) for p, t in zip(parts, like)]


def weighted_mean(tensors: Sequence[torch.Tensor], w: torch.Tensor,
                  ax: Axis) -> List[torch.Tensor]:
    """``psum(w * x) / psum(w)`` over ``ax`` for each of ``tensors`` (0/0
    guarded to 0; dp.py:71-75), in one ``all_reduce``."""
    flat = mesh_lib.all_reduce(_flat([t * w for t in tensors]
                                     + [w.reshape(1)]), ax)
    return [t / flat[-1].clamp_min(1e-9) for t in _unflat(flat[:-1],
                                                          tensors)]


def fold_seed(seed: int, index: int) -> int:
    """The dropout seed of dp rank ``index``: ``seed`` itself for rank 0
    (so a one-rank mesh draws what the single-device step draws), a
    distinct one for each other rank, as JAX folds the dp index into its
    key (dp.py:104)."""
    return seed if index == 0 else (seed * 1000003 + index) % (2 ** 63)


def _grid(mesh: Mesh) -> Axis:
    return Axis("grid", mesh.size, mesh.rank, mesh.world)


def graphed_on(mesh: Mesh, dev: torch.device) -> bool:
    """Whether the steps of ``mesh`` on ``dev`` replay CUDA graphs: on a
    CUDA device over NCCL, whose collectives run on the card and so go
    into a graph with the kernels around them.  Gloo runs its collectives
    on the host, where a graph cannot hold them, and the CPU has no
    graphs: there the steps run eagerly.  The choice follows the mesh's
    backend alone; a capture that fails raises."""
    return dev.type == "cuda" and mesh.backend == "nccl"


# ProcessGroupNCCL's watchdog thread polls its work's CUDA events; in the
# default global mode one poll during a capture would invalidate it, so an
# NCCL mesh captures in thread-local mode (this thread's calls checked)
NCCL_CAPTURE_MODE = "thread_local"


def grid_scan_train_steps(model, optimizer, loss_fn: Callable, mesh: Mesh,
                          weight_decay: float = 0.0,
                          weight_decay2: float = 0.0, reg_p: int = 2,
                          loss_name: str = "l1", seed: int = 0,
                          device: Union[str, torch.device] = "cuda"):
    """The train steps of every mesh shape, T at a time: ``steps(batches,
    lr) -> (losses [T], outs [T, ...])`` over this rank's T batches or
    shards of one bucket shape (a sequence, or a stack from
    ``graph.stack_batches``), one after another at one ``lr``, as JAX's
    scanned steps (dp.py:128-154, halo.py:377-417, 531-555).  ``out`` is
    [G, T] at dp = 1, else the dp batches' outputs [dp, G, T].  Moves
    ``model`` and ``optimizer`` to ``device`` (this rank's); the dropout
    generator is seeded with ``fold_seed(seed, d)``.  ``steps.generator``
    is it.

    On a CUDA device over NCCL (``graphed_on``) the first call for a bucket
    shape captures one whole step in a CUDA graph (``train.state.
    _GraphedStep``): the forward, the backward, the step's collectives
    and the Adam update, with the dropout generator registered, so that
    each replay draws what the eager step draws.  Every rank of the mesh
    must capture at the same call, or their collectives deadlock: the
    graph's key is the shape of the batch or shard, which every rank
    derives alike (a dp rank's dummy batch has its real batch's shape,
    the halo shards take the rungs of the whole dp group).  Later calls
    copy each batch into the graph's buffers and replay it.  On gloo and
    on the CPU the steps run eagerly, one after another."""
    from phc_gnn_torch.train.state import (_as_list, _bind, _capture_train,
                                           make_loss_and_grads)
    dev = _bind(model, optimizer, device)
    loss_and_grads = make_loss_and_grads(model, loss_fn, weight_decay,
                                         weight_decay2, reg_p)
    gen = torch.Generator(device=dev).manual_seed(
        fold_seed(seed, mesh.dp.index))
    stats = [b for b in model.buffers() if b.is_floating_point()]
    grid, shards = _grid(mesh), mesh.ep.size

    def body(batch: GraphsTuple):
        with mesh_lib.bind(mesh):
            loss, out, grads = loss_and_grads(batch, optimizer.lr, gen)
        g = list(grads.values())
        if mesh.dp.size == 1:
            g = _unflat(mesh_lib.all_reduce(_flat(g), mesh.ep) / shards, g)
        else:
            *g, loss = weighted_mean(
                g + [loss], loss_weight(batch, loss_name) / shards, grid)
            torch._foreach_copy_(stats, weighted_mean(
                stats, batch.node_mask.sum(dtype=torch.float32), grid))
            out = mesh_lib.all_gather(out, mesh.dp)
        optimizer.step(g, optimizer.lr)
        return loss, out

    graphs = {}
    graphed = graphed_on(mesh, dev)

    def steps(batches, lr: Union[float, torch.Tensor]):
        batches = _as_list(batches, "the mesh steps")
        optimizer.set_lr(lr)
        if not graphed:
            losses, outs = zip(*(body(b.to(dev, non_blocking=True))
                                 for b in batches))
            return torch.stack(losses), torch.stack(outs)
        # lockstep: the same key on every rank (docstring)
        key = batches[0].shape_key()
        if key not in graphs:
            graphs[key] = _capture_train(
                body, [batches[0].to(dev, non_blocking=True)], dev, model,
                optimizer, gen, NCCL_CAPTURE_MODE)
        losses, outs = graphs[key].run([(b,) for b in batches])
        optimizer.count += len(batches)
        return losses, outs

    steps.generator = gen
    return steps


def grid_train_step(model, optimizer, loss_fn: Callable, mesh: Mesh,
                    weight_decay: float = 0.0, weight_decay2: float = 0.0,
                    reg_p: int = 2, loss_name: str = "l1", seed: int = 0,
                    device: Union[str, torch.device] = "cuda"):
    """The train step of every mesh shape: ``step(batch, lr) -> (loss,
    out)``, ``grid_scan_train_steps`` on one batch (one CUDA graph a
    bucket shape over NCCL, eager on gloo and on the CPU).
    ``step.generator`` is the dropout generator."""
    steps = grid_scan_train_steps(model, optimizer, loss_fn, mesh,
                                  weight_decay, weight_decay2, reg_p,
                                  loss_name, seed, device)

    def step(batch: GraphsTuple, lr: Union[float, torch.Tensor]):
        losses, outs = steps([batch], lr)
        return losses[0], outs[0]

    step.generator = steps.generator
    return step


def grid_scan_eval_steps(model, mesh: Mesh,
                         device: Union[str, torch.device] = "cuda"):
    """``steps(batches) -> outs [T, ...]``: the eval forward of this rank's
    T batches or shards of one bucket shape under
    ``torch.inference_mode()``; ``out`` [G, T] at dp = 1, else the dp
    batches' outputs gathered, [dp, G, T].  Over NCCL on a CUDA device one
    forward with its collectives is captured in a CUDA graph a bucket
    shape, in lockstep on every rank as the train steps'
    (``grid_scan_train_steps``), and replayed for each batch; on gloo and
    on the CPU the forwards run eagerly."""
    from phc_gnn_torch.device import resolve_device
    from phc_gnn_torch.train.state import _as_list, _GraphedStep
    dev = resolve_device(device)
    model.to(dev).eval()
    graphs = {}
    graphed = graphed_on(mesh, dev)

    def forward(batch: GraphsTuple):
        with mesh_lib.bind(mesh):
            out = model(batch, training=False)
            return ((mesh_lib.all_gather(out, mesh.dp) if mesh.dp.size > 1
                     else out),)

    def steps(batches) -> torch.Tensor:
        batches = _as_list(batches, "the mesh evals")
        with torch.inference_mode():
            if not graphed:
                return torch.stack([forward(b.to(dev, non_blocking=True))[0]
                                    for b in batches])
            key = batches[0].shape_key()
            if key not in graphs:
                graphs[key] = _GraphedStep(
                    forward, [batches[0].to(dev, non_blocking=True)], dev,
                    capture_error_mode=NCCL_CAPTURE_MODE)
            return graphs[key].run([(b,) for b in batches])[0]

    return steps


def grid_eval_step(model, mesh: Mesh,
                   device: Union[str, torch.device] = "cuda"):
    """``step(batch) -> out``: ``grid_scan_eval_steps`` on one batch or
    shard; ``out`` [G, T] at dp = 1, else [dp, G, T]."""
    steps = grid_scan_eval_steps(model, mesh, device)
    return lambda batch: steps([batch])[0]


def make_dp_train_step(model, optimizer, loss_fn: Callable, mesh: Mesh,
                       weight_decay: float = 0.0, weight_decay2: float = 0.0,
                       reg_p: int = 2, loss_name: str = "l1", seed: int = 0,
                       device: Union[str, torch.device] = "cuda"):
    """The data-parallel train step (dp.py:77-96): ``step(batch, lr) ->
    (loss, outs [dp, G, T])``, called by every rank with its own batch of
    one bucket shape.  ``grad = all_reduce(w g) / all_reduce(w)``, ``w =
    loss_weight(batch, loss_name)``; the running stats are weighted by the
    batches' real nodes; one Adam step follows on every rank.  Arguments as
    ``train.make_train_step``, with the ``(dp, 1)`` ``mesh``."""
    _dp_only(mesh)
    return grid_train_step(model, optimizer, loss_fn, mesh, weight_decay,
                           weight_decay2, reg_p, loss_name, seed, device)


def make_dp_eval_step(model, mesh: Mesh,
                      device: Union[str, torch.device] = "cuda"):
    """``step(batch) -> outs [dp, G, T]`` (dp.py:157-171): every rank's
    eval forward, gathered.  The outputs of a dummy batch are the caller's
    to drop (its graph mask is all False)."""
    return grid_eval_step(model, mesh, device)


def make_scan_dp_train_steps(model, optimizer, loss_fn: Callable, mesh: Mesh,
                             weight_decay: float = 0.0,
                             weight_decay2: float = 0.0, reg_p: int = 2,
                             loss_name: str = "l1", seed: int = 0,
                             device: Union[str, torch.device] = "cuda"):
    """``steps(batches, lr) -> (losses [T], outs [T, dp, G, T'])``: T
    ``make_dp_train_step`` steps over this rank's T batches
    (dp.py:128-154): one CUDA graph a bucket shape over NCCL, eager on
    gloo and on the CPU (``grid_scan_train_steps``)."""
    _dp_only(mesh)
    return grid_scan_train_steps(model, optimizer, loss_fn, mesh,
                                 weight_decay, weight_decay2, reg_p,
                                 loss_name, seed, device)


def _dp_only(mesh: Mesh) -> None:
    if mesh.ep.size != 1:
        raise ValueError(f"the dp step runs on a (dp, 1) mesh, got "
                         f"{mesh.shape}: take parallel.make_dp_np_train_step")
