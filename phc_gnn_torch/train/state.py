"""Training and serving entry points: the train step, the accumulated train
step, the eval step and their scanned forms over S same-shape batches.

Counterparts of ``make_loss_and_aux``, ``make_train_step``,
``make_accum_train_step``, ``make_eval_step``, ``make_scan_train_steps`` and
``make_scan_eval_steps`` in phc_gnn_tpu/train/state.py:52-214.  The port's
model owns its parameters and running stats, and the optimizer owns its
moments and its learning-rate tensor, so a step takes the batches (and the
learning rate) alone.

JAX runs the S steps of a scan, and the K sub-batches of an accumulated
step, in one jitted program.  On the card the port captures one step (or
one accumulated step of K sub-batches) in a CUDA graph over static batch
buffers and replays it (``_GraphedStep``), so a step costs one graph launch
and a few copies of host work instead of ~1,000 kernel launches (~3,000 for
pcba's K = 4).  On the CPU (asked for with ``device="cpu"``) the same steps
run eagerly.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple, Union

import torch
from torch import nn

from phc_gnn_torch.device import resolve_device
from phc_gnn_torch.graph.batch import GraphsTuple, unstack_batches
from phc_gnn_torch.nn.regularization import (
    multiplication_rule_regularization,
    phm_weight_regularization,
)
from phc_gnn_torch.parallel.dp import loss_weight
from phc_gnn_torch.train.optim import Adam

__all__ = ["make_loss_and_grads", "make_train_step", "make_accum_train_step",
           "make_eval_step", "make_scan_train_steps", "make_scan_eval_steps"]

# eager calls of a step before its capture: the kernels' builds, their
# cudaFuncSetAttribute calls and the caching allocator settle on them
WARMUP_CALLS = 3

LossFn = Callable[[torch.Tensor, GraphsTuple], torch.Tensor]


def make_loss_and_grads(model: nn.Module, loss_fn: LossFn,
                        weight_decay: float = 0.0, weight_decay2: float = 0.0,
                        reg_p: int = 2):
    """``f(batch, lr, generator) -> (loss, out, grads)``: the training
    forward, the masked task loss plus the reference's lr-scaled weight and
    rule regularization (``loss += lr*wd*phm_weight_reg + lr*wd2*rule_reg``,
    train_hiv.py:180-191), and the gradients of every parameter that
    requires one, keyed by name.  ``lr`` is a float or a 0-d tensor; the
    regularization multiplies a tensor (a float is made one on the device),
    so that a CUDA graph reads the lr at each replay instead of freezing it.
    The forward updates the batch-norm running stats; ``loss`` and ``out``
    come back detached."""
    named = dict(model.named_parameters())
    trainable = {k: p for k, p in named.items() if p.requires_grad}

    def loss_and_grads(batch: GraphsTuple, lr: Union[float, torch.Tensor],
                       generator: torch.Generator = None
                       ) -> Tuple[torch.Tensor, torch.Tensor,
                                  Dict[str, torch.Tensor]]:
        out = model(batch, training=True, generator=generator)
        loss = loss_fn(out, batch)
        if not isinstance(lr, torch.Tensor):
            lr = torch.full((), lr, dtype=torch.float32, device=out.device)
        if weight_decay > 0.0:
            loss = loss + lr * weight_decay * phm_weight_regularization(
                named, p=reg_p)
        if weight_decay2 > 0.0:
            loss = loss + lr * weight_decay2 * (
                multiplication_rule_regularization(named, p=1))
        grads = torch.autograd.grad(loss, list(trainable.values()))
        return loss.detach(), out.detach(), dict(zip(trainable, grads))

    return loss_and_grads


def make_train_step(model: nn.Module, optimizer: Adam, loss_fn: LossFn,
                    weight_decay: float = 0.0, weight_decay2: float = 0.0,
                    reg_p: int = 2, seed: int = 0,
                    device: Union[str, torch.device] = "cuda"
                    ) -> Callable[[GraphsTuple, float], Tuple[torch.Tensor,
                                                           torch.Tensor]]:
    """Move ``model`` to ``device`` (default "cuda"; without CUDA this raises
    unless ``device="cpu"``) and return ``step(batch, lr)``: forward,
    backward and the optimizer update, with the batch-norm running stats
    updated.  It returns ``(loss, out)`` as device tensors and syncs with the
    host nowhere.  ``optimizer`` is built on the model's parameters
    (``make_optimizer(dict(model.named_parameters()), ...)``); the dropout
    masks come from a generator on the device seeded with ``seed``.  The
    batch needs its CSR plan (``graph.attach_csr_plan``) on a CUDA device."""
    dev = _bind(model, optimizer, device)
    one_step = _one_step(model, optimizer, loss_fn, weight_decay,
                         weight_decay2, reg_p,
                         torch.Generator(device=dev).manual_seed(seed))

    def step(batch: GraphsTuple, lr: Union[float, torch.Tensor]
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        optimizer.set_lr(lr)
        return one_step(batch.to(dev, non_blocking=True))

    return step


def _one_step(model, optimizer, loss_fn, weight_decay, weight_decay2, reg_p,
              gen):
    """``step(batch) -> (loss, out)`` at the optimizer's lr tensor: the
    forward, backward and update of one batch on the device."""
    loss_and_grads = make_loss_and_grads(model, loss_fn, weight_decay,
                                         weight_decay2, reg_p)

    def step(batch: GraphsTuple) -> Tuple[torch.Tensor, torch.Tensor]:
        loss, out, grads = loss_and_grads(batch, optimizer.lr, gen)
        optimizer.step(list(grads.values()), optimizer.lr)
        return loss, out

    return step


def _bind(model: nn.Module, optimizer: Adam, device) -> torch.device:
    """Move ``model`` to ``device``, check that ``optimizer`` holds its
    trainable parameters, in order, and move the optimizer's lr and state
    after them."""
    dev = resolve_device(device)
    model.to(dev)
    trainable = {k: p for k, p in model.named_parameters() if p.requires_grad}
    if (list(optimizer.params) != list(trainable)
            or any(optimizer.params[k] is not p for k, p in trainable.items())):
        raise ValueError("the optimizer was not built on this model's "
                         "parameters")
    optimizer.follow_params()
    return dev


def make_accum_train_step(model: nn.Module, optimizer: Adam, loss_fn: LossFn,
                          weight_decay: float = 0.0, weight_decay2: float = 0.0,
                          reg_p: int = 2, loss_name: str = "l1", seed: int = 0,
                          device: Union[str, torch.device] = "cuda"
                          ) -> Callable[..., Tuple[torch.Tensor, torch.Tensor]]:
    """Gradient accumulation: ``step(batches, lr)`` takes ONE optimizer step
    from the exact load-weighted mean gradient of K sub-batches of one
    bucket shape (a sequence, or a stack from ``graph.stack_batches``;
    phc_gnn_tpu/train/state.py:116-170) and returns ``(loss, outs [K, G,
    T])`` as device tensors, with no host sync.  Sub-batches of two bucket
    shapes raise a ``ValueError``.

    Each sub-batch k runs the training forward and backward from the SAME
    parameters and the SAME running stats; with ``w_k = loss_weight(batch,
    loss_name)`` the gradient is ``sum w_k grad_k / max(sum w_k, 1e-9)`` and
    the loss is weighted the same way, so a fully masked sub-batch weighs 0.
    The clip and the Adam update act on that mean.  The running stats become
    ``sum n_k stats_k / max(sum n_k, 1e-9)``, ``n_k`` the sub-batch's real
    nodes (state.py:144-163).  Arguments as ``make_train_step``; the dropout
    masks are drawn sub-batch after sub-batch from one generator seeded with
    ``seed``; the batches need their CSR plans on a CUDA device.

    JAX runs the step as one jitted program.  On CUDA the first call for a
    (K, bucket shape) captures the whole step (the K forwards and backwards,
    the weighted sums, the clip and the Adam step) in one CUDA graph over K
    sets of static batch buffers (``_GraphedStep``); the model, the
    optimizer and the generator come out of the capture as they went in.
    Each call then copies the K sub-batches into the buffers and replays the
    graph, and the optimizer's ``count`` advances by one on the host.  On
    the CPU the step runs eagerly."""
    dev, gen, body = _accum_body(model, optimizer, loss_fn, weight_decay,
                                 weight_decay2, reg_p, loss_name, seed, device)
    graphs: Dict[tuple, _GraphedStep] = {}

    def step(batches, lr: Union[float, torch.Tensor]
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        batches = _as_list(batches, "the accumulated step")
        optimizer.set_lr(lr)
        if dev.type != "cuda":
            return body(*(b.to(dev) for b in batches))
        key = (len(batches),) + batches[0].shape_key()
        if key not in graphs:
            graphs[key] = _capture_train(
                body, [b.to(dev, non_blocking=True) for b in batches], dev,
                model, optimizer, gen)
        loss, outs = graphs[key].run([batches])
        optimizer.count += 1
        return loss[0], outs[0]

    return step


def _eager_accum_train_step(model: nn.Module, optimizer: Adam,
                            loss_fn: LossFn, weight_decay: float = 0.0,
                            weight_decay2: float = 0.0, reg_p: int = 2,
                            loss_name: str = "l1", seed: int = 0,
                            device: Union[str, torch.device] = "cuda"
                            ) -> Callable[..., Tuple[torch.Tensor,
                                                     torch.Tensor]]:
    """``make_accum_train_step``'s step run eagerly on any device: the body
    its CUDA graph captures, for the checks and the bench that hold the
    graph to it."""
    dev, _, body = _accum_body(model, optimizer, loss_fn, weight_decay,
                               weight_decay2, reg_p, loss_name, seed, device)

    def step(batches, lr: Union[float, torch.Tensor]
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        batches = _as_list(batches, "the accumulated step")
        optimizer.set_lr(lr)
        return body(*(b.to(dev, non_blocking=True) for b in batches))

    return step


def _accum_body(model, optimizer, loss_fn, weight_decay, weight_decay2, reg_p,
                loss_name, seed, device):
    """``(dev, generator, body)``: ``body(*batches) -> (loss, outs)``, the
    accumulated step on device batches at the optimizer's lr tensor.  The
    norms update their buffers in place, so the body keeps the stats it
    started from, restores them before each sub-batch and writes the
    weighted mean at the end."""
    dev = _bind(model, optimizer, device)
    loss_and_grads = make_loss_and_grads(model, loss_fn, weight_decay,
                                         weight_decay2, reg_p)
    gen = torch.Generator(device=dev).manual_seed(seed)
    stats = [b for b in model.buffers() if b.is_floating_point()]

    def body(*batches: GraphsTuple) -> Tuple[torch.Tensor, torch.Tensor]:
        start = [s.clone() for s in stats]
        gsum = ssum = None
        lsum = wsum = bsum = torch.zeros((), dtype=torch.float32, device=dev)
        outs = []
        for batch in batches:
            for s, s0 in zip(stats, start):
                s.copy_(s0)
            loss, out, grads = loss_and_grads(batch, optimizer.lr, gen)
            w = loss_weight(batch, loss_name)
            w_bn = batch.node_mask.sum(dtype=torch.float32)
            wg = torch._foreach_mul(list(grads.values()), w)
            ws = torch._foreach_mul(stats, w_bn)
            if gsum is None:
                gsum, ssum = wg, ws
            else:
                torch._foreach_add_(gsum, wg)
                torch._foreach_add_(ssum, ws)
            lsum = lsum + w * loss
            wsum = wsum + w
            bsum = bsum + w_bn
            outs.append(out)
        wsum = wsum.clamp_min(1e-9)
        torch._foreach_div_(gsum, wsum)
        torch._foreach_div_(ssum, bsum.clamp_min(1e-9))
        torch._foreach_copy_(stats, ssum)
        optimizer.step(gsum, optimizer.lr)
        return lsum / wsum, torch.stack(outs)

    return dev, gen, body


def make_eval_step(model: nn.Module, device: Union[str, torch.device] = "cuda"
                   ) -> Callable[[GraphsTuple], torch.Tensor]:
    """Move ``model`` to ``device`` (default "cuda"; without CUDA this raises
    unless ``device="cpu"``) in eval mode and return ``step(batch)``, which
    moves the batch there and runs the forward under
    ``torch.inference_mode()``.  The result stays on the device: the caller
    decides when to synchronise."""
    dev = resolve_device(device)
    model.to(dev).eval()

    def step(batch: GraphsTuple) -> torch.Tensor:
        batch = batch.to(dev, non_blocking=True)
        with torch.inference_mode():
            return model(batch, training=False)

    return step


def _as_list(batches, what: str = "the scanned steps") -> List[GraphsTuple]:
    """A sequence of batches, or a stack of them (``stack_batches``), as a
    non-empty list of one bucket shape (``GraphsTuple.shape_key``); ``what``
    names the caller in the errors."""
    out = (unstack_batches(batches) if isinstance(batches, GraphsTuple)
           else list(batches))
    if not out:
        raise ValueError(f"{what} need at least one batch")
    key = out[0].shape_key()
    for b in out[1:]:
        if b.shape_key() != key:
            raise ValueError(f"{what} take batches of one bucket shape, "
                             f"not two shapes: {b.shape_key()} and {key}")
    return out


class _GraphedStep:
    """One call of ``fn(*batches)`` captured in a CUDA graph over static
    buffers for its batches (one for a scanned step or forward, K for the
    accumulated step), for one bucket shape.  ``run(groups)`` copies each
    group of batches into the buffers, replays the graph and copies the
    results into slot i of the outputs.

    Capture: ``fn`` runs ``WARMUP_CALLS`` times eagerly on a side stream
    (the kernels' builds and the allocator settle), then once under
    capture; ``restore`` undoes what the eager calls changed.  The buffers
    are fresh allocations, 16-byte aligned, as the kernels' plans
    (``ops/segment_sum.py::segment_sum_plan``) assume.  The capture runs no
    host sync (``capture_begin`` and ``capture_end`` directly, without
    ``torch.cuda.graph``'s device synchronize), so a caller can hold the
    whole first call to ``torch.cuda.set_sync_debug_mode("error")``.  A
    failed capture raises; nothing runs the step eagerly in its place."""

    def __init__(self, fn, batches: Sequence[GraphsTuple], dev: torch.device,
                 generator=None, restore=None):
        self.static = [b.empty_like(dev).copy_(b) for b in batches]
        current = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(current)
        try:
            with torch.cuda.stream(side):
                for _ in range(WARMUP_CALLS):
                    fn(*self.static)
                self.graph = torch.cuda.CUDAGraph()
                if generator is not None:
                    # each replay draws the next dropout masks of the
                    # generator, as the eager step would
                    self.graph.register_generator_state(generator)
                self.graph.capture_begin()
                try:
                    self.result = fn(*self.static)
                finally:
                    self.graph.capture_end()
        finally:
            current.wait_stream(side)
            if restore is not None:
                restore()

    def run(self, groups: Sequence[Sequence[GraphsTuple]]):
        """Replay the call on each group of batches; the results stacked,
        [len(groups), ...]."""
        outs = [torch.empty((len(groups),) + r.shape, dtype=r.dtype,
                            device=r.device) for r in self.result]
        for i, group in enumerate(groups):
            for static, batch in zip(self.static, group):
                static.copy_(batch)
            self.graph.replay()
            for out, r in zip(outs, self.result):
                out[i].copy_(r)
        return outs


def _capture_train(fn, batches: Sequence[GraphsTuple], dev: torch.device,
                   model: nn.Module, optimizer: Adam,
                   gen: torch.Generator) -> _GraphedStep:
    """``_GraphedStep`` of a train step ``fn``, whose warm-ups and capture
    train: the parameters, buffers and Adam state, the optimizer's
    ``count`` and the generator come out of the capture as they went in."""
    state = ([p.data for p in model.parameters()] + list(model.buffers())
             + optimizer.state_tensors())
    saved = [t.clone() for t in state]
    count, rng = optimizer.count, gen.get_state()

    def restore():
        torch._foreach_copy_(state, saved)
        optimizer.count = count
        gen.set_state(rng)

    return _GraphedStep(fn, batches, dev, gen, restore)


def make_scan_train_steps(model: nn.Module, optimizer: Adam, loss_fn: LossFn,
                          weight_decay: float = 0.0, weight_decay2: float = 0.0,
                          reg_p: int = 2, seed: int = 0,
                          device: Union[str, torch.device] = "cuda"
                          ) -> Callable[..., Tuple[torch.Tensor, torch.Tensor]]:
    """``steps(batches, lr) -> (losses [S], outs [S, G, T])``: S train
    steps, one after another, over S same-shape batches (a sequence, or a
    stack from ``graph.stack_batches``) at one learning rate ``lr`` (a
    float or a 0-d tensor), as device tensors with no host sync
    (phc_gnn_tpu/train/state.py:173-199).  Arguments as
    ``make_train_step``; each step computes what one ``make_train_step``
    call computes, with the dropout masks drawn in the same order from a
    generator seeded with ``seed``.

    On CUDA the first call for a bucket shape (every tensor field's shape
    and dtype) captures one step in a CUDA graph (``_GraphedStep``); the
    model, the optimizer and the generator come out of the capture as they
    went in.  Each batch is then copied into the graph's static buffers and
    the graph replayed.  The optimizer's ``count`` advances by S on the
    host.  On the CPU the steps run eagerly."""
    dev = _bind(model, optimizer, device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    one_step = _one_step(model, optimizer, loss_fn, weight_decay,
                         weight_decay2, reg_p, gen)
    graphs: Dict[tuple, _GraphedStep] = {}

    def steps(batches, lr: Union[float, torch.Tensor]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        batches = _as_list(batches)
        optimizer.set_lr(lr)
        if dev.type != "cuda":
            losses, outs = zip(*(one_step(b.to(dev)) for b in batches))
            return torch.stack(losses), torch.stack(outs)
        key = batches[0].shape_key()
        if key not in graphs:
            graphs[key] = _capture_train(
                one_step, [batches[0].to(dev, non_blocking=True)], dev, model,
                optimizer, gen)
        losses, outs = graphs[key].run([(b,) for b in batches])
        optimizer.count += len(batches)
        return losses, outs

    return steps


def make_scan_eval_steps(model: nn.Module,
                         device: Union[str, torch.device] = "cuda"
                         ) -> Callable[..., torch.Tensor]:
    """``steps(batches) -> outs [S, G, T]``: the eval forward of S
    same-shape batches (a sequence or a stack), a device tensor
    (phc_gnn_tpu/train/state.py:202-214).  Moves ``model`` to ``device`` in
    eval mode, as ``make_eval_step``.  On CUDA one forward is captured in a
    CUDA graph per bucket shape and replayed for each batch; on the CPU the
    forwards run eagerly."""
    dev = resolve_device(device)
    model.to(dev).eval()
    graphs: Dict[tuple, _GraphedStep] = {}

    def forward(batch: GraphsTuple) -> Tuple[torch.Tensor]:
        return (model(batch, training=False),)

    def steps(batches) -> torch.Tensor:
        batches = _as_list(batches)
        with torch.inference_mode():
            if dev.type != "cuda":
                return torch.stack([forward(b.to(dev))[0] for b in batches])
            key = batches[0].shape_key()
            if key not in graphs:
                graphs[key] = _GraphedStep(
                    forward, [batches[0].to(dev, non_blocking=True)], dev)
            return graphs[key].run([(b,) for b in batches])[0]

    return steps
