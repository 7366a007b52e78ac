"""Training and serving entry points: the train step, the accumulated train
step and the eval step.

Counterparts of ``make_loss_and_aux``, ``make_train_step``,
``make_accum_train_step`` and ``make_eval_step`` in
phc_gnn_tpu/train/state.py:52-170.  The port's model owns its parameters and
running stats, and the optimizer owns its moments, so a step takes the
batches (and the learning rate) alone.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple, Union

import torch
from torch import nn

from phc_gnn_torch.device import resolve_device
from phc_gnn_torch.graph.batch import GraphsTuple
from phc_gnn_torch.nn.regularization import (
    multiplication_rule_regularization,
    phm_weight_regularization,
)
from phc_gnn_torch.parallel.dp import loss_weight
from phc_gnn_torch.train.optim import Adam

__all__ = ["make_loss_and_grads", "make_train_step", "make_accum_train_step",
           "make_eval_step"]

LossFn = Callable[[torch.Tensor, GraphsTuple], torch.Tensor]


def make_loss_and_grads(model: nn.Module, loss_fn: LossFn,
                        weight_decay: float = 0.0, weight_decay2: float = 0.0,
                        reg_p: int = 2):
    """``f(batch, lr, generator) -> (loss, out, grads)``: the training
    forward, the masked task loss plus the reference's lr-scaled weight and
    rule regularization (``loss += lr*wd*phm_weight_reg + lr*wd2*rule_reg``,
    train_hiv.py:180-191), and the gradients of every parameter that
    requires one, keyed by name.  The forward updates the batch-norm running
    stats; ``loss`` and ``out`` come back detached."""
    named = dict(model.named_parameters())
    trainable = {k: p for k, p in named.items() if p.requires_grad}

    def loss_and_grads(batch: GraphsTuple, lr: float,
                       generator: torch.Generator = None
                       ) -> Tuple[torch.Tensor, torch.Tensor,
                                  Dict[str, torch.Tensor]]:
        out = model(batch, training=True, generator=generator)
        loss = loss_fn(out, batch)
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
    loss_and_grads = make_loss_and_grads(model, loss_fn, weight_decay,
                                         weight_decay2, reg_p)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def step(batch: GraphsTuple, lr: float) -> Tuple[torch.Tensor, torch.Tensor]:
        batch = batch.to(dev, non_blocking=True)
        loss, out, grads = loss_and_grads(batch, lr, gen)
        optimizer.step(list(grads.values()), lr)
        return loss, out

    return step


def _bind(model: nn.Module, optimizer: Adam, device) -> torch.device:
    """Move ``model`` to ``device`` and check that ``optimizer`` holds its
    trainable parameters, in order."""
    dev = resolve_device(device)
    model.to(dev)
    trainable = {k: p for k, p in model.named_parameters() if p.requires_grad}
    if (list(optimizer.params) != list(trainable)
            or any(optimizer.params[k] is not p for k, p in trainable.items())):
        raise ValueError("the optimizer was not built on this model's "
                         "parameters")
    return dev


def make_accum_train_step(model: nn.Module, optimizer: Adam, loss_fn: LossFn,
                          weight_decay: float = 0.0, weight_decay2: float = 0.0,
                          reg_p: int = 2, loss_name: str = "l1", seed: int = 0,
                          device: Union[str, torch.device] = "cuda"
                          ) -> Callable[[Sequence[GraphsTuple], float],
                                        Tuple[torch.Tensor, torch.Tensor]]:
    """Gradient accumulation: ``step(batches, lr)`` takes ONE optimizer step
    from the exact load-weighted mean gradient of K same-shape sub-batches
    (phc_gnn_tpu/train/state.py:116-170) and returns ``(loss, outs [K, G,
    T])`` as device tensors, with no host sync.

    Each sub-batch k runs the training forward and backward from the SAME
    parameters and the SAME running stats; with ``w_k = loss_weight(batch,
    loss_name)`` the gradient is ``sum w_k grad_k / max(sum w_k, 1e-9)`` and
    the loss is weighted the same way, so a fully masked sub-batch weighs 0.
    The clip and the Adam update act on that mean.  The running stats become
    ``sum n_k stats_k / max(sum n_k, 1e-9)``, ``n_k`` the sub-batch's real
    nodes (state.py:144-163): the norms update their buffers in place, so
    the step keeps the stats it started from, restores them before each
    sub-batch and writes the weighted mean at the end.  Arguments as
    ``make_train_step``; the batches need their CSR plans on a CUDA
    device."""
    dev = _bind(model, optimizer, device)
    loss_and_grads = make_loss_and_grads(model, loss_fn, weight_decay,
                                         weight_decay2, reg_p)
    gen = torch.Generator(device=dev).manual_seed(seed)
    stats = [b for b in model.buffers() if b.is_floating_point()]

    def step(batches: Sequence[GraphsTuple], lr: float
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        if not batches:
            raise ValueError("the accumulated step needs at least one batch")
        start = [s.clone() for s in stats]
        gsum = ssum = None
        lsum = wsum = bsum = torch.zeros((), dtype=torch.float32, device=dev)
        outs = []
        for batch in batches:
            batch = batch.to(dev, non_blocking=True)
            for s, s0 in zip(stats, start):
                s.copy_(s0)
            loss, out, grads = loss_and_grads(batch, lr, gen)
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
        optimizer.step(gsum, lr)
        return lsum / wsum, torch.stack(outs)

    return step


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
