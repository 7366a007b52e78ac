"""Optimizer and LR scheduling: global-norm clipping, then Adam, with the
learning rate applied outside the optimizer.

Counterpart of phc_gnn_tpu/train/optim.py.  JAX chains optax's
``clip_by_global_norm``, ``scale_by_adam`` and ``scale(-1)`` (optim.py:24-38)
and the train step multiplies the update by the live learning rate, so the
host-side plateau scheduler changes lr without touching optimizer state.
``Adam`` here clips as optax does and hands the clipped gradients to torch's
fused Adam with the learning rate of the step.  That computes the same update:

    g      <- g if ||g|| < clip else g * (clip / ||g||)   (global norm)
    mu     <- (1 - b1) g + b1 mu,   nu <- (1 - b2) g^2 + b2 nu
    param  <- param - lr * (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)

with no host sync (optax clips as ``(g / ||g||) * clip``: the same value to
1 ulp).  The optimizer has no Pallas kernel in JAX.  ``ReduceLROnPlateau``
is pure Python, a copy of JAX's.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Mapping, Optional, Sequence

import torch

__all__ = ["Adam", "make_optimizer", "ReduceLROnPlateau"]


class Adam:
    """Adam after an optional global-norm clip, over named parameters.

    ``params`` maps names to the tensors it updates in place (those that
    require a gradient); ``count`` is the number of steps taken, kept on the
    host.  b1 and b2 are torch's and optax's defaults, 0.9 and 0.999."""

    def __init__(self, params: Mapping[str, torch.Tensor],
                 grad_clip: float = 0.0, eps: float = 1e-8):
        self.params: Dict[str, torch.Tensor] = {
            k: p for k, p in params.items() if p.requires_grad}
        self.grad_clip = float(grad_clip)
        self.count = 0
        self.adam = torch.optim.Adam(list(self.params.values()), lr=0.0,
                                     eps=eps, fused=True)

    def load_state(self, count: int, mu: Mapping[str, torch.Tensor],
                   nu: Mapping[str, torch.Tensor]) -> None:
        """Continue from a saved state: ``count`` steps taken, moments keyed
        like ``params`` (``convert.adam_state_from_optax`` reads optax's).
        The moments are copied in each parameter's device, dtype and
        memory order as they are now."""
        missing = sorted(set(self.params) - set(mu) | set(self.params) - set(nu))
        if missing:
            raise KeyError(f"optimizer state lacks {missing}")
        self.count = int(count)
        for k, p in self.params.items():
            self.adam.state[p] = {
                "step": torch.tensor(float(count), device=p.device),
                "exp_avg": torch.empty_like(p).copy_(mu[k]),
                "exp_avg_sq": torch.empty_like(p).copy_(nu[k])}

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor], lr: float) -> None:
        """One update from ``grads``, in the order of ``params``."""
        if len(grads) != len(self.params):
            raise ValueError(f"{len(grads)} gradients for {len(self.params)} "
                             f"parameters")
        grads = list(grads)
        if self.grad_clip > 0.0:
            norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(grads)))
            scale = torch.where(norm < self.grad_clip, 1.0,
                                self.grad_clip / norm)
            grads = torch._foreach_mul(grads, scale)
        for p, g in zip(self.params.values(), grads):
            p.grad = _like(p, g)
        self.adam.param_groups[0]["lr"] = lr
        self.adam.step()
        self.adam.zero_grad(set_to_none=True)
        self.count += 1


def _like(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``t`` in ``p``'s device, dtype and strides: the fused kernel walks a
    parameter, its gradient and its moments in the same memory order."""
    if (t.device, t.dtype, t.stride()) == (p.device, p.dtype, p.stride()):
        return t
    return torch.empty_like(p).copy_(t)


def make_optimizer(params: Mapping[str, torch.Tensor], grad_clip: float = 0.0,
                   eps: float = 1e-8) -> Adam:
    """Adam with optional global-norm clipping over ``params`` (e.g.
    ``dict(model.named_parameters())``).  JAX's ``make_optimizer`` also takes
    an ``lr`` that it does not use; the train step applies the learning rate
    it is given."""
    return Adam(params, grad_clip=grad_clip, eps=eps)


@dataclass
class ReduceLROnPlateau:
    """Host-side plateau scheduler matching torch semantics
    (mode max/min, factor, patience, min_lr)."""

    lr: float
    mode: str = "max"  # max | min
    factor: float = 0.75
    patience: int = 10
    min_lr: float = 1e-6
    threshold: float = 1e-4

    best: Optional[float] = field(default=None, init=False)
    num_bad: int = field(default=0, init=False)

    def step(self, metric: float) -> float:
        """Feed the epoch's validation metric; returns the (possibly
        reduced) lr."""
        if self.best is None:
            self.best = metric
            return self.lr
        # torch's relative-threshold rule (ReduceLROnPlateau.is_better):
        # best*(1+threshold) for max, best*(1-threshold) for min, whatever
        # the sign of best (PARITY #9)
        if self.mode == "max":
            improved = metric > self.best * (1.0 + self.threshold)
        else:
            improved = metric < self.best * (1.0 - self.threshold)
        if improved:
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.num_bad = 0
        return self.lr
