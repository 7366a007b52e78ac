"""Optimizer and LR scheduling: global-norm clipping, then Adam, with the
learning rate applied outside the optimizer.

Counterpart of phc_gnn_tpu/train/optim.py.  JAX chains optax's
``clip_by_global_norm``, ``scale_by_adam`` and ``scale(-1)`` (optim.py:24-38)
and the train step multiplies the update by the live learning rate, so the
host-side plateau scheduler changes lr without touching optimizer state.
``Adam`` here clips as optax does and hands the clipped gradients to torch's
fused Adam with the learning rate of the step, a tensor that the optimizer
owns, so that the step runs in a CUDA graph and the scheduler's changes
reach it.  That computes the same update:

    g      <- g if ||g|| < clip else g * (clip / ||g||)   (global norm)
    mu     <- (1 - b1) g + b1 mu,   nu <- (1 - b2) g^2 + b2 nu
    param  <- param - lr * (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)

with no host sync (optax clips as ``(g / ||g||) * clip``: the same value to
1 ulp).  The optimizer has no Pallas kernel in JAX.  ``ReduceLROnPlateau``
is pure Python, a copy of JAX's.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Mapping, Optional, Sequence, Union

import torch

__all__ = ["Adam", "make_optimizer", "ReduceLROnPlateau"]


class Adam:
    """Adam after an optional global-norm clip, over named parameters.

    ``params`` maps names to the tensors it updates in place (those that
    require a gradient).  b1 and b2 are torch's and optax's defaults, 0.9
    and 0.999.  The optimizer owns its state on the parameters' device, so
    that a CUDA graph can capture its step: the learning rate ``lr``, a 0-d
    float32 tensor; the moments and each parameter's ``step`` count, zero
    from the start (torch's fused Adam, ``capturable`` on CUDA).  ``count``,
    the number of steps taken, is a mirror on the host, advanced by the
    steps that ran and never read back from the device."""

    def __init__(self, params: Mapping[str, torch.Tensor],
                 grad_clip: float = 0.0, eps: float = 1e-8):
        self.params: Dict[str, torch.Tensor] = {
            k: p for k, p in params.items() if p.requires_grad}
        self.grad_clip = float(grad_clip)
        self.eps = float(eps)
        self.count = 0
        self.lr = torch.zeros((), dtype=torch.float32,
                              device=self._params_device())
        self._build({p: {"step": torch.zeros((), dtype=torch.float32,
                                             device=p.device),
                         "exp_avg": torch.zeros_like(p),
                         "exp_avg_sq": torch.zeros_like(p)}
                     for p in self.params.values()})

    def _params_device(self) -> torch.device:
        return next(iter(self.params.values())).device if self.params else (
            torch.device("cpu"))

    def _build(self, state: Mapping[torch.Tensor, dict]) -> None:
        """torch's fused Adam over ``params`` with ``state``, capturable
        where the lr tensor lies on CUDA."""
        self.on_device = self.lr.device.type == "cuda"
        # on the CPU the fused kernel takes the lr as a number, read from
        # ``self.lr`` at each step
        self.adam = torch.optim.Adam(
            list(self.params.values()), lr=self.lr if self.on_device else 0.0,
            eps=self.eps, fused=True, capturable=self.on_device)
        # eager steps are as much this optimizer's use as captured ones:
        # torch warns once about the first, unless told it has
        self.adam._warned_capturable_if_run_uncaptured = True
        for p, st in state.items():
            self.adam.state[p] = st

    def follow_params(self) -> None:
        """Move the lr and the state, values kept, to the device the
        parameters are on now: a model moved after its optimizer was built
        has taken them there (the train steps call this when they move the
        model).  Nothing happens if they are already there."""
        dev = self._params_device()
        if self.lr.device == dev:
            return
        self.lr = self.lr.to(dev)
        self._build({p: {k: t.to(dev) for k, t in self.adam.state[p].items()}
                     for p in self.params.values()})

    def state_tensors(self) -> list:
        """Every tensor of the optimizer's state, ``lr`` included: what a
        caller saves and restores around steps it must undo."""
        return [self.lr] + [t for p in self.params.values()
                            for t in self.adam.state[p].values()]

    def load_state(self, count: int, mu: Mapping[str, torch.Tensor],
                   nu: Mapping[str, torch.Tensor]) -> None:
        """Continue from a saved state: ``count`` steps taken, moments keyed
        like ``params`` (``convert.adam_state_from_optax`` reads optax's).
        The moments are copied into the state's tensors in place, in each
        parameter's device, dtype and memory order."""
        missing = sorted(set(self.params) - set(mu) | set(self.params) - set(nu))
        if missing:
            raise KeyError(f"optimizer state lacks {missing}")
        self.count = int(count)
        for k, p in self.params.items():
            state = self.adam.state[p]
            state["step"].fill_(float(count))
            state["exp_avg"].copy_(mu[k])
            state["exp_avg_sq"].copy_(nu[k])

    def set_lr(self, lr: Union[float, torch.Tensor]) -> None:
        """Write ``lr`` into the optimizer's lr tensor: a float by ``fill_``
        (one launch, no sync), a tensor by a copy (nothing if it is the lr
        tensor itself)."""
        if isinstance(lr, torch.Tensor):
            if lr is not self.lr:
                self.lr.copy_(lr)
        else:
            self.lr.fill_(float(lr))

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor],
             lr: Union[float, torch.Tensor]) -> None:
        """One update from ``grads``, in the order of ``params``, at
        ``lr`` (``set_lr``)."""
        if len(grads) != len(self.params):
            raise ValueError(f"{len(grads)} gradients for {len(self.params)} "
                             f"parameters")
        self.set_lr(lr)
        grads = list(grads)
        if self.grad_clip > 0.0:
            norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(grads)))
            scale = torch.where(norm < self.grad_clip, 1.0,
                                self.grad_clip / norm)
            grads = torch._foreach_mul(grads, scale)
        for p, g in zip(self.params.values(), grads):
            p.grad = _like(p, g)
        if not self.on_device:
            self.adam.param_groups[0]["lr"] = float(self.lr)
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
