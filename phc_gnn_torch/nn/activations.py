"""Split (component-wise) activations: on flat arrays a "split" hypercomplex
activation is the elementwise one (phc_gnn_tpu/nn/activations.py).

Beside the registry, as in JAX and outside it, the experimental quaternion
gating activations on stacked ``[..., n, d]`` tensors (activations.py:33-64;
reference: phc/quaternion/activations.py:50-105).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F

__all__ = ["get_activation", "ACTIVATIONS", "qrelu_naive", "qrelu_naive2",
           "interaction_gate", "qrelu_interaction", "qswish_interaction"]


def _identity(x):
    return x


ACTIVATIONS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "relu": F.relu,
    "lrelu": lambda x: F.leaky_relu(x, negative_slope=0.01),
    "elu": lambda x: F.elu(x, alpha=1.0),
    "selu": F.selu,
    "swish": F.silu,
    "identity": _identity,
}


def qrelu_naive(q: torch.Tensor) -> torch.Tensor:
    """Pass the whole hypercomplex number iff the component sum is positive
    (reference: activations.py:50-67)."""
    return q * (q.sum(dim=-2, keepdim=True) > 0).to(q.dtype)


def qrelu_naive2(q: torch.Tensor) -> torch.Tensor:
    """Pass iff every component is positive (reference:
    activations.py:70-85)."""
    return q * (q > 0).all(dim=-2, keepdim=True).to(q.dtype)


def interaction_gate(q: torch.Tensor) -> torch.Tensor:
    """Norm-based interaction factor ``f = |q| / max(|q|, mean_d |q|)``
    (reference: activations.py:88-93).  ``|q|`` is ``jnp.linalg.norm``'s
    formula, so its gradient at 0 is JAX's (NaN)."""
    norm = torch.sqrt((q * q).sum(dim=-2))
    c = norm.mean(dim=-1, keepdim=True)
    return norm / torch.maximum(norm, c)


def qrelu_interaction(q: torch.Tensor) -> torch.Tensor:
    """relu(f * q) with the interaction gate (reference:
    activations.py:96-99)."""
    return F.relu(q * interaction_gate(q)[..., None, :])


def qswish_interaction(q: torch.Tensor) -> torch.Tensor:
    """swish(f * q) with the interaction gate (reference:
    activations.py:102-105)."""
    return F.silu(q * interaction_gate(q)[..., None, :])


def get_activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    name = name.lower()
    if name in ("none", ""):
        return _identity
    if name not in ACTIVATIONS:
        raise ValueError(f"unknown activation {name!r}; valid: {sorted(ACTIVATIONS)}")
    return ACTIVATIONS[name]
