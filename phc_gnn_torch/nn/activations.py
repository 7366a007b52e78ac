"""Split (component-wise) activations: on flat arrays a "split" hypercomplex
activation is the elementwise one (phc_gnn_tpu/nn/activations.py)."""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F

__all__ = ["get_activation", "ACTIVATIONS"]


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


def get_activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    name = name.lower()
    if name in ("none", ""):
        return _identity
    if name not in ACTIVATIONS:
        raise ValueError(f"unknown activation {name!r}; valid: {sorted(ACTIVATIONS)}")
    return ACTIVATIONS[name]
