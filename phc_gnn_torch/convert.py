"""Flax variables -> state_dict of the port's modules.

The port names its modules, parameters and buffers after the flax tree, so a
flax path ``a/b/c`` becomes the key ``a.b.c``; ``params`` and
``batch_stats`` land in one state_dict (batch-norm ``mean``/``var`` are
buffers).  One leaf changes layout: flax ``nn.Dense`` keeps ``kernel`` as
(in, out) where ``torch.nn.Linear`` keeps ``weight`` as (out, in).

Takes nested dicts of numpy arrays (``jax.device_get`` of the variables), so
this module needs no JAX.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

__all__ = ["from_flax_variables"]


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, path + "."))
        else:
            out[path] = np.asarray(v)
    return out


def from_flax_variables(variables: Mapping, model: nn.Module) -> "OrderedDict[str, torch.Tensor]":
    """The state_dict of ``model`` filled from flax ``variables``
    (``{"params": ..., "batch_stats": ...}``).

    Raises ``KeyError`` on a flax leaf the model lacks or a model entry the
    variables lack, and ``ValueError`` on a shape mismatch.  The result
    lies on the CPU; ``model.load_state_dict`` copies it to the model's
    device."""
    unknown_cols = set(variables) - {"params", "batch_stats"}
    if unknown_cols:
        raise KeyError(f"unexpected flax collections {sorted(unknown_cols)}")
    flat: Dict[str, np.ndarray] = {}
    for col in ("params", "batch_stats"):
        for key, arr in _flatten(variables.get(col, {})).items():
            if key.endswith(".kernel"):  # nn.Dense (in, out) -> Linear (out, in)
                key, arr = key[:-len("kernel")] + "weight", arr.T
            flat[key] = arr
    expected = model.state_dict()
    missing = sorted(set(expected) - set(flat))
    extra = sorted(set(flat) - set(expected))
    if missing or extra:
        raise KeyError(f"flax variables do not match the model: missing "
                       f"{missing}, unexpected {extra}")
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for key, ref in expected.items():
        arr = flat[key]
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{key}: flax shape {tuple(arr.shape)} != model "
                             f"shape {tuple(ref.shape)}")
        out[key] = torch.tensor(arr, dtype=ref.dtype)  # a copy, writable
    return out
