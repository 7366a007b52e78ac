"""Flax variables -> state_dict of the port's modules.

The port names its modules, parameters and buffers after the flax tree, so a
flax path ``a/b/c`` becomes the key ``a.b.c``; ``params`` and
``batch_stats`` land in one state_dict (batch-norm ``mean``/``var`` are
buffers).  One leaf changes layout: flax ``nn.Dense`` keeps ``kernel`` as
(in, out) where ``torch.nn.Linear`` keeps ``weight`` as (out, in); that
covers the pooling's and head's real transformers and the continuous-input
encoders' ``linear``.  The encoders' trees map one to one:
``encoder_<c>.integer.embedding_<i>`` of a ``PHMEncoder``, and
``encoder.integer.embedding_<i>`` or ``encoder.linear`` of a
``NaivePHMEncoder``.

``from_flax_params`` fills the parameters alone from a flax ``params``
tree and keeps the model's running stats: the trainer's ``init_from``
warm start, as JAX's keeps its fresh ``batch_stats``.

``adam_state_from_optax`` carries optax's Adam moments across the same way
(``count``, and the ``mu`` and ``nu`` trees, keyed like the params), so a run
started in JAX can continue in the port.

Takes nested dicts of numpy arrays (``jax.device_get`` of the variables), so
this module needs no JAX.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

__all__ = ["from_flax_variables", "from_flax_params", "adam_state_from_optax"]


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
        flat.update(_port_keys(variables.get(col, {})))
    return _match(flat, model.state_dict())


def from_flax_params(params: Mapping, model: nn.Module
                     ) -> "OrderedDict[str, torch.Tensor]":
    """The state_dict of ``model`` with its parameters filled from a flax
    ``params`` tree and its buffers (the running stats) kept as they are:
    the warm start of JAX's trainer (``init_from``,
    phc_gnn_tpu/train/trainer.py:506-519), which replaces the params and
    keeps the fresh ``batch_stats``.  Raises ``KeyError`` on a leaf the
    model lacks or a parameter the tree lacks, and ``ValueError`` on a shape
    mismatch.  The result lies on the CPU."""
    state = model.state_dict()
    named = OrderedDict((k, state[k]) for k, _ in model.named_parameters())
    out = OrderedDict((k, t.detach().cpu().clone()) for k, t in state.items())
    out.update(_match(_port_keys(params), named))
    return out


def _port_keys(tree: Mapping) -> Dict[str, np.ndarray]:
    """A flax tree flattened to the port's keys and layouts."""
    flat = {}
    for key, arr in _flatten(tree).items():
        if key.endswith(".kernel"):  # nn.Dense (in, out) -> Linear (out, in)
            key, arr = key[:-len("kernel")] + "weight", arr.T
        flat[key] = arr
    return flat


def _match(flat: Dict[str, np.ndarray], expected: Mapping[str, torch.Tensor]
           ) -> "OrderedDict[str, torch.Tensor]":
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


def adam_state_from_optax(count, mu: Mapping, nu: Mapping, model: nn.Module
                          ) -> Tuple[int, "OrderedDict[str, torch.Tensor]",
                                     "OrderedDict[str, torch.Tensor]"]:
    """optax ``ScaleByAdamState`` (its ``count`` and the ``mu`` and ``nu``
    trees, keyed like the flax params) -> ``(count, mu, nu)`` keyed like
    ``model.named_parameters()``, for ``train.Adam.load_state``.  Raises as
    ``from_flax_variables`` does on a missing, extra or mis-shaped leaf."""
    expected = OrderedDict(model.named_parameters())
    return (int(np.asarray(count)), _match(_port_keys(mu), expected),
            _match(_port_keys(nu), expected))
