"""The four reference model classes, expressed as PHCGNN configurations.

Counterpart of phc_gnn_tpu/models/presets.py:23-50:

- ``PHMSkipConnectAdd`` / ``PHMSkipConnectConcat``
  (reference: phc/hypercomplex/undirectional/models.py:24,271);
- ``QuaternionSkipConnectAdd`` / ``QuaternionSkipConnectConcat``: the same
  at ``phm_dim=4`` with the frozen standard (quaternion) rule,
  ``c_init="standard"`` and ``learn_phm=False``
  (reference: phc/quaternion/undirectional/models.py:25,234).

Each takes ``PHCGNN``'s keyword arguments, ``seed`` and ``device`` among
them, and fills only the defaults that its class fixes.
"""

from __future__ import annotations

from phc_gnn_torch.models.phc_gnn import PHCGNN

__all__ = [
    "PHMSkipConnectAdd",
    "PHMSkipConnectConcat",
    "QuaternionSkipConnectAdd",
    "QuaternionSkipConnectConcat",
]


def PHMSkipConnectAdd(**kwargs) -> PHCGNN:
    kwargs.setdefault("skip_connect", "add")
    return PHCGNN(**kwargs)


def PHMSkipConnectConcat(**kwargs) -> PHCGNN:
    kwargs.setdefault("skip_connect", "concat")
    kwargs.setdefault("atom_encoded_dim", 128)
    kwargs.setdefault("mp_layers", (128, 196, 256))
    return PHCGNN(**kwargs)


def QuaternionSkipConnectAdd(**kwargs) -> PHCGNN:
    kwargs["phm_dim"] = 4
    kwargs.setdefault("c_init", "standard")
    kwargs.setdefault("learn_phm", False)
    kwargs.setdefault("skip_connect", "add")
    return PHCGNN(**kwargs)


def QuaternionSkipConnectConcat(**kwargs) -> PHCGNN:
    kwargs["phm_dim"] = 4
    kwargs.setdefault("c_init", "standard")
    kwargs.setdefault("learn_phm", False)
    kwargs.setdefault("skip_connect", "concat")
    kwargs.setdefault("atom_encoded_dim", 128)
    kwargs.setdefault("mp_layers", (128, 196, 256))
    return PHCGNN(**kwargs)
