"""PHM weight and multiplication-rule regularization.

Counterpart of phc_gnn_tpu/nn/regularization.py: the terms run over the
parameters named ``W`` and ``phm_rule`` (the last part of the parameter's
name), the leaves that ``_leaves_named`` selects in the flax tree
(regularization.py:17-24); every PHMLinear contributes.  Takes a mapping of
parameter names to tensors, such as ``dict(model.named_parameters())``.

The 1-norm takes JAX's subgradient of ``|x|`` at 0, which is 1 (torch's
``abs`` gives 0): the standard rules hold zeros, and their gradient would
otherwise differ from the reference's.
"""

from __future__ import annotations

from typing import Mapping

import torch

__all__ = ["phm_weight_regularization", "multiplication_rule_regularization"]


def _named(params: Mapping[str, torch.Tensor], name: str):
    return [t for key, t in params.items() if key.rsplit(".", 1)[-1] == name]


def _sum(terms) -> torch.Tensor:
    """One reduction over the stacked terms; 0 without any."""
    return torch.stack(terms).sum() if terms else torch.zeros(())


def _norm(t: torch.Tensor, p: int, dim=None) -> torch.Tensor:
    if p == 1:
        return torch.where(t >= 0, t, -t).sum(dim=dim)
    if p == 2:
        return torch.linalg.vector_norm(t, ord=2, dim=dim)
    raise ValueError(f"p must be 1 or 2, got {p}")


def phm_weight_regularization(params: Mapping[str, torch.Tensor],
                              p: int = 2) -> torch.Tensor:
    """Sum over the PHM weights W (n, fi, fo) of the mean over (fi, fo) of
    their p-norm across the component axis (reference
    phc/hypercomplex/regularization.py:15-23)."""
    return _sum([_norm(w, p, dim=0).mean() for w in _named(params, "W")])


def multiplication_rule_regularization(params: Mapping[str, torch.Tensor],
                                       p: int = 1) -> torch.Tensor:
    """Sum over the contribution tensors of their full p-norm (reference
    phc/hypercomplex/regularization.py:4-12)."""
    return _sum([_norm(rule, p) for rule in _named(params, "phm_rule")])
