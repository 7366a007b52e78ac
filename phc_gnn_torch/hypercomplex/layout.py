"""Layout bijection between flat component-block and stacked PHM tensors.

Counterpart of phc_gnn_tpu/hypercomplex/layout.py: flat ``[..., n*d]``
stores the component blocks one after another; stacked ``[..., n, d]``
makes the component axis explicit.
"""

from __future__ import annotations

import torch

__all__ = ["to_stacked", "to_flat"]


def to_stacked(x: torch.Tensor, phm_dim: int) -> torch.Tensor:
    """[..., n*d] -> [..., n, d]."""
    if x.shape[-1] % phm_dim:
        raise ValueError(f"a last axis of {x.shape[-1]} does not split into "
                         f"{phm_dim} components")
    return x.reshape(x.shape[:-1] + (phm_dim, x.shape[-1] // phm_dim))


def to_flat(x: torch.Tensor) -> torch.Tensor:
    """[..., n, d] -> [..., n*d]."""
    return x.reshape(x.shape[:-2] + (x.shape[-2] * x.shape[-1],))
