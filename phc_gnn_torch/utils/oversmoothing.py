"""Oversmoothing diagnostics: PairNorm's row-diff and col-diff
(counterpart of phc_gnn_tpu/utils/oversmoothing.py; reference:
phc/quaternion/misc.py:7-42)."""

from __future__ import annotations

import torch

__all__ = ["row_diff", "col_diff"]


def row_diff(x: torch.Tensor) -> torch.Tensor:
    """Mean pairwise L2 distance between node-feature rows."""
    d = x[:, None, :] - x[None, :, :]
    return torch.mean(torch.sqrt(torch.sum(d * d, dim=-1) + 1e-12))


def col_diff(x: torch.Tensor) -> torch.Tensor:
    """Mean pairwise L1 distance between L1-normalized feature columns."""
    xn = x / torch.clamp(torch.sum(torch.abs(x), dim=0, keepdim=True),
                         min=1e-12)
    d = xn[:, :, None] - xn[:, None, :]
    return torch.mean(torch.sum(torch.abs(d), dim=0))
