"""Losses with NaN-target masking, over padded graph batches.

Counterpart of phc_gnn_tpu/train/loss.py: BCE-with-logits on the non-NaN
mask (molhiv, molpcba), cross-entropy with a graph mask (ppa, mnist,
cifar10), L1 for ZINC, and MSE.  Padding graphs carry NaN labels, so the
same mask removes them.  Each loss is a mean over the counted entries, with
the count clamped to at least 1.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["masked_bce_with_logits", "masked_l1", "masked_cross_entropy",
           "masked_mse"]


def _masked_mean(per: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, per, 0.0).sum() / mask.sum().clamp_min(1)


def masked_bce_with_logits(logits: torch.Tensor,
                           targets: torch.Tensor) -> torch.Tensor:
    """Mean BCE over finite targets (multi-task safe)."""
    mask = torch.isfinite(targets)
    t = torch.where(mask, targets, 0.0)
    per = (logits.clamp_min(0) - logits * t
           + torch.log1p(torch.exp(-logits.abs())))
    return _masked_mean(per, mask)


def masked_l1(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    mask = torch.isfinite(targets)
    return _masked_mean((logits - torch.where(mask, targets, 0.0)).abs(), mask)


def masked_mse(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    mask = torch.isfinite(targets)
    diff = logits - torch.where(mask, targets, 0.0)
    return _masked_mean(diff * diff, mask)


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                         graph_mask: torch.Tensor) -> torch.Tensor:
    """Softmax cross-entropy with integer labels [G]; padding graphs are
    masked out."""
    logp = F.log_softmax(logits, dim=-1)
    safe = torch.where(graph_mask, labels, 0).long()
    per = -logp.gather(-1, safe[:, None])[:, 0]
    return _masked_mean(per, graph_mask)
