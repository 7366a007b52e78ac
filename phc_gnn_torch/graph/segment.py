"""Masked segment reductions over padded edge/node arrays, in plain PyTorch.

Counterpart of phc_gnn_tpu/graph/segment.py (:54-103): the masked segment
sum of the pooling readout and the aggregations, the count, mean, min, max,
var and std.  They are the CPU path of a batch without a CSR plan and follow
``jax.ops.segment_*``: masked entries are filled with -1e30 (+1e30 for the
min) and an empty segment gives 0; a tie at a segment's max or min splits
the gradient evenly among the tied entries, as ``jax.ops.segment_max``'s
does (``scatter_reduce`` "amax"/"amin").
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["segment_sum", "segment_count", "segment_mean", "segment_min",
           "segment_max", "segment_var", "segment_std"]

_NEG = -1e30  # large finite stand-in for -inf (segment.py:37)


def _mask2d(mask: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (data.ndim - mask.ndim))


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out[s] = sum of data[i] over i with segment_ids[i] == s and mask[i]``."""
    if mask is not None:
        data = torch.where(_mask2d(mask, data), data, 0)
    out = torch.zeros((num_segments,) + data.shape[1:], dtype=data.dtype,
                      device=data.device)
    return out.index_add_(0, segment_ids, data)


def segment_count(segment_ids: torch.Tensor, num_segments: int,
                  mask: Optional[torch.Tensor] = None,
                  dtype=torch.float32) -> torch.Tensor:
    """[num_segments] number of entries of each segment whose mask holds."""
    ones = torch.ones(segment_ids.shape, dtype=dtype, device=segment_ids.device)
    return segment_sum(ones, segment_ids, num_segments, mask)


def segment_mean(data, segment_ids, num_segments: int, mask=None):
    total = segment_sum(data, segment_ids, num_segments, mask)
    count = segment_count(segment_ids, num_segments, mask, total.dtype)
    return total / _mask2d(count.clamp_min(1.0), total)


def _extreme(data, segment_ids, num_segments, mask, reduce, fill):
    if mask is not None:
        data = torch.where(_mask2d(mask, data), data, fill)
    index = _mask2d(segment_ids.long(), data).expand_as(data)
    # the initial value is the fill, not 0: scatter_reduce's backward counts
    # it among the ties wherever it equals the result, include_self or not
    out = torch.full((num_segments,) + data.shape[1:], fill, dtype=data.dtype,
                     device=data.device)
    return out.scatter_reduce(0, index, data, reduce, include_self=False)


def segment_max(data, segment_ids, num_segments: int, mask=None):
    """Max; empty or all-masked segments give 0."""
    out = _extreme(data, segment_ids, num_segments, mask, "amax", _NEG)
    return torch.where(out <= _NEG / 2, 0.0, out)


def segment_min(data, segment_ids, num_segments: int, mask=None):
    out = _extreme(data, segment_ids, num_segments, mask, "amin", -_NEG)
    return torch.where(out >= -_NEG / 2, 0.0, out)


def segment_var(data, segment_ids, num_segments: int, mask=None):
    """``E[x^2] - E[x]^2`` per segment (segment.py:90-94)."""
    mean = segment_mean(data, segment_ids, num_segments, mask)
    mean_sq = segment_mean(data * data, segment_ids, num_segments, mask)
    return mean_sq - mean * mean


def segment_std(data, segment_ids, num_segments: int, mask=None,
                eps: float = 1e-5):
    """``sqrt(relu(var) + eps)`` (segment.py:97-103)."""
    return torch.sqrt(torch.relu(segment_var(data, segment_ids, num_segments,
                                             mask)) + eps)
