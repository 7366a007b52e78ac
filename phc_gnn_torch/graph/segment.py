"""Masked segment reductions over padded edge/node arrays, in plain PyTorch.

Counterpart of phc_gnn_tpu/graph/segment.py (:45-140): the masked segment
sum of the pooling readout and the aggregations, the count, mean, min, max,
var and std, and the per-segment softmax weights.  They are the CPU path of
a batch without a CSR plan, and the composite route on any device
(``agg_kernel="xla"``, ``graph/conv.py``), and follow ``jax.ops.segment_*``:
masked entries are filled with -1e30 (+1e30 for the min) and an empty
segment gives 0; a tie at a segment's max or min splits the gradient evenly
among the tied entries, as ``jax.ops.segment_max``'s does
(``scatter_reduce`` "amax"/"amin").

``axis_name`` names a mesh axis (``parallel.mesh.axis``) that holds an edge
shard a rank with the node arrays replicated (``parallel/edge_partition.py``):
each rank's partial reduction is then combined over the axis, the sums and
counts by ``psum``, the max by ``pmax`` and the min by ``pmin``, so the
result is the whole edge set's; the var and std go through the mean, and the
softmax takes both its max and its normalizer over the axis.  ``pmax`` and
``pmin`` have no derivative, as in JAX: a max or min over the axis raises in
the backward.
"""

from __future__ import annotations

from typing import Optional

import torch

from phc_gnn_torch.parallel import mesh

__all__ = ["segment_sum", "segment_count", "segment_mean", "segment_min",
           "segment_max", "segment_var", "segment_std",
           "segment_softmax_weights"]

_NEG = -1e30  # large finite stand-in for -inf (segment.py:37)


def _mask2d(mask: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (data.ndim - mask.ndim))


def _psum(out: torch.Tensor, axis_name: Optional[str]) -> torch.Tensor:
    return out if axis_name is None else mesh.psum(out, mesh.axis(axis_name))


def _raw_sum(data, segment_ids, num_segments: int) -> torch.Tensor:
    out = torch.zeros((num_segments,) + data.shape[1:], dtype=data.dtype,
                      device=data.device)
    return out.index_add_(0, segment_ids, data)


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, mask: Optional[torch.Tensor] = None,
                axis_name: Optional[str] = None) -> torch.Tensor:
    """``out[s] = sum of data[i] over i with segment_ids[i] == s and mask[i]``
    (over the ranks of ``axis_name`` too)."""
    if mask is not None:
        data = torch.where(_mask2d(mask, data), data, 0)
    return _psum(_raw_sum(data, segment_ids, num_segments), axis_name)


def segment_count(segment_ids: torch.Tensor, num_segments: int,
                  mask: Optional[torch.Tensor] = None, dtype=torch.float32,
                  axis_name: Optional[str] = None) -> torch.Tensor:
    """[num_segments] number of entries of each segment whose mask holds."""
    ones = torch.ones(segment_ids.shape, dtype=dtype, device=segment_ids.device)
    return segment_sum(ones, segment_ids, num_segments, mask, axis_name)


def segment_mean(data, segment_ids, num_segments: int, mask=None,
                 axis_name=None):
    total = segment_sum(data, segment_ids, num_segments, mask, axis_name)
    count = segment_count(segment_ids, num_segments, mask, total.dtype,
                          axis_name)
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


def segment_max(data, segment_ids, num_segments: int, mask=None,
                axis_name=None):
    """Max; empty or all-masked segments give 0."""
    out = _extreme(data, segment_ids, num_segments, mask, "amax", _NEG)
    if axis_name is not None:
        out = mesh.pmax(out, mesh.axis(axis_name))
    return torch.where(out <= _NEG / 2, 0.0, out)


def segment_min(data, segment_ids, num_segments: int, mask=None,
                axis_name=None):
    out = _extreme(data, segment_ids, num_segments, mask, "amin", -_NEG)
    if axis_name is not None:
        out = mesh.pmin(out, mesh.axis(axis_name))
    return torch.where(out >= -_NEG / 2, 0.0, out)


def segment_var(data, segment_ids, num_segments: int, mask=None,
                axis_name=None):
    """``E[x^2] - E[x]^2`` per segment (segment.py:90-94)."""
    mean = segment_mean(data, segment_ids, num_segments, mask, axis_name)
    mean_sq = segment_mean(data * data, segment_ids, num_segments, mask,
                           axis_name)
    return mean_sq - mean * mean


def segment_std(data, segment_ids, num_segments: int, mask=None,
                eps: float = 1e-5, axis_name=None):
    """``sqrt(relu(var) + eps)`` (segment.py:97-103)."""
    return torch.sqrt(torch.relu(segment_var(data, segment_ids, num_segments,
                                             mask, axis_name)) + eps)


def segment_softmax_weights(logits, segment_ids, num_segments: int,
                            mask=None, axis_name=None):
    """The softmax of ``logits`` over each segment's entries, entry by entry
    (segment.py:117-140): shifted by the detached segment max, exponentiated
    and divided by the segment's sum; masked entries get weight 0.  With
    ``axis_name`` the max and the normalizer are the whole axis's."""
    if mask is not None:
        logits = torch.where(_mask2d(mask, logits), logits, _NEG)
    seg_max = _extreme(logits.detach(), segment_ids, num_segments, None,
                       "amax", _NEG)
    if axis_name is not None:
        seg_max = mesh.pmax(seg_max, mesh.axis(axis_name))
    seg_max = torch.where(seg_max <= _NEG / 2, 0.0, seg_max)
    ids = segment_ids.long()
    expd = torch.exp(logits - seg_max[ids])
    if mask is not None:
        expd = torch.where(_mask2d(mask, expd), expd, 0.0)
    denom = _psum(_raw_sum(expd, segment_ids, num_segments), axis_name)
    return expd / denom[ids].clamp_min(1e-16)
