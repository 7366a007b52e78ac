"""Masked segment reductions over padded edge/node arrays, in plain PyTorch.

Counterpart of phc_gnn_tpu/graph/segment.py for what the ported path needs:
the masked segment sum of the pooling readout.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["segment_sum"]


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out[s] = sum of data[i] over i with segment_ids[i] == s and mask[i]``."""
    if mask is not None:
        data = torch.where(mask.reshape(mask.shape + (1,) * (data.ndim - 1)),
                           data, 0)
    out = torch.zeros((num_segments,) + data.shape[1:], dtype=data.dtype,
                      device=data.device)
    return out.index_add_(0, segment_ids, data)
