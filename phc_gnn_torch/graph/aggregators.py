"""Softmax aggregation as a plain PyTorch composite.

Counterpart of ``softmax_aggregate`` in phc_gnn_tpu/graph/aggregators.py:71-96:
``out = segment_sum(softmax(beta * m) * m)`` per node and lane, computed as a
numerator over a denominator.  It is the CPU reference of the aggregation;
the segment kernels (ops/segment_softmax.py) are held to the same function.
"""

from __future__ import annotations

from typing import Optional

import torch

from phc_gnn_torch.graph import segment as seg

__all__ = ["softmax_aggregate"]


def softmax_aggregate(messages: torch.Tensor, receivers: torch.Tensor,
                      num_nodes: int, beta,
                      edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    logits = beta * messages
    if edge_mask is not None:
        logits = torch.where(edge_mask[:, None], logits, -1e30)
    idx = receivers.long()[:, None].expand_as(logits)
    seg_max = torch.full((num_nodes, messages.shape[1]), float("-inf"),
                         dtype=logits.dtype, device=logits.device)
    seg_max = seg_max.scatter_reduce(0, idx, logits.detach(), "amax")
    seg_max = torch.where(seg_max <= -1e29, 0.0, seg_max)
    expd = torch.exp(logits - seg_max[receivers.long()])
    if edge_mask is not None:
        expd = torch.where(edge_mask[:, None], expd, 0.0)
    numer = seg.segment_sum(expd * messages, receivers, num_nodes)
    denom = seg.segment_sum(expd, receivers, num_nodes)
    return numer / denom.clamp_min(1e-16)
