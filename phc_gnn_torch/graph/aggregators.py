"""Aggregations as plain PyTorch composites.

Counterpart of phc_gnn_tpu/graph/aggregators.py for what the port runs:
``AGGREGATORS`` maps ``(messages [E, D], receivers [E], num_nodes,
edge_mask)`` to node arrays [N, D], so far for ``"sum"`` alone (the others
come with ROADMAP.md, section 1, item 9); ``softmax_aggregate`` (:71-96) is
``out = segment_sum(softmax(beta * m) * m)`` per node and lane, computed as
a numerator over a denominator.  They are the CPU path of a batch without a
CSR plan, and the reference that the segment kernels (ops/segment_softmax.py,
ops/segment_sum.py) are held to.
"""

from __future__ import annotations

from typing import Optional

import torch

from phc_gnn_torch.graph import segment as seg

__all__ = ["AGGREGATORS", "softmax_aggregate"]

AGGREGATORS = {
    "sum": seg.segment_sum,
}


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
