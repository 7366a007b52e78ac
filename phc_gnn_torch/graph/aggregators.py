"""Aggregations and degree scalers as plain PyTorch composites.

Counterpart of phc_gnn_tpu/graph/aggregators.py: ``AGGREGATORS`` maps
``(messages [E, D], receivers [E], num_nodes, edge_mask)`` to node arrays
[N, D] for sum, mean, min, max, var and std (graph/segment.py);
``softmax_aggregate`` (:71-96) is ``out = segment_sum(softmax(beta * m) * m)``
per node and lane, computed as a numerator over a denominator.  They are the
CPU path of a batch without a CSR plan, the composite route on any device
(``agg_kernel="xla"``), and the reference that the segment kernels
(ops/segment_softmax.py, ops/segment_sum.py, ops/segment_reduce.py) are held
to.  Each takes ``axis_name``, the mesh axis of an edge partition
(graph/segment.py): the aggregations and ``node_degrees`` reduce over it, and
the softmax takes the ``pmax`` of its detached segment max and the ``psum``
of its numerator and denominator (aggregators.py:72-95).  ``SCALERS`` (:38-68) rescale a node array by its in-degree from
``node_degrees`` against the dataset's ``avg_deg`` statistics
(data/datasets.py), and ``phm_cat`` (:99-105) concatenates flat PHM tensors
component block by component block.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from phc_gnn_torch.graph import segment as seg
from phc_gnn_torch.parallel import mesh

__all__ = ["AGGREGATORS", "SCALERS", "softmax_aggregate", "phm_cat",
           "node_degrees"]

AGGREGATORS = {
    "sum": seg.segment_sum,
    "mean": seg.segment_mean,
    "min": seg.segment_min,
    "max": seg.segment_max,
    "var": seg.segment_var,
    "std": seg.segment_std,
}


def node_degrees(receivers: torch.Tensor, num_nodes: int,
                 edge_mask: Optional[torch.Tensor] = None,
                 axis_name: Optional[str] = None) -> torch.Tensor:
    """In-degree per node over the real edges, float [N, 1]."""
    return seg.segment_count(receivers, num_nodes, edge_mask,
                             axis_name=axis_name)[:, None]


def scale_identity(x, deg, avg_deg):
    return x


def scale_amplification(x, deg, avg_deg):
    return x * (torch.log(deg + 1.0) / avg_deg["log"])


def scale_attenuation(x, deg, avg_deg):
    # log(1) = 0 at deg = 0: the inf there is selected away, and no gradient
    # flows into deg, which counts the mask
    scale = avg_deg["log"] / torch.log(deg + 1.0)
    return x * torch.where(deg == 0, 1.0, scale)


def scale_linear(x, deg, avg_deg):
    return x * (deg / avg_deg["lin"])


def scale_inverse_linear(x, deg, avg_deg):
    scale = avg_deg["lin"] / deg
    return x * torch.where(deg == 0, 1.0, scale)


SCALERS = {
    "identity": scale_identity,
    "amplification": scale_amplification,
    "attenuation": scale_attenuation,
    "linear": scale_linear,
    "inverse_linear": scale_inverse_linear,
}


def softmax_aggregate(messages: torch.Tensor, receivers: torch.Tensor,
                      num_nodes: int, beta,
                      edge_mask: Optional[torch.Tensor] = None,
                      axis_name: Optional[str] = None) -> torch.Tensor:
    """Softmax-weighted sum per node and lane.  A float32 ``beta`` promotes
    bf16 messages to float32, as JAX's ``beta * messages`` does (torch's
    0-d tensor would not); the sums run in that dtype."""
    if torch.is_tensor(beta):
        messages = messages.to(torch.promote_types(messages.dtype, beta.dtype))
    logits = beta * messages
    if edge_mask is not None:
        logits = torch.where(edge_mask[:, None], logits, -1e30)
    idx = receivers.long()[:, None].expand_as(logits)
    seg_max = torch.full((num_nodes, messages.shape[1]), float("-inf"),
                         dtype=logits.dtype, device=logits.device)
    seg_max = seg_max.scatter_reduce(0, idx, logits.detach(), "amax")
    if axis_name is not None:
        seg_max = mesh.pmax(seg_max, mesh.axis(axis_name))
    seg_max = torch.where(seg_max <= -1e29, 0.0, seg_max)
    expd = torch.exp(logits - seg_max[receivers.long()])
    if edge_mask is not None:
        expd = torch.where(edge_mask[:, None], expd, 0.0)
    numer = seg.segment_sum(expd * messages, receivers, num_nodes,
                            axis_name=axis_name)
    denom = seg.segment_sum(expd, receivers, num_nodes, axis_name=axis_name)
    return numer / denom.clamp_min(1e-16)


def phm_cat(tensors: Sequence[torch.Tensor], phm_dim: int) -> torch.Tensor:
    """[N, n*d1], [N, n*d2], ... -> [N, n*(d1 + d2 + ...)], each component
    block the concatenation of the inputs' blocks."""
    parts = [t.reshape(t.shape[0], phm_dim, t.shape[1] // phm_dim)
             for t in tensors]
    return torch.cat(parts, dim=-1).reshape(tensors[0].shape[0], -1)
