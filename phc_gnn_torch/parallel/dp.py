"""Load-weighted combination of batches.

Counterpart of ``loss_weight`` in phc_gnn_tpu/parallel/dp.py:60-68; the
data-parallel step itself waits for ROADMAP.md, section 1, item 14.
"""

from __future__ import annotations

import torch

from phc_gnn_torch.graph.batch import GraphsTuple

__all__ = ["loss_weight"]


def loss_weight(batch: GraphsTuple, loss: str) -> torch.Tensor:
    """The number of valid loss terms in ``batch``, as a float32 device
    scalar: the weight that makes the weighted mean over batches equal the
    union batch's mean loss and gradient.  Cross-entropy (integer labels)
    counts the real graphs; the float losses count the finite label entries
    of the real graphs (multi-task BCE counts entries, as its loss does)."""
    if loss == "ce" or batch.y is None:
        return batch.graph_mask.sum(dtype=torch.float32)
    return (torch.isfinite(batch.y)
            & batch.graph_mask[:, None]).sum(dtype=torch.float32)
