"""Load-weighted combination of batches, and the fully masked batch that
pads a group.

Counterparts of ``make_dummy_batch`` and ``loss_weight`` in
phc_gnn_tpu/parallel/dp.py:47-68; the data-parallel step itself waits for
ROADMAP.md, section 1, item 14.
"""

from __future__ import annotations

import torch

from phc_gnn_torch.graph.batch import GraphsTuple

__all__ = ["loss_weight", "make_dummy_batch"]


def make_dummy_batch(batch: GraphsTuple) -> GraphsTuple:
    """A fully masked clone of ``batch`` (same shapes, dtypes and device):
    every mask False, float labels NaN, so its loss weight is 0 and it adds
    nothing to a weighted combination.  It pads the last partial group of
    an epoch (the accumulated step's K sub-batches).  Where ``batch``
    carries CSR plans, the clone carries the plans of its own masks, what
    ``graph.attach_csr_plan`` builds for them (no real edge in any
    segment, the sender order the identity), made on the batch's device
    without a host sync."""
    y = batch.y
    if y is not None and y.is_floating_point():
        y = torch.full_like(y, float("nan"))
    out = batch.replace(node_mask=torch.zeros_like(batch.node_mask),
                        edge_mask=torch.zeros_like(batch.edge_mask),
                        graph_mask=torch.zeros_like(batch.graph_mask), y=y)
    if batch.rowptr is not None:
        out = out.replace(
            rowptr=torch.zeros_like(batch.rowptr),
            snd_perm=torch.arange(batch.num_edges, dtype=torch.int32,
                                  device=batch.senders.device),
            snd_rowptr=torch.zeros_like(batch.snd_rowptr))
    return out


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
