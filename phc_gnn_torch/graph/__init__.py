"""Graph layer of the port: padded batches, segment ops, convs, pooling."""

from phc_gnn_torch.graph.batch import (
    GraphsTuple,
    attach_csr_plan,
    batch_graphs,
    build_csr_rowptr,
    build_sender_csr,
    stack_batches,
    unstack_batches,
)

__all__ = ["GraphsTuple", "attach_csr_plan", "batch_graphs", "build_csr_rowptr",
           "build_sender_csr", "stack_batches", "unstack_batches"]
