"""Parallel layer of the port: so far the load weight of a batch, which the
gradient accumulation of ``train.make_accum_train_step`` uses."""

from phc_gnn_torch.parallel.dp import loss_weight

__all__ = ["loss_weight"]
