"""Parallel layer of the port (phc_gnn_tpu/parallel/): the ``(dp, ep)`` mesh
of ranks on ``torch.distributed`` and its collectives, the process-group
set-up, load-weighted data parallelism (with the load weight and the
dummy batch that the accumulated step uses too) and the node-sharded halo
path.  The replicated edge-partition scheme and the communication model
are not ported yet (ROADMAP.md, section 1)."""

from phc_gnn_torch.parallel.dp import (
    loss_weight,
    make_dp_eval_step,
    make_dp_train_step,
    make_dummy_batch,
    make_scan_dp_train_steps,
    weighted_mean,
)
from phc_gnn_torch.parallel.halo import (
    SlotOverflow,
    halo_exchange,
    make_dp_np_eval_step,
    make_dp_np_train_step,
    make_np_eval_step,
    make_np_train_step,
    make_scan_dp_np_train_steps,
    make_scan_np_train_steps,
    partition_nodes,
)
from phc_gnn_torch.parallel.mesh import Mesh, make_mesh
from phc_gnn_torch.parallel.multihost import initialize, is_primary, sync_hosts

__all__ = ["Mesh", "SlotOverflow", "halo_exchange", "initialize",
           "is_primary", "loss_weight", "make_dp_eval_step",
           "make_dp_np_eval_step", "make_dp_np_train_step",
           "make_dp_train_step", "make_dummy_batch", "make_mesh",
           "make_np_eval_step", "make_np_train_step",
           "make_scan_dp_np_train_steps", "make_scan_dp_train_steps",
           "make_scan_np_train_steps", "partition_nodes", "sync_hosts",
           "weighted_mean"]
