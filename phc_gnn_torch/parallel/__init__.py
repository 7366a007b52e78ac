"""Parallel layer of the port (phc_gnn_tpu/parallel/): the ``(dp, ep)`` mesh
of ranks on ``torch.distributed`` and its collectives, the process-group
set-up, load-weighted data parallelism (with the load weight and the
dummy batch that the accumulated step uses too), the node-sharded halo
path, the replicated edge-partition scheme and the halo scheme's
communication model (``parallel.comm_model``, imported by name)."""

from phc_gnn_torch.parallel.dp import (
    loss_weight,
    make_dp_eval_step,
    make_dp_train_step,
    make_dummy_batch,
    make_scan_dp_train_steps,
    weighted_mean,
)
from phc_gnn_torch.parallel.edge_partition import (
    edge_shard,
    make_dp_ep_eval_step,
    make_dp_ep_train_step,
    make_ep_eval_step,
    make_ep_train_step,
    partition_edges,
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

__all__ = ["Mesh", "SlotOverflow", "edge_shard", "halo_exchange",
           "initialize", "is_primary", "loss_weight", "make_dp_ep_eval_step",
           "make_dp_ep_train_step", "make_dp_eval_step",
           "make_dp_np_eval_step", "make_dp_np_train_step",
           "make_dp_train_step", "make_dummy_batch", "make_ep_eval_step",
           "make_ep_train_step", "make_mesh", "make_np_eval_step",
           "make_np_train_step", "make_scan_dp_np_train_steps",
           "make_scan_dp_train_steps", "make_scan_np_train_steps",
           "partition_edges", "partition_nodes", "sync_hosts",
           "weighted_mean"]
