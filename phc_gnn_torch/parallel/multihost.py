"""Process-group set-up and cross-rank utilities.

Counterpart of phc_gnn_tpu/parallel/multihost.py.  JAX's
``jax.distributed.initialize`` discovers a TPU pod's processes; the port
runs one process a rank and sets up ``torch.distributed``'s default
process group from what it is told: the arguments, or the environment
that ``torch.distributed.run`` (``torchrun``) sets (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``).  The backend is always
named by the caller: ``"nccl"`` where each rank owns a GPU, ``"gloo"`` for
CPU tensors or for ranks that share one card.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch.distributed as dist

from phc_gnn_torch.parallel.mesh import BACKENDS

log = logging.getLogger("phc_gnn_torch")

__all__ = ["initialize", "is_primary", "sync_hosts", "world_from_env"]


def world_from_env() -> Optional[tuple]:
    """``(rank, world_size)`` from ``torch.distributed.run``'s environment,
    or None where it is not set."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    return int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])


def initialize(backend: str, init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None) -> int:
    """Set up the default process group on ``backend`` and return the world
    size.  ``init_method`` (``tcp://localhost:<port>``), ``world_size`` and
    ``rank`` as ``dist.init_process_group`` takes them; without them they
    come from ``torch.distributed.run``'s environment (``env://``).  A
    world of one rank needs no group: a no-op, as JAX's is single-host.
    A group that exists already is kept if it matches and refused if not."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if world_size is None or rank is None:
        env = world_from_env()
        if env is None:
            if world_size not in (None, 1):
                raise ValueError("a multi-rank group needs its rank and "
                                 "world size, or torch.distributed.run's "
                                 "environment")
            return 1
        rank, world_size = env
        init_method = init_method or "env://"
    if world_size == 1:
        return 1
    if dist.is_initialized():
        if (dist.get_world_size() != world_size or dist.get_rank() != rank
                or dist.get_backend() != backend):
            raise RuntimeError(
                f"a process group exists already (rank {dist.get_rank()} of "
                f"{dist.get_world_size()}, {dist.get_backend()}), not rank "
                f"{rank} of {world_size} on {backend}")
        return world_size
    if init_method is None:
        raise ValueError("a multi-rank group needs an init_method "
                         "(tcp://localhost:<port>)")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    log.info("torch.distributed: rank %d of %d on %s", rank, world_size,
             backend)
    return world_size


def is_primary() -> bool:
    """True on rank 0, and where no process group exists."""
    return not dist.is_initialized() or dist.get_rank() == 0


def sync_hosts(name: str = "sync") -> None:
    """A barrier across every rank (a no-op without a process group);
    ``name`` labels it in the log."""
    if dist.is_initialized():
        log.debug("barrier %s", name)
        dist.barrier()
