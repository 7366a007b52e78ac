"""The (dp, ep) grid of ranks, its process groups and its collectives.

Counterpart of phc_gnn_tpu/parallel/mesh.py:20-36.  JAX lays its devices
out as a ``(dp, ep)`` mesh and runs one program over it under
``shard_map``; the port runs one process a rank on ``torch.distributed``:
rank ``r = d * ep + e`` holds data shard ``d`` and node shard ``e``.  Its
groups are one ``ep`` group a dp row (the ranks of one batch's node
shards) and one ``dp`` group an ep column, each made with
``dist.new_group`` on every rank in the same order, as the call requires.

A module names an axis (``PHCGNN(node_axis="ep")``, a norm's
``stat_axis``) as JAX's modules name a mesh axis; the collectives find
the group of that name in the mesh that a step binds around its forward
and backward (``bind``), as ``shard_map`` binds JAX's axis names.  The
collectives here run on the process group's backend as they are: NCCL for
one GPU a rank, gloo for CPU tensors and for ranks that share one card
(gloo takes CUDA tensors for ``all_reduce``, ``all_to_all_single`` and
``all_gather``).  Nothing picks a backend or a device for the caller.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional

import torch
import torch.distributed as dist

__all__ = ["Axis", "Mesh", "make_mesh", "bind", "axis", "all_reduce",
           "psum", "pmax", "pmin", "all_to_all", "all_gather", "BACKENDS"]

BACKENDS = ("nccl", "gloo")


@dataclasses.dataclass(frozen=True)
class Axis:
    """One axis of the mesh as this rank sees it: its ``size``, this
    rank's ``index`` along it and the process group of the ranks that
    share the other coordinate (None at size 1)."""
    name: str
    size: int
    index: int
    group: Optional[object] = None


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``(dp, ep)`` grid of ranks over the default process group;
    ``world`` is the group of every rank (None at one rank)."""
    dp: Axis
    ep: Axis
    backend: Optional[str]
    world: Optional[object] = None

    @property
    def shape(self):
        return (self.dp.size, self.ep.size)

    @property
    def rank(self) -> int:
        return self.dp.index * self.ep.size + self.ep.index

    @property
    def size(self) -> int:
        return self.dp.size * self.ep.size


def make_mesh(dp: int = 1, ep: int = 1, backend: Optional[str] = None
              ) -> Mesh:
    """The ``(dp, ep)`` mesh of this rank.  With ``dp * ep`` > 1 the default
    process group must exist with that world size (``multihost.initialize``)
    on ``backend``; every rank calls this once, in the same order as its
    other ``new_group`` calls.  At ``dp = ep = 1`` no group is needed."""
    if dp < 1 or ep < 1:
        raise ValueError(f"mesh axes must be >= 1, got dp={dp}, ep={ep}")
    if dp * ep == 1:
        return Mesh(Axis("dp", 1, 0), Axis("ep", 1, 0), backend)
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {dp}x{ep} mesh needs the default process group: call "
            f"parallel.multihost.initialize first")
    if dist.get_world_size() != dp * ep:
        raise ValueError(f"a {dp}x{ep} mesh needs {dp * ep} ranks, the "
                         f"process group has {dist.get_world_size()}")
    actual = dist.get_backend()
    if backend is not None and actual != backend:
        raise ValueError(f"the process group runs {actual!r}, the mesh was "
                         f"asked for {backend!r}")
    rank = dist.get_rank()
    d, e = divmod(rank, ep)
    # every rank makes every group, rows first, then columns
    rows = [dist.new_group([r * ep + c for c in range(ep)])
            for r in range(dp)]
    cols = [dist.new_group([r * ep + c for r in range(dp)])
            for c in range(ep)]
    return Mesh(Axis("dp", dp, d, cols[e] if dp > 1 else None),
                Axis("ep", ep, e, rows[d] if ep > 1 else None),
                actual, dist.group.WORLD)


_BOUND: Dict[str, Axis] = {}


@contextlib.contextmanager
def bind(mesh: Mesh):
    """Inside the block, ``axis("dp")`` and ``axis("ep")`` are ``mesh``'s.
    Process-wide, not thread-local: a rematerialized layer's forward runs
    again in autograd's thread, inside the step's block."""
    before = dict(_BOUND)
    _BOUND.update(dp=mesh.dp, ep=mesh.ep)
    try:
        yield mesh
    finally:
        _BOUND.clear()
        _BOUND.update(before)


def axis(name: str) -> Axis:
    """The axis ``name`` of the mesh bound by ``bind``; raises outside."""
    if name not in _BOUND:
        raise RuntimeError(
            f"axis {name!r} is not bound: a module with a mesh axis runs "
            f"inside a step of parallel/dp.py or parallel/halo.py (or "
            f"parallel.mesh.bind)")
    return _BOUND[name]


def all_reduce(t: torch.Tensor, ax: Axis,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The sum (or ``op``) of ``t`` over ``ax``, in place; ``t`` at size
    1."""
    if ax.size > 1:
        dist.all_reduce(t, op=op, group=ax.group)
    return t


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return all_reduce(x.clone(), ax)

    @staticmethod
    def backward(ctx, g):
        # the transpose of a sum over the axis is the same sum
        return all_reduce(g.clone(), ctx.ax), None


def psum(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """``jax.lax.psum``: the sum of ``x`` over ``ax``, differentiable; its
    backward sums the cotangents over the axis, as JAX's psum transposes
    to a psum."""
    if ax.size == 1:
        return x
    return _Psum.apply(x, ax)


class _Pextreme(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, op, name):
        ctx.name = name
        return all_reduce(x.clone(), ax, op)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            f"Differentiation rule for {ctx.name!r} not implemented: "
            f"jax.lax.{ctx.name} has no derivative, and the port follows it "
            f"(a max or min over an edge-partitioned axis cannot be "
            f"trained through; the softmax's max is taken detached)")


def pmax(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """``jax.lax.pmax``: the elementwise max of ``x`` over ``ax``.  It has
    no derivative, as JAX's has none: where ``x`` needs a gradient the
    backward raises, whatever the axis's size, as JAX's differentiation
    raises on a mesh of one device too."""
    return _Pextreme.apply(x, ax, dist.ReduceOp.MAX, "pmax")


def pmin(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """``jax.lax.pmin``: the elementwise min of ``x`` over ``ax``; no
    derivative, as ``pmax``."""
    return _Pextreme.apply(x, ax, dist.ReduceOp.MIN, "pmin")


def all_to_all(buf: torch.Tensor, ax: Axis) -> torch.Tensor:
    """``jax.lax.all_to_all(buf, split_axis=0, concat_axis=0, tiled=True)``:
    block t of ``buf``'s ``ax.size`` equal row blocks goes to rank t of the
    axis; block t of the result came from rank t.  It moves bytes (any
    dtype), so bf16 rows travel as they are."""
    if ax.size == 1:
        return buf.clone()
    if buf.shape[0] % ax.size:
        raise ValueError(f"{buf.shape[0]} rows do not split into "
                         f"{ax.size} blocks")
    src = buf.contiguous()
    raw = src.view(torch.uint8).reshape(src.shape[0], -1)
    out = torch.empty_like(raw)
    dist.all_to_all_single(out, raw, group=ax.group)
    return out.view(buf.dtype).reshape(buf.shape)


def all_gather(t: torch.Tensor, ax: Axis) -> torch.Tensor:
    """``[ax.size, *t.shape]``: every rank's ``t`` along ``ax``, in the
    axis's order."""
    if ax.size == 1:
        return t[None]
    parts = [torch.empty_like(t) for _ in range(ax.size)]
    dist.all_gather(parts, t.contiguous(), group=ax.group)
    return torch.stack(parts)
