"""Feature encoders: integer embeddings (categorical) and a dense layer
(continuous).

Counterparts of phc_gnn_tpu/nn/encoder.py.  ``PHMEncoder`` runs n
independent encoders, one per hypercomplex component, and stacks them to
``[N, n, d]``; ``NaivePHMEncoder`` runs one and copies it to every
component.  Module and parameter names follow the flax tree
(``encoder_<c>.integer.embedding_<i>``, ``encoder.linear``), so
``convert.from_flax_variables`` maps them one to one.

The sum of embeddings is one one-hot product over the concatenated tables,
``onehot(x + offsets) [B, V] @ cat(tables) [V, d]``, as JAX computes it.
Its backward is the transposed product, ``onehot^T @ g``: a GEMM, with no
sort and no scatter, where per-column lookups have a scatter-add backward
(on the card: a radix sort of the indices, then the adds).  ``PHMEncoder``
builds the one-hot once and multiplies it by the n components' tables side
by side, ``[V, n*d]``.  The product is ``torch.matmul``, as the JAX package
leaves it to XLA: it has no Pallas kernel.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from phc_gnn_torch.hypercomplex.inits import glorot_uniform

__all__ = ["IntegerEncoder", "PHMEncoder", "NaivePHMEncoder"]

InputDims = Union[Sequence[int], int]


def _offsets(input_dims: Sequence[int]) -> list:
    offs, total = [], 0
    for v in input_dims:
        offs.append(total)
        total += v
    return offs


def one_hot_sum(x: torch.Tensor, hi: torch.Tensor, off: torch.Tensor,
                total: int, dtype: torch.dtype) -> torch.Tensor:
    """``sum_i onehot(x_i + off_i)`` as [B, total] in ``dtype``: each column
    ``x_i`` is clipped to ``[0, hi_i]`` (its vocabulary) before its offset
    is added, so a bad index stays in its own table (phc_gnn_tpu/nn/
    encoder.py:56-61)."""
    if x.ndim == 1:
        x = x[:, None]
    idx = torch.minimum(x.long().clamp_min(0), hi) + off
    onehot = torch.zeros((x.shape[0], total), dtype=dtype, device=x.device)
    return onehot.scatter_(1, idx, 1.0)


class IntegerEncoder(nn.Module):
    """Per-categorical-column embeddings ``embedding_<i>`` (vocab, out_dim),
    xavier-uniform with gain sqrt(2), combined by ``"sum"`` or
    ``"concat"``."""

    def __init__(self, out_dim: int, input_dims: Sequence[int],
                 combine: str = "sum",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if combine not in ("sum", "concat"):
            raise ValueError(f"combine must be 'sum' or 'concat', got "
                             f"{combine!r}")
        gen = generator if generator is not None else torch.Generator()
        self.input_dims = tuple(int(v) for v in input_dims)
        self.combine = combine
        for i, vocab in enumerate(self.input_dims):
            self.register_parameter(
                f"embedding_{i}",
                nn.Parameter(glorot_uniform(gen, (vocab, out_dim))))
        self._bounds: dict = {}

    def bounds(self, device: torch.device):
        """``(hi, off)``, [F] int64 on ``device``: each column's largest
        index and its table's offset.  Made on the device by fills, once a
        device: a copy from the host would sync with it, and a CUDA graph
        cannot hold a copy from pageable memory."""
        got = self._bounds.get(device)
        if got is None:
            got = tuple(
                torch.stack([torch.full((), v, dtype=torch.int64,
                                        device=device) for v in vals])
                for vals in ([v - 1 for v in self.input_dims],
                             _offsets(self.input_dims)))
            self._bounds[device] = got
        return got

    def one_hot(self, x: torch.Tensor) -> torch.Tensor:
        """``one_hot_sum`` of ``x`` over this encoder's vocabularies, in
        the tables' dtype."""
        return one_hot_sum(x, *self.bounds(x.device), sum(self.input_dims),
                           self.embedding_0.dtype)

    def table(self) -> torch.Tensor:
        """The concatenated tables, [V, out_dim]."""
        return torch.cat([getattr(self, f"embedding_{i}")
                          for i in range(len(self.input_dims))])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.combine == "sum":
            return self.one_hot(x) @ self.table()
        if x.ndim == 1:
            x = x[:, None]
        return torch.cat([_take(getattr(self, f"embedding_{i}"), x[:, i])
                          for i in range(len(self.input_dims))], dim=-1)


def _take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, idx, axis=0)``: a negative index counts from the
    end; an index outside ``[-vocab, vocab)`` gives a row of NaN."""
    vocab = table.shape[0]
    idx = torch.where(idx < 0, idx + vocab, idx)
    valid = (idx >= 0) & (idx < vocab)
    rows = F.embedding(idx.clamp(0, vocab - 1).long(), table)
    return torch.where(valid[:, None], rows, float("nan"))


class _SingleEncoder(nn.Module):
    """One component's encoder: ``integer`` for categorical input dims, a
    dense layer ``linear`` for a continuous input dim, initialised centred
    uniform in ``1/sqrt(fan_in)`` as torch's ``nn.Linear``."""

    def __init__(self, out_dim: int, input_dims: InputDims,
                 combine: str = "sum",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator if generator is not None else torch.Generator()
        if isinstance(input_dims, int):
            bound = 1.0 / math.sqrt(input_dims)
            self.linear = nn.utils.skip_init(nn.Linear, input_dims, out_dim)
            with torch.no_grad():
                kernel = torch.rand((input_dims, out_dim), generator=gen)
                self.linear.weight.copy_((kernel * 2 - 1).T * bound)
                self.linear.bias.copy_(
                    (torch.rand((out_dim,), generator=gen) * 2 - 1) * bound)
        else:
            self.integer = IntegerEncoder(out_dim, input_dims, combine, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if hasattr(self, "linear"):
            return self.linear(x)
        return self.integer(x)


class PHMEncoder(nn.Module):
    """n independent encoders ``encoder_<c>`` -> stacked [N, n, out_dim]."""

    def __init__(self, out_dim: int, input_dims: InputDims, phm_dim: int,
                 combine: str = "sum",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.phm_dim = phm_dim
        self.out_dim = out_dim
        self.fused = not isinstance(input_dims, int) and combine == "sum"
        for c in range(phm_dim):
            self.add_module(f"encoder_{c}", _SingleEncoder(
                out_dim, input_dims, combine, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        encoders = [getattr(self, f"encoder_{c}") for c in range(self.phm_dim)]
        if not self.fused:
            return torch.stack([e(x) for e in encoders], dim=1)
        # every component reads the same x: one one-hot, one GEMM against
        # the components' tables side by side
        tables = torch.cat([e.integer.table() for e in encoders], dim=1)
        out = encoders[0].integer.one_hot(x) @ tables
        return out.reshape(out.shape[0], self.phm_dim, self.out_dim)


class NaivePHMEncoder(nn.Module):
    """One encoder ``encoder`` copied to all n components -> [N, n,
    out_dim]."""

    def __init__(self, out_dim: int, input_dims: InputDims, phm_dim: int,
                 combine: str = "sum",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.phm_dim = phm_dim
        self.encoder = _SingleEncoder(out_dim, input_dims, combine, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.encoder(x)
        return out[:, None, :].expand(out.shape[0], self.phm_dim,
                                      out.shape[-1])
