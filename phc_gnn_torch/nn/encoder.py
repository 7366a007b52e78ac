"""Categorical feature encoders.

Counterparts of ``IntegerEncoder`` and ``PHMEncoder`` in
phc_gnn_tpu/nn/encoder.py with sum-combine: ``PHMEncoder`` runs n independent
integer encoders, one per hypercomplex component, and stacks them to
``[N, n, d]``.  The JAX package evaluates the sum of embeddings as one
one-hot matmul (a TPU choice for its backward); here it is a sum of
embedding lookups, the same function.  Continuous inputs, concat-combine and
the naive encoder wait for the other datasets (ROADMAP.md, section 1,
item 12).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from phc_gnn_torch.hypercomplex.inits import glorot_uniform

__all__ = ["IntegerEncoder", "PHMEncoder"]


class IntegerEncoder(nn.Module):
    """Sum of per-categorical-column embeddings ``embedding_<i>``
    (vocab, out_dim), xavier-uniform with gain sqrt(2)."""

    def __init__(self, out_dim: int, input_dims: Sequence[int],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator if generator is not None else torch.Generator()
        self.input_dims = tuple(int(v) for v in input_dims)
        for i, vocab in enumerate(self.input_dims):
            self.register_parameter(
                f"embedding_{i}",
                nn.Parameter(glorot_uniform(gen, (vocab, out_dim))))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim == 1:
            x = x[:, None]
        # clip per feature (phc_gnn_tpu/nn/encoder.py:59-61): an out-of-range
        # index maps to its own table's last row
        outs = [F.embedding(x[:, i].clamp(0, vocab - 1),
                            getattr(self, f"embedding_{i}"))
                for i, vocab in enumerate(self.input_dims)]
        return sum(outs[1:], outs[0])  # no "0 + t": one launch fewer


class _SingleEncoder(nn.Module):
    """One component's encoder, named ``integer`` as in the flax tree."""

    def __init__(self, out_dim: int, input_dims: Sequence[int],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if isinstance(input_dims, int):
            raise NotImplementedError(
                "continuous-input encoders are not ported yet (ROADMAP.md, "
                "section 1, item 12)")
        self.integer = IntegerEncoder(out_dim, input_dims, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.integer(x)


class PHMEncoder(nn.Module):
    """n independent encoders ``encoder_<c>`` -> stacked [N, n, out_dim]."""

    def __init__(self, out_dim: int, input_dims: Sequence[int], phm_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.phm_dim = phm_dim
        for c in range(phm_dim):
            self.add_module(f"encoder_{c}",
                            _SingleEncoder(out_dim, input_dims, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.stack([getattr(self, f"encoder_{c}")(x)
                            for c in range(self.phm_dim)], dim=1)
