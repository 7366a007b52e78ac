"""PHM dropout with optional shared-mask-across-components semantics.

Counterpart of phc_gnn_tpu/nn/dropout.py: ``same=True`` draws one Bernoulli
mask per (row, per-component feature) and applies it to every hypercomplex
component (reference phc/hypercomplex/layers.py:31-55); ``same=False`` is
plain inverted dropout.  The caller supplies the ``torch.Generator``, on the
device of ``x``.  Its numbers are not JAX's: tests compare distributions, or
run with the rate at 0.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["phm_dropout"]


def phm_dropout(x: torch.Tensor, p: float, phm_dim: int,
                generator: Optional[torch.Generator], training: bool = True,
                same: bool = False,
                block: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Inverted dropout on a flat component-block tensor ``[N, n*d]``: each
    kept entry is divided by ``keep = 1 - p`` in ``x``'s dtype; in bf16
    ``keep`` is first rounded to bf16, as JAX's ``x / keep`` rounds its
    weakly typed scalar.  With ``block = (index, count)`` the generator
    draws ``count`` masks and ``x`` takes mask ``index``: the ``count``
    node shards of one batch draw alike from one generator, and each keeps
    its own rows' mask (JAX folds the shard index into the key)."""
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"dropout rate must be in [0, 1], got {p}")
    if not training or p == 0.0:
        return x
    if generator is None:
        raise ValueError("training-mode dropout needs a torch.Generator")
    keep = 1.0 - p
    scale = (float(torch.tensor(keep, dtype=x.dtype))
             if x.dtype != torch.float32 else keep)
    if same:
        d = x.shape[-1] // phm_dim
        shape = x.shape[:-1] + (1, d)
        xs = x.reshape(x.shape[:-1] + (phm_dim, d))
    else:
        shape, xs = x.shape, x
    if block is None:
        u = torch.rand(shape, generator=generator, device=x.device)
    else:
        index, count = block
        u = torch.rand((count,) + tuple(shape), generator=generator,
                       device=x.device)[index]
    mask = u < keep
    return torch.where(mask, xs / scale, 0.0).reshape(x.shape)
