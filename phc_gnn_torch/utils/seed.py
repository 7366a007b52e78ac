"""Seeding helper (counterpart of phc_gnn_tpu/utils/seed.py; reference:
benchmarks/utils.py:22-26)."""

from __future__ import annotations

import random

import numpy as np
import torch

__all__ = ["set_seed_all"]


def set_seed_all(seed: int) -> torch.Generator:
    """Seed ``random`` and ``numpy`` (host-side shuffles) and return a
    ``torch.Generator`` seeded with ``seed``: the port's counterpart of
    JAX's ``jax.random.key(seed)``."""
    random.seed(seed)
    np.random.seed(seed)
    return torch.Generator().manual_seed(seed)
