"""Hypercomplex multiplication-rule ("contribution matrix") construction.

A PHM layer of hypercomplex dimension ``n`` is parameterized by a rule tensor
``A`` of shape ``(n, n, n)`` (n matrices of shape n x n) and per-component weights
``W`` of shape ``(n, in/n, out/n)``; the dense weight is ``H = sum_i A[i] (x) W[i]``
(Kronecker products).  The *standard* rule reproduces the complex (n=2) and
quaternion (n=4) algebras and a signed-cyclic generalization for other n.

A copy of phc_gnn_tpu/hypercomplex/rules.py (plain numpy, so the port keeps
its own): host-side, init-time constants, converted to tensors by callers.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "quaternion_rule",
    "complex_rule",
    "standard_rule",
    "random_rule",
    "get_multiplication_rule",
]


def quaternion_rule(dtype=np.float32) -> np.ndarray:
    """The quaternion multiplication rule as a (4, 4, 4) tensor.

    Stacking [A1..A4] s.t. sum_i A_i (x) W_i equals the real 4x4-block matrix
    representation of the quaternion matrix W_1 + W_2 i + W_3 j + W_4 k
    (reference: phc/hypercomplex/utils.py:5-22).
    """
    a1 = np.eye(4)
    a2 = np.array([[0, -1, 0, 0], [1, 0, 0, 0], [0, 0, 0, -1], [0, 0, 1, 0]])
    a3 = np.array([[0, 0, -1, 0], [0, 0, 0, 1], [1, 0, 0, 0], [0, -1, 0, 0]])
    a4 = np.array([[0, 0, 0, -1], [0, 0, -1, 0], [0, 1, 0, 0], [1, 0, 0, 0]])
    return np.stack([a1, a2, a3, a4]).astype(dtype)


def complex_rule(dtype=np.float32) -> np.ndarray:
    """The complex multiplication rule as a (2, 2, 2) tensor
    (reference: phc/hypercomplex/utils.py:30-32)."""
    a1 = np.eye(2)
    a2 = np.array([[0, -1], [1, 0]])
    return np.stack([a1, a2]).astype(dtype)


def standard_rule(n: int, dtype=np.float32) -> np.ndarray:
    """Standard multiplication rule for any hypercomplex dimension ``n``.

    ``A[0] = I``; ``A[i] = D @ P^i`` where ``D = diag(+1, -1, +1, ...)`` and ``P``
    right-shifts columns cyclically.  Complex / quaternion rules are returned for
    n=2 / n=4 (reference: phc/hypercomplex/utils.py:61-78).
    """
    assert n >= 1
    if n == 2:
        return complex_rule(dtype)
    if n == 4:
        return quaternion_rule(dtype)
    perm = np.roll(np.eye(n), shift=1, axis=1)
    mats = [np.eye(n)]
    diag = np.diag([1.0 if k % 2 == 0 else -1.0 for k in range(n)])
    for i in range(1, n):
        a = diag.copy()
        for _ in range(i):
            a = a @ perm
        mats.append(a)
    return np.stack(mats).astype(dtype)


def random_rule(n: int, rng: np.random.Generator | int | None = None, dtype=np.float32) -> np.ndarray:
    """Random rule ~ U(-1, 1) of shape (n, n, n)
    (reference: phc/hypercomplex/utils.py:79-81)."""
    if not isinstance(rng, np.random.Generator):
        rng = np.random.default_rng(rng)
    return rng.uniform(-1.0, 1.0, size=(n, n, n)).astype(dtype)


def get_multiplication_rule(
    n: int, kind: str = "standard", rng: np.random.Generator | int | None = None, dtype=np.float32
) -> np.ndarray:
    """Build the (n, n, n) contribution tensor; ``kind`` in {"standard", "random"}
    (reference: phc/hypercomplex/utils.py:61-85)."""
    if kind == "standard":
        return standard_rule(n, dtype)
    if kind == "random":
        return random_rule(n, rng, dtype)
    raise ValueError(f"unknown multiplication rule kind: {kind!r}")
