"""Kronecker products, the PHM weight matrix and the PHM matrix product.

``y = x @ H + b`` with ``H = sum_i A[i] (x) W[i]``: ``H`` is built once per
call as a small ``(in, out)`` matrix (``n * in * out`` multiply-adds, small
beside the ``B * in * out`` product), then one ``torch.matmul``, as the JAX
package leaves it to XLA (phc_gnn_tpu/hypercomplex/kron.py).
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["kron", "batched_kron", "phm_weight_matrix", "phm_matmul"]


def kron(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Kronecker product of two 2-D matrices (kron.py:19-25; reference:
    phc/hypercomplex/kronecker.py:4-32)."""
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError(f"kron takes two matrices, got {a.ndim}-D and "
                         f"{b.ndim}-D")
    return torch.einsum("ab,cd->acbd", a, b).reshape(
        a.shape[0] * b.shape[0], a.shape[1] * b.shape[1])


def batched_kron(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched Kronecker product: a (g, m, n), b (g, p, q) -> (g, m*p, n*q)
    (kron.py:28-35; reference: phc/hypercomplex/kronecker.py:35-48)."""
    if a.ndim != 3 or b.ndim != 3:
        raise ValueError(f"batched_kron takes two stacks of matrices, got "
                         f"{a.ndim}-D and {b.ndim}-D")
    g, m, n = a.shape
    _, p, q = b.shape
    return torch.einsum("gmn,gpq->gmpnq", a, b).reshape(g, m * p, n * q)


def phm_weight_matrix(rule: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``H = sum_i rule[i] (x) w[i]``.

    rule: (n, n, n); w: (n, in/n, out/n) -> H: (in, out), laid out so that H
    acts on flat component-block vectors ``[N, n * in/n]``."""
    n = rule.shape[0]
    _, fi, fo = w.shape
    return torch.einsum("ijm,ifo->jfmo", rule, w).reshape(n * fi, n * fo)


def phm_matmul(x: torch.Tensor, rule: torch.Tensor, w: torch.Tensor,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """PHM linear transform ``y = x @ (sum_i rule[i] (x) w[i]) + b`` on
    x: (N, n * in/n); returns (N, n * out/n), all in the factors' one dtype.
    In float32 the bias rides in the GEMM (``addmm``), one launch fewer per
    layer.  In bf16 (the model's ``compute_dtype``) the product is rounded
    to bf16 before the bias is added, as JAX's ``matmul`` then ``+ b``
    rounds it (kron.py:62-66); ``addmm`` would round once."""
    h = phm_weight_matrix(rule, w)
    if bias is None:
        return x @ h
    if x.dtype == torch.bfloat16:
        return x @ h + bias
    return torch.addmm(bias, x, h)
