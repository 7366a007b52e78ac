"""The PHM weight matrix and the PHM matrix product.

``y = x @ H + b`` with ``H = sum_i A[i] (x) W[i]``: ``H`` is built once per
call as a small ``(in, out)`` matrix (``n * in * out`` multiply-adds, small
beside the ``B * in * out`` product), then one ``torch.matmul``, as the JAX
package leaves it to XLA (phc_gnn_tpu/hypercomplex/kron.py).
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["phm_weight_matrix", "phm_matmul"]


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
    x: (N, n * in/n); returns (N, n * out/n).  The bias rides in the GEMM
    (``addmm``), one launch fewer per layer."""
    h = phm_weight_matrix(rule, w)
    if bias is None:
        return x @ h
    return torch.addmm(bias, x, h)
