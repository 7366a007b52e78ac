"""Quaternion helpers on plain tensors (the component axis is a tensor axis).

Counterpart of phc_gnn_tpu/hypercomplex/quaternion.py: a quaternion tensor
is a tensor shaped ``[..., 4, d]`` (stacked) or ``[..., 4*d]`` (flat
component blocks).  The Hamilton product and the real and complex matrix
representations bridge PHM layers at n = 4 and the quaternion algebra
(reference: phc/quaternion/algebra.py:482-683).
"""

from __future__ import annotations

import torch

__all__ = ["hamilton_product", "real_matrix_representation",
           "complex_matrix_representation", "quaternion_matmul",
           "conjugate", "qnorm", "inverse", "normalize", "quaternion_dot"]


def hamilton_product(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Elementwise Hamilton product of tensors shaped [..., 4, d]
    (reference: phc/quaternion/algebra.py:482-494)."""
    r1, i1, j1, k1 = q1.unbind(-2)
    r2, i2, j2, k2 = q2.unbind(-2)
    r = r1 * r2 - i1 * i2 - j1 * j2 - k1 * k2
    i = i1 * r2 + r1 * i2 - k1 * j2 + j1 * k2
    j = j1 * r2 + k1 * i2 + r1 * j2 - i1 * k2
    k = k1 * r2 - j1 * i2 + i1 * j2 + r1 * k2
    return torch.stack([r, i, j, k], dim=-2)


def real_matrix_representation(w: torch.Tensor) -> torch.Tensor:
    """Real 4m x 4n block representation of the quaternion matrix
    W = W_r + W_i i + W_j j + W_k k, with w shaped (4, m, n)::

        [ W_r  -W_i  -W_j  -W_k ]
        [ W_i   W_r  -W_k   W_j ]
        [ W_j   W_k   W_r  -W_i ]
        [ W_k  -W_j   W_i   W_r ]

    (reference: phc/quaternion/algebra.py:600-624)."""
    r, i, j, k = w[0], w[1], w[2], w[3]
    return torch.cat([torch.cat([r, -i, -j, -k], dim=-1),
                      torch.cat([i, r, -k, j], dim=-1),
                      torch.cat([j, k, r, -i], dim=-1),
                      torch.cat([k, -j, i, r], dim=-1)], dim=-2)


def complex_matrix_representation(w: torch.Tensor) -> torch.Tensor:
    """Complex 2m x 2n representation [[z, w], [-conj(w), conj(z)]] with
    z = W_r + i W_i, w_c = W_j + i W_k, for w shaped (4, m, n) (reference:
    phc/quaternion/algebra.py:627-659)."""
    z = torch.complex(w[0], w[1])
    wc = torch.complex(w[2], w[3])
    return torch.cat([torch.cat([z, wc], dim=-1),
                      torch.cat([-wc.conj(), z.conj()], dim=-1)], dim=-2)


def quaternion_matmul(w: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Quaternion matrix product W @ q via the real representation.

    w: (4, m, n) quaternion matrix; q: (..., 4, n) batch of quaternion
    vectors; returns (..., 4, m) (reference: phc/quaternion/algebra.py:573-589
    and hamilton_product_Wq :662-672)."""
    m = w.shape[1]
    stacked = torch.cat(q.unbind(-2), dim=-1)  # (..., 4n)
    out = stacked @ real_matrix_representation(w).T  # (..., 4m)
    return torch.stack([out[..., c * m:(c + 1) * m] for c in range(4)],
                       dim=-2)


def conjugate(q: torch.Tensor) -> torch.Tensor:
    """Quaternion conjugate on [..., 4, d]: the imaginary components
    negated (reference: phc/quaternion/algebra.py conj)."""
    signs = torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype,
                         device=q.device)
    return q * signs[:, None]


def qnorm(q: torch.Tensor) -> torch.Tensor:
    """Elementwise quaternion modulus |q| over the component axis, as
    ``jnp.linalg.norm`` computes it (reference: algebra.py mod/norm)."""
    return torch.sqrt((q * q).sum(dim=-2))


def inverse(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """q^{-1} = conj(q) / |q|^2 (reference: algebra.py:509-521)."""
    n2 = (q * q).sum(dim=-2, keepdim=True)
    return conjugate(q) / n2.clamp_min(eps)


def normalize(q: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """q / (|q| + eps) (reference: algebra.py:531-534)."""
    return q / (qnorm(q)[..., None, :] + eps)


def quaternion_dot(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Componentwise dot product over the quaternion axis."""
    return (q1 * q2).sum(dim=-2)
