"""Structure-preserving quaternion Householder QR, in float64.

Counterpart of phc_gnn_tpu/hypercomplex/qr.py (numpy there), on float64
tensors: the real structure-preserving algorithm of Li et al. 2016 on the
stacked real representation of a quaternion matrix.  Only the quaternion
orthogonal initializer uses it, at init time (reference:
phc/quaternion/qr.py:10-109).
"""

from __future__ import annotations

import torch

__all__ = ["real_p", "quat_householder", "quat_qr", "grs_givens",
           "quat_qr_givens"]

_F64 = torch.float64


def _col(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=_F64).reshape(-1, 1)


def real_p(a1, a2, a3, a4) -> torch.Tensor:
    """4m x 4n real representation of A = A1 + A2 i + A3 j + A4 k
    (reference: phc/quaternion/qr.py:10-25); vectors are taken as
    columns."""
    a1, a2, a3, a4 = (torch.as_tensor(x, dtype=_F64) for x in (a1, a2, a3, a4))
    if a1.ndim == 1:
        a1, a2, a3, a4 = (x.reshape(-1, 1) for x in (a1, a2, a3, a4))
    return torch.cat([torch.cat([a1, -a2, -a3, -a4], dim=1),
                      torch.cat([a2, a1, -a4, a3], dim=1),
                      torch.cat([a3, a4, a1, -a2], dim=1),
                      torch.cat([a4, -a3, a2, a1], dim=1)], dim=0)


def quat_householder(x1, x2, x3, x4, n: int):
    """Householder reflector for a quaternion column, returned as its real
    representation and the beta scale (reference:
    phc/quaternion/qr.py:28-50)."""
    x1, x2, x3, x4 = (_col(x) for x in (x1, x2, x3, x4))
    u1 = torch.cat([x1, x2, x3, x4], dim=1)[:n].clone()
    aa = float(torch.linalg.vector_norm(torch.cat([x1, x2, x3, x4])))
    head = torch.cat([x1[0], x2[0], x3[0], x4[0]])
    xx = float(torch.linalg.vector_norm(head))
    if xx == 0.0:
        alpha1 = aa * torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=_F64)
    else:
        alpha1 = -(aa / xx) * head
    u1[0, :] = u1[0, :] - alpha1
    beta1 = 1.0 / (aa * (aa + xx))
    return real_p(u1[:, 0:1], u1[:, 1:2], u1[:, 2:3], u1[:, 3:4]), beta1


def quat_qr(a1, a2, a3, a4):
    """QR of the quaternion matrix A (components a1..a4, each m x n).

    Returns (Q, R) in stacked-component form: Q is (4m, m) with the four
    component blocks stacked row-wise, R likewise (4m, n) (reference:
    phc/quaternion/qr.py:65-109, the givens=False path)."""
    parts = [torch.as_tensor(x, dtype=_F64) for x in (a1, a2, a3, a4)]
    b = torch.cat(parts, dim=0).clone()
    m, n = parts[0].shape
    q = torch.cat([torch.eye(m, dtype=_F64)] * 4, dim=0)
    for j in range(n):
        cols = [b[c * m + j:(c + 1) * m, j] for c in range(4)]
        u, beta1 = quat_householder(*cols, n=m - j)
        # the active rows: the tail of each component block
        idx = torch.cat([torch.arange(j + c * m, (c + 1) * m)
                         for c in range(4)])
        b[idx, :] = b[idx, :] - (beta1 * u) @ (u.T @ b[idx, :])
        q[idx, :] = q[idx, :] - (beta1 * u) @ (u.T @ q[idx, :])
    return q, b


def grs_givens(g1: float, g2: float, g3: float, g4: float) -> torch.Tensor:
    """Real representation of the unit quaternion rotating (g1..g4) onto
    the real axis: the Givens step of the structure-preserving QR
    (reference: phc/quaternion/qr.py:53-62)."""
    if g2 == g3 == g4 == 0.0:
        return torch.eye(4, dtype=_F64)
    g = real_p(*([[float(v)]] for v in (g1, g2, g3, g4)))
    return g / (g1 * g1 + g2 * g2 + g3 * g3 + g4 * g4) ** 0.5


def quat_qr_givens(a1, a2, a3, a4):
    """QR with the Givens post-rotation that makes R's diagonal real
    (reference: phc/quaternion/qr.py, the givens=True path)."""
    q, r = quat_qr(a1, a2, a3, a4)
    m, n = torch.as_tensor(a1).shape
    for j in range(n):
        g = grs_givens(*(float(r[c * m + j, j]) for c in range(4)))
        rows = [j, j + m, j + 2 * m, j + 3 * m]
        r[rows, :] = g.T @ r[rows, :]
        q[rows, :] = g.T @ q[rows, :]
    return q, r
