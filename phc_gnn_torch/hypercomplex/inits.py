"""Weight initializers for PHM layers on an explicit ``torch.Generator``.

Counterparts of phc_gnn_tpu/hypercomplex/inits.py.  The two frameworks draw
different numbers from one seed, so these match in distribution and shape,
not value; parity tests load converted weights instead.  Draws are made on
the CPU from the generator, so a model's init does not depend on the device
it later runs on.  The quaternion orthogonal init runs the port's float64
structure-preserving Householder QR (``hypercomplex/qr.py``) at init time.
"""

from __future__ import annotations

import math

import torch

__all__ = ["unitary_init", "phm_init", "glorot_uniform", "glorot_normal",
           "quaternion_init", "orthogonal_init"]


def _uniform(gen: torch.Generator, shape, low: float, high: float) -> torch.Tensor:
    return torch.rand(shape, generator=gen, dtype=torch.float32) * (high - low) + low


def unitary_init(gen: torch.Generator, n: int, in_features: int,
                 out_features: int, low: float = 0.0,
                 high: float = 1.0) -> torch.Tensor:
    """Unit-norm purely "imaginary" direction field of shape (n, in, out):
    component 0 is zero, the rest are U(low, high), normalized over the
    component axis (reference: phc/hypercomplex/inits.py:6-13)."""
    v = _uniform(gen, (n - 1, in_features, out_features), low, high)
    v = torch.cat([torch.zeros((1, in_features, out_features)), v], dim=0)
    return v / torch.linalg.vector_norm(v, dim=0, keepdim=True)


def phm_init(gen: torch.Generator, n: int, in_features: int, out_features: int,
             criterion: str = "glorot") -> torch.Tensor:
    """PHM weight init: chi(df=n) magnitude x unit imaginary direction x random
    phase; returns (n, in, out) (reference: phc/hypercomplex/inits.py:16-44)."""
    if criterion == "glorot":
        s = math.sqrt(2.0 / (n * (in_features + out_features)))
    elif criterion == "he":
        s = math.sqrt(2.0 / (n * in_features))
    else:
        raise ValueError(f"invalid criterion: {criterion!r}")
    shape = (in_features, out_features)
    # chi(df=n, scale=s) == s * ||N(0, I_n)||
    normal = torch.randn((n,) + shape, generator=gen, dtype=torch.float32)
    magnitude = s * torch.linalg.vector_norm(normal, dim=0)
    v = unitary_init(gen, n, in_features, out_features)
    theta = _uniform(gen, shape, -math.pi, math.pi)
    w0 = magnitude * torch.cos(theta)
    rest = magnitude[None] * v[1:] * torch.sin(theta)[None]
    return torch.cat([w0[None], rest], dim=0)


def glorot_uniform(gen: torch.Generator, shape,
                   gain: float = math.sqrt(2.0)) -> torch.Tensor:
    """Xavier-uniform over the last two axes (fan_in = shape[-2],
    fan_out = shape[-1]); gain sqrt(2) as reference phc/quaternion/inits.py:16-17."""
    fan_in, fan_out = shape[-2], shape[-1]
    limit = gain * math.sqrt(6.0 / (fan_in + fan_out))
    return _uniform(gen, tuple(shape), -limit, limit)


def glorot_normal(gen: torch.Generator, shape,
                  gain: float = math.sqrt(2.0)) -> torch.Tensor:
    """Xavier-normal with gain sqrt(2) (reference: phc/quaternion/inits.py:12-13)."""
    fan_in, fan_out = shape[-2], shape[-1]
    std = gain * math.sqrt(2.0 / (fan_in + fan_out))
    return std * torch.randn(tuple(shape), generator=gen, dtype=torch.float32)


def quaternion_init(gen: torch.Generator, in_features: int, out_features: int,
                    criterion: str = "glorot") -> torch.Tensor:
    """Fixed n = 4 quaternion init with the reference's extra weighting of
    each imaginary phase; returns (4, in, out) (inits.py:76-98; reference:
    phc/quaternion/inits.py:40-76, the transpose=False orientation)."""
    if criterion == "glorot":
        s = 1.0 / math.sqrt(2.0 * (in_features + out_features))
    elif criterion == "he":
        s = 1.0 / math.sqrt(2.0 * in_features)
    else:
        raise ValueError(f"invalid criterion: {criterion!r}")
    shape = (in_features, out_features)
    normal = torch.randn((4,) + shape, generator=gen, dtype=torch.float32)
    magnitude = s * torch.linalg.vector_norm(normal, dim=0)
    v = unitary_init(gen, 4, in_features, out_features)  # v[0] == 0
    theta = _uniform(gen, shape, -math.pi, math.pi)
    phi = torch.cos(_uniform(gen, (3,) + shape, -s, s)) ** 2
    phi = phi / phi.sum(dim=0, keepdim=True)
    w_r = magnitude * torch.cos(theta)
    w_imag = magnitude[None] * v[1:] * torch.sin(theta)[None] * phi
    return torch.cat([w_r[None], w_imag], dim=0)


def orthogonal_init(gen: torch.Generator, in_features: int,
                    out_features: int, scale: float = 1.0) -> torch.Tensor:
    """Quaternion orthogonal init through the structure-preserving
    Householder QR in float64; returns (4, out, in) float32 component
    weights whose real 4x4 block representation is orthogonal up to the
    reference's 1/2 scaling (inits.py:101-121; reference:
    phc/quaternion/inits.py:79-112)."""
    from phc_gnn_torch.hypercomplex.qr import quat_qr

    w = scale * torch.randn((4, out_features, in_features), generator=gen,
                            dtype=torch.float64)
    flipped = out_features < in_features
    if flipped:
        w = w.transpose(1, 2)
    q, _ = quat_qr(w[0], w[1], w[2], w[3])
    q = q[:, :in_features] / 2.0
    rows = q.shape[0] // 4
    parts = [q[c * rows:(c + 1) * rows] for c in range(4)]
    if flipped:
        parts = [p[:out_features, :] for p in parts]
    return torch.stack(parts).to(torch.float32)
