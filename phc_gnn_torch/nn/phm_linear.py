"""PHM linear layers: PHMLinear, PHMMLP, RealTransformer.

Counterparts of phc_gnn_tpu/nn/phm_linear.py, with the same parameter names
and layouts:

- ``W``        (n, in/n, out/n)  per-component weights,
- ``phm_rule`` (n, n, n)         contribution tensor (frozen unless learn_phm),
- ``b``        (out,)            bias; init 0.0 for component block 0 and 0.2
                                 for the rest (phm_linear.py:65-74).

Every module takes the ``torch.Generator`` its parameters are drawn from.
A rule shared across the network (``unique_phm``) is passed as the
``phm_rule`` argument of ``forward``; a layer built with ``shared_rule=True``
owns no rule of its own (phm_linear.py:86-104).

``dtype`` is the compute dtype (``torch.bfloat16`` under the model's
``compute_dtype``; None keeps the input's): the parameters stay float32 and
``PHMLinear`` casts the input, ``W``, the rule and ``b`` to it before the
product (phm_linear.py:105-110), so its output is in ``dtype``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from phc_gnn_torch.hypercomplex.inits import glorot_normal, glorot_uniform, phm_init
from phc_gnn_torch.hypercomplex.kron import phm_matmul
from phc_gnn_torch.hypercomplex.rules import get_multiplication_rule
from phc_gnn_torch.nn.activations import get_activation
from phc_gnn_torch.nn.norm import PHMNorm

__all__ = ["PHMLinear", "PHMMLP", "RealTransformer", "init_w", "init_rule",
           "phm_bias"]


def init_w(gen: torch.Generator, w_init: str, shape) -> torch.Tensor:
    """w_init in {phm, glorot-normal, glorot-uniform}
    (reference: phc/hypercomplex/layers.py:260-275)."""
    w_init = w_init.replace("_", "-")
    if w_init == "phm":
        return phm_init(gen, *shape)
    if w_init == "glorot-normal":
        return glorot_normal(gen, shape)
    if w_init == "glorot-uniform":
        return glorot_uniform(gen, shape)
    raise ValueError(f"unknown w_init {w_init!r}")


def init_rule(gen: torch.Generator, c_init: str, phm_dim: int) -> torch.Tensor:
    """c_init in {standard, random} (reference: layers.py:280-281)."""
    if c_init == "random":
        return torch.rand((phm_dim,) * 3, generator=gen) * 2.0 - 1.0
    return torch.from_numpy(get_multiplication_rule(phm_dim, c_init))


def phm_bias(phm_dim: int, out_features: int) -> torch.Tensor:
    """Component block 0 -> 0.0, blocks 1..n-1 -> 0.2."""
    b = torch.full((out_features,), 0.2)
    b[:out_features // phm_dim] = 0.0
    return b


class PHMLinear(nn.Module):
    """``y = x (sum_i A_i (x) W_i) + b`` on flat component-block inputs
    ``[N, in]`` (reference: phc/hypercomplex/layers.py:222-299)."""

    def __init__(self, in_features: int, out_features: int, phm_dim: int,
                 bias: bool = True, w_init: str = "phm",
                 c_init: str = "standard", learn_phm: bool = True,
                 generator: Optional[torch.Generator] = None,
                 shared_rule: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        n = phm_dim
        if in_features % n or out_features % n:
            raise ValueError(f"PHMLinear({in_features}, {out_features}) needs "
                             f"sizes divisible by phm_dim={n}")
        gen = generator if generator is not None else torch.Generator()
        self.learn_phm = learn_phm
        self.dtype = dtype
        self.W = nn.Parameter(init_w(gen, w_init,
                                     (n, in_features // n, out_features // n)))
        self.phm_rule = (None if shared_rule else nn.Parameter(
            init_rule(gen, c_init, n), requires_grad=learn_phm))
        self.b = nn.Parameter(phm_bias(n, out_features)) if bias else None

    def forward(self, x: torch.Tensor,
                phm_rule: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``phm_rule`` is the network's shared rule, which a layer built
        with ``shared_rule=True`` needs; without ``learn_phm`` no gradient
        reaches it."""
        if phm_rule is None:
            if self.phm_rule is None:
                raise ValueError("a PHMLinear built with shared_rule=True "
                                 "needs the phm_rule argument")
            phm_rule = self.phm_rule
        elif not self.learn_phm:
            phm_rule = phm_rule.detach()
        w, b = self.W, self.b
        if self.dtype is not None:
            x, w, phm_rule = (t.to(self.dtype) for t in (x, w, phm_rule))
            b = b.to(self.dtype) if b is not None else None
        return phm_matmul(x, phm_rule, w, b)


class PHMMLP(nn.Module):
    """2-layer PHM MLP: linear -> [norm] -> act -> linear
    (reference: phc/hypercomplex/layers.py:304-369)."""

    def __init__(self, in_features: int, out_features: int, phm_dim: int,
                 bias: bool = True, learn_phm: bool = True,
                 activation: str = "relu", norm: Optional[str] = None,
                 w_init: str = "phm", c_init: str = "standard",
                 factor: float = 1.0,
                 generator: Optional[torch.Generator] = None,
                 shared_rule: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        hidden = int(factor * out_features)
        self.linear1 = PHMLinear(in_features, hidden, phm_dim, bias, w_init,
                                 c_init, learn_phm, generator, shared_rule,
                                 dtype)
        self.norm = (PHMNorm(hidden, phm_dim, norm)
                     if norm not in (None, "None") else None)
        self.act = get_activation(activation)
        self.linear2 = PHMLinear(hidden, out_features, phm_dim, bias, w_init,
                                 c_init, learn_phm, generator, shared_rule,
                                 dtype)

    def forward(self, x: torch.Tensor, training: bool = False,
                mask: Optional[torch.Tensor] = None,
                phm_rule: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.linear1(x, phm_rule)
        if self.norm is not None:
            x = self.norm(x, training=training, mask=mask)
        return self.linear2(self.act(x), phm_rule)


class RealTransformer(nn.Module):
    """H^d -> R^(d/n) head: 'linear', a dense layer ``affine`` on the flat
    vector; or 'sum', 'mean' or 'norm' (the 2-norm) over the component axis
    of ``[..., n, d]``, which have no parameters (reference:
    phc/hypercomplex/layers.py:372-420; phm_linear.py:152-177).  'linear'
    computes in its parameters' float32, a bf16 input promoted as flax's
    ``nn.Dense`` promotes it; the others keep the input's dtype."""

    def __init__(self, trafo_type: str, in_features: int, phm_dim: int,
                 bias: bool = True, generator: Optional[torch.Generator] = None):
        super().__init__()
        if trafo_type not in ("linear", "sum", "mean", "norm"):
            raise ValueError(f"unknown real_trafo {trafo_type!r}: linear, "
                             f"sum, mean or norm")
        self.trafo_type = trafo_type
        self.phm_dim = phm_dim
        if trafo_type != "linear":
            return
        # xavier-uniform (gain 1) + zero bias (reference layers.py:393-397);
        # torch keeps the weight as (out, in), flax's kernel is (in, out)
        out = in_features // phm_dim
        gen = generator if generator is not None else torch.Generator()
        self.affine = nn.utils.skip_init(nn.Linear, in_features, out, bias=bias)
        with torch.no_grad():
            self.affine.weight.copy_(
                glorot_uniform(gen, (in_features, out), gain=1.0).T)
            if bias:
                self.affine.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.trafo_type == "linear":
            return self.affine(x.to(self.affine.weight.dtype))
        n = self.phm_dim
        xs = x.reshape(x.shape[:-1] + (n, x.shape[-1] // n))
        if self.trafo_type == "sum":
            return xs.sum(dim=-2)
        if self.trafo_type == "mean":
            return xs.mean(dim=-2)
        # jnp.linalg.norm's formula, so that the gradient at 0 is JAX's
        # too: NaN where a whole component vector is 0 (torch's
        # vector_norm gives 0 there)
        return torch.sqrt((xs * xs).sum(dim=-2))
