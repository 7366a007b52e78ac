"""PHM linear layers: PHMLinear, PHMMLP, RealTransformer.

Counterparts of phc_gnn_tpu/nn/phm_linear.py, with the same parameter names
and layouts:

- ``W``        (n, in/n, out/n)  per-component weights,
- ``phm_rule`` (n, n, n)         contribution tensor (frozen unless learn_phm),
- ``b``        (out,)            bias; init 0.0 for component block 0 and 0.2
                                 for the rest (phm_linear.py:65-74).

Every module takes the ``torch.Generator`` its parameters are drawn from.
A rule shared across the network (``unique_phm``) waits for the model
presets (ROADMAP.md, section 1, item 7).
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
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        n = phm_dim
        if in_features % n or out_features % n:
            raise ValueError(f"PHMLinear({in_features}, {out_features}) needs "
                             f"sizes divisible by phm_dim={n}")
        gen = generator if generator is not None else torch.Generator()
        self.W = nn.Parameter(init_w(gen, w_init,
                                     (n, in_features // n, out_features // n)))
        self.phm_rule = nn.Parameter(init_rule(gen, c_init, n),
                                     requires_grad=learn_phm)
        self.b = nn.Parameter(phm_bias(n, out_features)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return phm_matmul(x, self.phm_rule, self.W, self.b)


class PHMMLP(nn.Module):
    """2-layer PHM MLP: linear -> [norm] -> act -> linear
    (reference: phc/hypercomplex/layers.py:304-369)."""

    def __init__(self, in_features: int, out_features: int, phm_dim: int,
                 bias: bool = True, learn_phm: bool = True,
                 activation: str = "relu", norm: Optional[str] = None,
                 w_init: str = "phm", c_init: str = "standard",
                 factor: float = 1.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        hidden = int(factor * out_features)
        self.linear1 = PHMLinear(in_features, hidden, phm_dim, bias, w_init,
                                 c_init, learn_phm, generator)
        self.norm = (PHMNorm(hidden, phm_dim, norm)
                     if norm not in (None, "None") else None)
        self.act = get_activation(activation)
        self.linear2 = PHMLinear(hidden, out_features, phm_dim, bias, w_init,
                                 c_init, learn_phm, generator)

    def forward(self, x: torch.Tensor, training: bool = False,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.linear1(x)
        if self.norm is not None:
            x = self.norm(x, training=training, mask=mask)
        return self.linear2(self.act(x))


class RealTransformer(nn.Module):
    """H^d -> R^(d/n) head, type 'linear': a dense layer ``affine`` on the
    flat vector (reference: phc/hypercomplex/layers.py:372-420).  The 'sum',
    'mean' and 'norm' types wait for the model presets (ROADMAP.md, section
    1, item 7)."""

    def __init__(self, trafo_type: str, in_features: int, phm_dim: int,
                 bias: bool = True, generator: Optional[torch.Generator] = None):
        super().__init__()
        if trafo_type != "linear":
            raise NotImplementedError(
                f"real_trafo {trafo_type!r} is not ported yet (ROADMAP.md, "
                f"section 1, item 7)")
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
        return self.affine(x)

