"""Shared helpers of the parity tests between phc_gnn_tpu (JAX, the reference)
and phc_gnn_torch (the PyTorch port).  Inputs come from numpy seeds; weights
go from the flax variables to the port through ``convert.from_flax_variables``.
"""

from __future__ import annotations

import jax
import numpy as np
import torch

from phc_gnn_torch.convert import from_flax_variables


def numpy_tree(tree):
    """A flax variable tree as nested dicts of numpy arrays."""
    if hasattr(tree, "items"):
        return {k: numpy_tree(v) for k, v in tree.items()}
    return np.asarray(jax.device_get(tree))


def randomize(variables, seed: int = 0):
    """Non-trivial running stats and betas, so the eval path is exercised:
    BN mean ~ N(0, 0.3), var ~ U(0.5, 2), every ``beta`` ~ U(0.5, 2.5)."""
    rng = np.random.default_rng(seed)

    def walk(tree, col):
        out = {}
        for k, v in tree.items():
            if hasattr(v, "items"):
                out[k] = walk(v, col)
            elif col == "batch_stats" and k == "mean":
                out[k] = rng.normal(0.0, 0.3, v.shape).astype(np.float32)
            elif col == "batch_stats" and k == "var":
                out[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
            elif col == "params" and k == "beta":
                out[k] = np.float32(rng.uniform(0.5, 2.5))
            else:
                out[k] = v
        return out

    variables = numpy_tree(variables)
    return {col: walk(tree, col) for col, tree in variables.items()}


def load_flax(module: torch.nn.Module, variables) -> torch.nn.Module:
    module.load_state_dict(from_flax_variables(numpy_tree(variables), module))
    return module.eval()


def _as_f64(got, want):
    got = np.asarray(got.detach().cpu().numpy() if torch.is_tensor(got) else got,
                     np.float64)
    return got, np.asarray(want, np.float64)


def assert_close(got, want, rel: float):
    """Normwise relative check: max |got - want| <= rel * max(1, max |want|)."""
    got, want = _as_f64(got, want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    err = np.max(np.abs(got - want)) if got.size else 0.0
    scale = max(1.0, float(np.max(np.abs(want)))) if want.size else 1.0
    assert err <= rel * scale, f"max abs err {err:.3g} > {rel:g} * {scale:.3g}"


def assert_leaf_close(got, want, rel: float, name: str = ""):
    """Relative check scaled by the leaf's OWN size: max |got - want| <=
    rel * max |want|.  For gradients and updates, whose entries can be far
    below 1, where ``assert_close``'s floor of 1 would make the check
    vacuous."""
    got, want = _as_f64(got, want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    assert np.isfinite(got).all(), name
    err = np.max(np.abs(got - want)) if got.size else 0.0
    scale = float(np.max(np.abs(want))) if want.size else 0.0
    assert err <= rel * scale, (f"{name}: max abs err {err:.3g} > {rel:g} * "
                                f"max |want| {scale:.3g}")
