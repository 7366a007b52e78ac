"""Shared helpers of the parity tests between phc_gnn_tpu (JAX, the reference)
and phc_gnn_torch (the PyTorch port).  Inputs come from numpy seeds; weights
go from the flax variables to the port through ``convert.from_flax_variables``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from phc_gnn_tpu.ops.stream_scan import STREAMED_AGGREGATORS, build_scan_plan
from phc_gnn_torch.convert import from_flax_variables
from phc_gnn_torch.graph import build_csr_rowptr, conv


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


def port_flat(tree):
    """A flax tree (numpy) flattened to the port's keys and layouts."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = ".".join(p.key for p in path)
        if key.endswith(".kernel"):  # nn.Dense (in, out) -> Linear (out, in)
            key, leaf = key[:-len("kernel")] + "weight", leaf.T
        out[key] = np.asarray(leaf)
    return out


def spd_cov(rng, d):
    """A random symmetric positive definite 4x4 per feature, [4, 4, d]: a
    whitening norm's running covariance."""
    b = rng.normal(size=(d, 4, 4))
    cov = b @ b.transpose(0, 2, 1) / 4 + 0.2 * np.eye(4)
    return np.ascontiguousarray(cov.transpose(1, 2, 0)).astype(np.float32)


def assert_update(new, old, want_new, rel: float, name: str = ""):
    """The parameter update ``new - old`` against ``want_new - old``, per
    leaf, to ``rel`` of its largest entry plus 2 ulp of the largest
    parameter (both sides round ``p - lr * u`` to f32)."""
    new, old = new.detach().double().numpy(), old.double().numpy()
    want_new = np.asarray(want_new, np.float64)
    err = np.abs(new - want_new).max()
    ulp = np.spacing(np.float32(np.abs(want_new).max()))
    tol = rel * np.abs(want_new - old).max() + 2 * float(ulp)
    assert err <= tol, f"{name}: update err {err:.3g} > {tol:.3g}"


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


# ------------------------------------------------ PNA aggregation inputs

def adversarial_receivers(seed: int, n: int = 64):
    """Receiver-sorted edges as tests/test_torch_sum_aggr.py makes them:
    node 3 isolated, node 7 with 1,100 edges, masked edges among real ones
    (all of node 11's), and a masked tail of 40 edges on the last node."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, 6, size=n)
    counts[3] = 0
    counts[7] = 1100
    recv = np.repeat(np.arange(n), counts)
    mask = rng.random(recv.shape[0]) > 0.25
    lo = counts[:11].sum()
    mask[lo:lo + counts[11]] = False
    recv = np.concatenate([recv, np.full(40, n - 1)]).astype(np.int32)
    mask = np.concatenate([mask, np.zeros(40, bool)])
    return recv, mask, n


def small_receivers(seed: int, n: int = 64, e: int = 300):
    """E = 300 random receivers over N = 64, a masked padding tail."""
    rng = np.random.default_rng(seed)
    recv = np.sort(rng.integers(0, n - 1, e - 20))
    recv = np.concatenate([recv, np.full(20, n - 1)]).astype(np.int32)
    mask = np.concatenate([rng.random(e - 20) > 0.15, np.zeros(20, bool)])
    return recv, mask, n


def pna_messages(kind, e, d, seed):
    """Random normal messages, or ``ties``: halves in [-1.5, 1.5], so that
    most segments hold exact ties at their min and max and every sum is
    exact (the var is then exact too, away from any rounding kink)."""
    rng = np.random.default_rng(seed)
    if kind == "ties":
        return (rng.integers(-3, 4, size=(e, d)) / 2).astype(np.float32)
    return rng.normal(size=(e, d)).astype(np.float32)


def jax_plan_aggregate(name, recv, mask, n, msgs, g):
    """JAX's streamed aggregation ``name`` with its scan plan (128-edge
    blocks; the Pallas kernels in interpret mode on the CPU): the output
    and the VJP of ``g``."""
    flags, cont, last = map(jnp.asarray, build_scan_plan(recv, n, 128,
                                                         edge_mask=mask))
    out, vjp = jax.vjp(lambda m_: STREAMED_AGGREGATORS[name](
        m_, jnp.asarray(recv), flags, cont, last, n, jnp.asarray(mask)),
        jnp.asarray(msgs))
    return np.asarray(out), np.asarray(vjp(jnp.asarray(g))[0])


def port_plan_aggregate(name, recv, mask, n, msgs, g):
    """The port's aggregation ``name`` over the CSR plan (the kernels'
    plain versions on the CPU): the output and the gradient of ``g``."""
    k = torch.from_numpy(mask)
    rt = torch.from_numpy(recv)
    mt = torch.tensor(msgs, requires_grad=True)
    out = conv._fixed_aggr(mt, rt, n, k, name,
                           rowptr=torch.from_numpy(build_csr_rowptr(recv, n,
                                                                    mask)))
    out.backward(torch.from_numpy(g))
    return out.detach(), mt.grad
