"""The port's masked batch norm (kernels D and E's plain versions, and the
training-mode ``PHMNorm``) against the JAX reference.

``fused_masked_bn`` is held to ``phc_gnn_tpu.ops.fused_bn.fused_masked_bn``
in Pallas interpret mode: the output, mean and var, and the gradients in x,
scale and bias.  Tolerance: 1e-5 per leaf, scaled by the leaf's own max (f32
column sums of up to a few hundred rows in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import phc_gnn_tpu.nn.norm as jnorm
from phc_gnn_tpu.ops.fused_bn import fused_masked_bn as jax_fused_masked_bn
from phc_gnn_torch.nn import PHMNorm
from phc_gnn_torch.ops import fused_bn
from torch_parity import assert_leaf_close, load_flax, randomize
from torch_threads import one_torch_thread  # noqa: F401

REL = 1e-5
EPS = 1e-5


def _mask(kind: str, n: int, rng):
    if kind == "random":
        return rng.random(n) > 0.3
    if kind == "all_masked":
        return np.zeros(n, bool)
    if kind == "one_row":
        m = np.zeros(n, bool)
        m[n // 2] = True
        return m
    return np.ones(n, bool)


@pytest.mark.parametrize("shape", [(64, 24), (129, 100)])
@pytest.mark.parametrize("mask_kind", ["random", "all_masked", "one_row",
                                       "none"])
def test_fused_masked_bn_matches_pallas(shape, mask_kind):
    rng = np.random.default_rng(sum(shape) + len(mask_kind))
    n, d = shape
    x = (rng.normal(size=shape) * 2 + 3).astype(np.float32)
    mask = _mask(mask_kind, n, rng)
    scale = rng.normal(size=d).astype(np.float32)
    bias = rng.normal(size=d).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)

    jmask = None if mask_kind == "none" else jnp.asarray(mask)
    (y_j, mean_j, var_j), vjp = jax.vjp(
        lambda x_, s_, b_: jax_fused_masked_bn(x_, jmask, s_, b_, EPS,
                                               interpret=True),
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    dx_j, ds_j, db_j = vjp((jnp.asarray(g), jnp.zeros(d), jnp.zeros(d)))

    xt, st, bt = (torch.tensor(a, requires_grad=True) for a in (x, scale, bias))
    tmask = None if mask_kind == "none" else torch.from_numpy(mask)
    y, mean, var = fused_bn.fused_masked_bn(xt, tmask, st, bt, EPS)
    assert not mean.requires_grad and not var.requires_grad
    y.backward(torch.from_numpy(g))
    for name, got, want in (("y", y, y_j), ("mean", mean, mean_j),
                            ("var", var, var_j), ("dx", xt.grad, dx_j),
                            ("dscale", st.grad, ds_j), ("dbias", bt.grad, db_j)):
        want = np.asarray(want)
        if not np.abs(want).max() > 0:  # all-masked: mean = var = 0 exactly
            assert torch.equal(got, torch.zeros_like(got)), name
        else:
            assert_leaf_close(got, want, REL, name)
    assert torch.isfinite(y).all() and torch.isfinite(xt.grad).all()


def test_bn_backward_plain_gates_only_the_stats_term():
    """Masked rows get ``scale * r * g`` exactly: the mask gates only their
    own statistics term, while the sums run over every row."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(10, 3)).astype(np.float32))
    mask = torch.tensor([True] * 6 + [False] * 4)
    scale = torch.tensor([0.5, 2.0, -1.0])
    g = torch.from_numpy(rng.normal(size=(10, 3)).astype(np.float32))
    _, mean, var = fused_bn.bn_forward(x, mask, scale, torch.zeros(3), EPS)
    dx, dscale, dbias = fused_bn.bn_backward(x, mask, scale, mean, var, EPS, g)
    r = torch.rsqrt(var + EPS)
    assert torch.allclose(dx[~mask], (scale * r * g)[~mask])
    assert torch.allclose(dbias, g.sum(0))
    assert torch.allclose(dscale, (g * (x - mean) * r).sum(0))


def test_phm_norm_training_matches_flax(monkeypatch):
    """The training-mode ``PHMNorm`` against flax's on its fused branch
    (``_FORCE_FUSED_INTERPRET``): the output and the updated running mean and
    (unbiased) var."""
    monkeypatch.setattr(jnorm, "_FORCE_FUSED_INTERPRET", True)
    n4, feats, rows = 4, 32, 40
    rng = np.random.default_rng(9)
    x = (rng.normal(size=(rows, feats)) * 2 + 1).astype(np.float32)
    mask = rng.random(rows) > 0.25
    jm = jnorm.PHMNorm(num_features=feats, phm_dim=n4,
                       norm_type="naive-batch-norm")
    v = randomize(jm.init(jax.random.key(9), jnp.asarray(x), training=False), 9)
    want, upd = jm.apply(v, jnp.asarray(x), training=True,
                         mask=jnp.asarray(mask), mutable=["batch_stats"])
    tm = load_flax(PHMNorm(feats, n4), v)
    got = tm(torch.from_numpy(x), training=True, mask=torch.from_numpy(mask))
    assert_leaf_close(got.detach(), np.asarray(want), REL, "y")
    for key in ("mean", "var"):
        assert_leaf_close(getattr(tm.bn, key),
                          np.asarray(upd["batch_stats"]["bn"][key]), REL, key)


def test_wrappers_never_fall_back_for_non_cpu_tensors():
    x = torch.empty(4, 8, device="meta")
    k = torch.empty(4, dtype=torch.bool, device="meta")
    v = torch.empty(8, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fused_bn.bn_forward(x, k, v, v, EPS)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fused_bn.bn_backward(x, k, v, v, v, EPS, x)
