"""The port's row-blocked batch norm (the plain versions of kernels F and G,
each with its elementwise pass) and the norm's size gate, against the JAX
reference.

``fused_masked_bn_blocked`` is held to
``phc_gnn_tpu.ops.fused_bn.fused_masked_bn_blocked`` in Pallas interpret
mode on the cases of ``tests/test_nn_modules.py::
test_fused_bn_blocked_matches_two_pass_and_grads``: N = 1,100 and D = 24,
so JAX's last 512-row block is ragged, with a random mask and with rows
512-1023 all masked.  Compared: the output, mean and var, and the gradients
in x, scale and bias.  Tolerance: 1e-5 per leaf, scaled by the leaf's own
max (f32 sums of up to 1,100 rows in other orders: JAX combines its row
blocks with Chan's formula, the port's plain version sums all live rows in
one pass and centres them in a second).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import phc_gnn_tpu.nn.norm as jnorm
import phc_gnn_tpu.ops.fused_bn as jfused
from phc_gnn_torch.nn import PHMNorm
from phc_gnn_torch.ops import fused_bn
from torch_parity import assert_leaf_close, load_flax, randomize
from torch_threads import one_torch_thread  # noqa: F401

REL = 1e-5
EPS = 1e-5


def _mask(kind: str, n: int, rng):
    mask = rng.random(n) > 0.25
    if kind == "masked_block":
        mask[512:1024] = False
    elif kind == "all_masked":
        mask[:] = False
    elif kind == "one_row":
        mask[:] = False
        mask[700] = True
    return mask


def _inputs(seed: int, n: int = 1100, d: int = 24):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, d)) * 2 + 3).astype(np.float32)
    scale = rng.normal(size=d).astype(np.float32)
    bias = rng.normal(size=d).astype(np.float32)
    g = rng.normal(size=(n, d)).astype(np.float32)
    return rng, x, scale, bias, g


@pytest.mark.parametrize("mask_kind", ["random", "masked_block", "all_masked",
                                       "one_row", "none"])
def test_fused_masked_bn_blocked_matches_pallas(mask_kind):
    rng, x, scale, bias, g = _inputs(5)
    n, d = x.shape
    mask = _mask(mask_kind, n, rng)
    jmask = None if mask_kind == "none" else jnp.asarray(mask)
    (y_j, mean_j, var_j), vjp = jax.vjp(
        lambda x_, s_, b_: jfused.fused_masked_bn_blocked(
            x_, jmask, s_, b_, EPS, interpret=True),
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    dx_j, ds_j, db_j = vjp((jnp.asarray(g), jnp.zeros(d), jnp.zeros(d)))

    xt, st, bt = (torch.tensor(a, requires_grad=True) for a in (x, scale, bias))
    tmask = None if mask_kind == "none" else torch.from_numpy(mask)
    y, mean, var = fused_bn.fused_masked_bn_blocked(xt, tmask, st, bt, EPS)
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


def test_blocked_stats_skip_masked_blocks_exactly():
    """Masked rows, whole 128-row blocks of them, add nothing: the
    statistics equal those of the live rows alone; ``cnt`` is the live
    count, at least 1, so an all-masked input has mean and var 0 exactly and
    a finite output (``bn_forward_blocked`` on CPU tensors)."""
    rng, x, scale, bias, _ = _inputs(6, n=600, d=8)
    mask = np.zeros(600, bool)
    mask[130:250] = rng.random(120) > 0.3  # live rows in row block 1 only
    mean, var, cnt = fused_bn.bn_stats_blocked_plain(
        torch.from_numpy(x), torch.from_numpy(mask))
    live = torch.from_numpy(x[mask])
    assert torch.equal(cnt, torch.tensor([float(mask.sum())]))
    torch.testing.assert_close(mean, live.mean(0), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(var, live.var(0, unbiased=False), rtol=1e-5,
                               atol=1e-6)
    none = torch.zeros(600, dtype=torch.bool)
    _, _, cnt0 = fused_bn.bn_stats_blocked_plain(torch.from_numpy(x), none)
    assert float(cnt0) == 1.0
    y0, mean0, var0 = fused_bn.bn_forward_blocked(
        torch.from_numpy(x), none, torch.from_numpy(scale),
        torch.from_numpy(bias), EPS)
    assert torch.equal(mean0, torch.zeros(8)) and torch.equal(var0,
                                                              torch.zeros(8))
    assert torch.isfinite(y0).all()


def test_blocked_variance_is_centred():
    """A column at 1e4 with a spread of 1e-2: E[x^2] - E[x]^2 loses it in
    f32, the centred two-pass variance keeps it."""
    rng = np.random.default_rng(7)
    x = (1e4 + 1e-2 * rng.normal(size=(1000, 3))).astype(np.float32)
    mask = torch.ones(1000, dtype=torch.bool)
    _, _, var = fused_bn.bn_forward_blocked(torch.from_numpy(x), mask,
                                            torch.ones(3), torch.zeros(3), EPS)
    want = x.astype(np.float64).var(0)
    np.testing.assert_allclose(var.numpy(), want, rtol=2e-2)


@pytest.mark.parametrize("gate", ["blocked", "single"])
def test_norm_dispatch_matches_flax(monkeypatch, gate):
    """The training-mode ``PHMNorm`` against flax's fused branch
    (``_FORCE_FUSED_INTERPRET``), with the size gate at 0 on both sides (the
    blocked family) or at its value (the single-block pair): the output, the
    updated running mean and (unbiased) var, and the gradient of x."""
    monkeypatch.setattr(jnorm, "_FORCE_FUSED_INTERPRET", True)
    if gate == "blocked":
        monkeypatch.setattr(jfused, "FUSED_BN_VMEM_LIMIT", 0)
        monkeypatch.setattr(fused_bn, "FUSED_BN_VMEM_LIMIT", 0)
    called = []
    for name in ("fused_masked_bn", "fused_masked_bn_blocked"):
        fn = getattr(fused_bn, name)
        monkeypatch.setattr(fused_bn, name,
                            lambda *a, _f=fn, _n=name, **k: (
                                called.append(_n), _f(*a, **k))[1])
    n2, feats, rows = 2, 32, 300
    rng = np.random.default_rng(8)
    x = (rng.normal(size=(rows, feats)) * 2 + 1).astype(np.float32)
    mask = rng.random(rows) > 0.25
    g = rng.normal(size=(rows, feats)).astype(np.float32)
    jm = jnorm.PHMNorm(num_features=feats, phm_dim=n2,
                       norm_type="naive-batch-norm")
    v = randomize(jm.init(jax.random.key(8), jnp.asarray(x), training=False), 8)

    def f(x_):
        return jm.apply(v, x_, training=True, mask=jnp.asarray(mask),
                        mutable=["batch_stats"])

    want, upd = f(jnp.asarray(x))
    (dx_j,) = jax.vjp(lambda x_: f(x_)[0], jnp.asarray(x))[1](jnp.asarray(g))
    tm = load_flax(PHMNorm(feats, n2), v)
    xt = torch.tensor(x, requires_grad=True)
    got = tm(xt, training=True, mask=torch.from_numpy(mask))
    got.backward(torch.from_numpy(g))
    assert called == ["fused_masked_bn_blocked" if gate == "blocked"
                      else "fused_masked_bn"]
    assert_leaf_close(got.detach(), np.asarray(want), REL, "y")
    assert_leaf_close(xt.grad, np.asarray(dx_j), REL, "dx")
    for key in ("mean", "var"):
        assert_leaf_close(getattr(tm.bn, key),
                          np.asarray(upd["batch_stats"]["bn"][key]), REL, key)


@pytest.mark.parametrize("shape,blocked", [((4096, 2, 256), True),
                                           ((4096, 4, 50), False),
                                           ((129, 2, 384), False)])
def test_size_gate_arithmetic(monkeypatch, shape, blocked):
    """JAX's gate counts the f32 bytes of the [N, n, d] input: pcba's conv
    outputs (8,388,608 bytes) go to the blocked family, the flagship's
    (3,276,800) and pcba's head norms stay on the single-block pair."""
    called = []
    for name in ("fused_masked_bn", "fused_masked_bn_blocked"):
        fn = getattr(fused_bn, name)
        monkeypatch.setattr(fused_bn, name,
                            lambda *a, _f=fn, _n=name, **k: (
                                called.append(_n), _f(*a, **k))[1])
    n, comps, d = shape
    norm = PHMNorm(comps * d, comps)
    x = torch.randn((n, comps * d), generator=torch.Generator().manual_seed(0))
    norm(x, training=True, mask=torch.ones(n, dtype=torch.bool))
    assert called == ["fused_masked_bn_blocked" if blocked
                      else "fused_masked_bn"]
    assert (n * comps * d * 4 > fused_bn.FUSED_BN_VMEM_LIMIT) == blocked
    assert fused_bn.FUSED_BN_VMEM_LIMIT == jfused.FUSED_BN_VMEM_LIMIT


def test_blocked_wrappers_never_fall_back_for_non_cpu_tensors():
    x = torch.empty(4, 8, device="meta")
    k = torch.empty(4, dtype=torch.bool, device="meta")
    v = torch.empty(8, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fused_bn.bn_forward_blocked(x, k, v, v, EPS)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fused_bn.bn_backward_blocked(x, k, v, v, v, EPS, x)
