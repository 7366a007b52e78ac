"""The port's quaternion whitening norm ('q-batch-norm') against JAX.

``ops/fused_whitening.py`` (the plain versions of kernels J, K, L, M and the
eval Cholesky, which CPU tensors run) against
``phc_gnn_tpu.ops.fused_whitening`` with its Pallas kernels in interpret mode
(``_FORCE_INTERPRET``; n = 2,500 spans three of its 1,024-row blocks), and
``nn/norm.py``'s ``QuaternionWhiteningNorm`` and ``PHMNorm`` (every norm
type) against the flax modules: outputs in train and eval, and the running
stats after a training step.  Inputs come from numpy seeds.

Tolerances, each with its reason:
- ``TOL_WBN`` 2e-5 of each output's max: the same f32 formula, with the
  statistics summed in another order (JAX's Chan combine over row blocks
  against the port's single pass) and the Cholesky's square roots and
  divisions amplifying that by the conditioning of the 4x4 covariance.
- ``TOL_MODULE`` 1e-5: module outputs and running stats, normwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import phc_gnn_tpu.ops.fused_whitening as jfw
from phc_gnn_tpu.nn.norm import PHMNorm as JaxPHMNorm
from phc_gnn_tpu.nn.norm import QuaternionWhiteningNorm as JaxWhiteningNorm
from phc_gnn_torch.nn.norm import PHMNorm, QuaternionWhiteningNorm
from phc_gnn_torch.ops import fused_whitening as tfw
from torch_parity import (assert_close, assert_leaf_close, load_flax,
                          numpy_tree, spd_cov)
from torch_threads import one_torch_thread  # noqa: F401

TOL_WBN = 2e-5
TOL_MODULE = 1e-5
EPS = 1e-5


def _inputs(n, d, seed, mask_kind="random"):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, 4 * d)) * 1.2 - 0.4).astype(np.float32)
    mask = rng.random(n) > 0.2
    if mask_kind == "all-masked":
        mask[:] = False
    elif mask_kind == "one-row":
        mask[:] = False
        mask[n // 3] = True
    gamma = (rng.normal(size=(4, 4, d)) * 0.2
             + 0.5 * np.eye(4)[..., None]).astype(np.float32)
    beta = (rng.normal(size=(4, d)) * 0.3).astype(np.float32)
    g = rng.normal(size=(n, 4 * d)).astype(np.float32)
    return x, mask, gamma, beta, g


def _jax_whitening(x, mask, gamma, beta, g):
    """y, mean, cov and the gradients of sum(y * g) through JAX's Pallas
    kernels in interpret mode."""
    mf = jnp.asarray(mask.astype(np.float32))[:, None]

    def f(x_, gm, bt):
        return jfw.fused_whitening(x_, mf, gm, bt, EPS)

    args = (jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
    assert not jfw._FORCE_INTERPRET
    jfw._FORCE_INTERPRET = True
    try:
        y, mean, cov = f(*args)
        grads = jax.grad(lambda *a: jnp.sum(f(*a)[0] * jnp.asarray(g)),
                         argnums=(0, 1, 2))(*args)
    finally:
        jfw._FORCE_INTERPRET = False
    return [np.asarray(a) for a in (y, mean, cov) + tuple(grads)]


@pytest.mark.parametrize("n,mask_kind", [(96, "random"), (96, "all-masked"),
                                         (96, "one-row"), (2500, "random")])
def test_fused_whitening_matches_jax(n, mask_kind):
    """Outputs and gradients of ``fused_whitening`` (the plain versions of
    J, K, L, M on CPU tensors) against JAX's Pallas kernels."""
    x, mask, gamma, beta, g = _inputs(n, 5, 7, mask_kind)
    want = _jax_whitening(x, mask, gamma, beta, g)
    tx = torch.tensor(x, requires_grad=True)
    tg = torch.tensor(gamma, requires_grad=True)
    tb = torch.tensor(beta, requires_grad=True)
    y, mean, cov = tfw.fused_whitening(tx, torch.from_numpy(mask), tg, tb, EPS)
    assert not mean.requires_grad and not cov.requires_grad
    (y * torch.from_numpy(g)).sum().backward()
    for name, got, w in zip(("y", "mean", "cov", "dx", "dgamma", "dbeta"),
                            (y, mean, cov, tx.grad, tg.grad, tb.grad), want):
        if not np.abs(w).max():
            assert float(got.abs().max()) == 0.0, name
        else:
            assert_leaf_close(got, w, TOL_WBN, name)


def test_kernel_stages_match_jax_formula():
    """Each plain stage against the JAX helper it follows: the statistics
    and the Cholesky fields (``_stats``, ``_chol_fields``), the transform,
    and the backward's ``M`` (``_m_from_lbar``) and ``sum w``."""
    x, mask, gamma, beta, g = _inputs(300, 6, 3)
    mf = jnp.asarray(mask.astype(np.float32))[:, None]
    cnt, c, mean, cov = jfw._stats(jnp.asarray(x), mf, 6)
    l = jfw._chol_fields(cov, EPS)
    t_mean, t_cov, t_l, t_cnt = tfw.wbn_stats(torch.from_numpy(x),
                                              torch.from_numpy(mask), EPS)
    assert float(t_cnt) == float(cnt) == mask.sum()
    assert_leaf_close(t_mean, np.stack(mean), TOL_WBN, "mean")
    for i, jk in enumerate(tfw.L_IDX):
        assert_leaf_close(t_l[i], np.asarray(l[jk]), TOL_WBN, f"L{jk}")
    y, _, zs = jfw._transform(c, mean, l, jnp.asarray(gamma),
                              jnp.asarray(beta))
    assert_leaf_close(tfw.wbn_transform(torch.from_numpy(x), t_mean, t_l,
                                        torch.from_numpy(gamma),
                                        torch.from_numpy(beta)),
                      np.asarray(y), TOL_WBN, "y")
    # the backward's field algebra, from JAX's own w and z
    gs = jfw._slices(jnp.asarray(g), 6)
    hs = [sum(jnp.asarray(gamma)[cc, k][None] * gs[cc] for cc in range(4))
          for k in range(4)]
    ws = jfw._bwd_subst(l, hs)
    lbar = {jk: -jnp.sum(ws[jk[0]] * zs[jk[1]], axis=0) for jk in tfw.L_IDX}
    m_rows = jfw._m_from_lbar(l, lbar)
    _, _, mmat, sw = tfw.wbn_bwd_sums(torch.from_numpy(x), torch.from_numpy(g),
                                      torch.from_numpy(gamma), t_mean, t_l)
    want_m = np.stack([np.asarray(m_rows[a][b]) for a in range(4)
                       for b in range(4)])
    assert_leaf_close(mmat, want_m, TOL_WBN, "M")
    np.testing.assert_allclose(mmat.numpy().reshape(4, 4, -1),
                               mmat.numpy().reshape(4, 4, -1).transpose(1, 0, 2),
                               rtol=0, atol=1e-5 * np.abs(want_m).max())
    assert_leaf_close(sw, np.stack([np.asarray(jnp.sum(w, 0)) for w in ws]),
                      TOL_WBN, "sum w")


def test_eval_cholesky_matches_jax():
    """``wbn_transform_eval``'s factor reads the upper triangle of a running
    covariance, as JAX's eval path does, including the all-ones start (where
    cov + eps I is barely positive definite)."""
    rng = np.random.default_rng(5)
    x, _, gamma, beta, _ = _inputs(20, 7, 4)
    mean = torch.from_numpy((rng.normal(size=(4, 7)) * 0.3).astype(np.float32))
    for cov in (spd_cov(rng, 7), np.ones((4, 4, 7), np.float32)):
        want = jfw._chol_fields({(j, k): jnp.asarray(cov[j, k])
                                 for j in range(4) for k in range(j, 4)},
                                jnp.float32(EPS))
        y, got = tfw.wbn_transform_eval(
            torch.from_numpy(x), mean, torch.from_numpy(cov),
            torch.from_numpy(gamma), torch.from_numpy(beta), EPS)
        assert torch.isfinite(got).all() and torch.isfinite(y).all()
        for i, jk in enumerate(tfw.L_IDX):
            assert_leaf_close(got[i], np.asarray(want[jk]), TOL_WBN, str(jk))


@pytest.mark.parametrize("cov_kind", ["spd", "ones"])
def test_eval_whitening_matches_jax_eval_norm(cov_kind):
    """``eval_whitening`` (``wbn_transform_eval``'s plain version on CPU
    tensors) against JAX's eval ``QuaternionWhiteningNorm``
    (phc_gnn_tpu/nn/norm.py:331-345) from the same running mean and
    covariance, Gamma and beta: a random SPD covariance, and the all-ones
    start."""
    n, d = 96, 6
    x, _, gamma, beta, _ = _inputs(n, d, 13)
    rng = np.random.default_rng(14)
    mean = (rng.normal(size=(4, d)) * 0.3).astype(np.float32)
    cov = (spd_cov(rng, d) if cov_kind == "spd"
           else np.ones((4, 4, d), np.float32))
    jm = JaxWhiteningNorm(num_features=d)
    v = {"params": {"gamma": gamma, "beta": beta},
         "batch_stats": {"mean": mean, "cov": cov}}
    want = jm.apply(v, jnp.asarray(x), training=False)
    got = tfw.eval_whitening(*(torch.from_numpy(a) for a in (x, mean, cov,
                                                             gamma, beta)),
                             EPS)
    assert_leaf_close(got, np.asarray(want), TOL_WBN, "y")


def test_wrappers_off_the_cpu_take_the_kernels_or_raise():
    """Off the CPU there is no plain fallback: the wrappers refuse a device
    they cannot launch on (a ``meta`` tensor stands in for a CUDA one)."""
    x = torch.empty(8, 20, device="meta")
    mask = torch.empty(8, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tfw.wbn_stats(x, mask, EPS)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tfw.wbn_transform_eval(x, torch.empty(4, 5, device="meta"),
                               torch.empty(4, 4, 5, device="meta"),
                               torch.empty(4, 4, 5, device="meta"),
                               torch.empty(4, 5, device="meta"), EPS)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tfw.fused_whitening(x, mask, torch.empty(4, 4, 5, device="meta"),
                            torch.empty(4, 5, device="meta"))


def _randomize_qbn(variables, seed):
    """Non-trivial running mean and covariance, Gamma and beta."""
    rng = np.random.default_rng(seed)
    v = numpy_tree(variables)
    p, s = v["params"], v["batch_stats"]
    d = p["beta"].shape[1]
    p["gamma"] = (p["gamma"] + rng.normal(size=p["gamma"].shape) * 0.1
                  ).astype(np.float32)
    p["beta"] = (rng.normal(size=(4, d)) * 0.3).astype(np.float32)
    s["mean"] = (rng.normal(size=(4, d)) * 0.3).astype(np.float32)
    s["cov"] = spd_cov(rng, d)
    return v


@pytest.mark.parametrize("layout", ["flat", "stacked"])
def test_whitening_norm_module_matches_jax(layout):
    """``QuaternionWhiteningNorm``: the init (running cov all ones, Gamma
    0.5 I), the training output and the running mean and biased cov after
    one step, and the eval output from random running stats; flat [N, 4d]
    and stacked [N, 4, d] inputs."""
    n, d = 150, 6
    x, mask, _, _, _ = _inputs(n, d, 11)
    shape = (n, 4 * d) if layout == "flat" else (n, 4, d)
    x = x.reshape(shape)
    jm = JaxWhiteningNorm(num_features=d)
    v0 = numpy_tree(jm.init(jax.random.key(0), jnp.asarray(x), training=True,
                            mask=jnp.asarray(mask)))
    tm = QuaternionWhiteningNorm(d)
    np.testing.assert_array_equal(tm.cov.numpy(), v0["batch_stats"]["cov"])
    np.testing.assert_array_equal(tm.gamma.detach().numpy(),
                                  v0["params"]["gamma"])
    v = _randomize_qbn(v0, 3)
    load_flax(tm, v)
    for training in (True, False):
        want = jm.apply(v, jnp.asarray(x), training=training,
                        mask=jnp.asarray(mask), mutable=["batch_stats"])
        got = tm(torch.from_numpy(x), training=training,
                 mask=torch.from_numpy(mask))
        assert got.shape == shape
        assert_close(got.detach(), np.asarray(want[0]), TOL_MODULE)
        if training:
            for k in ("mean", "cov"):
                assert_leaf_close(getattr(tm, k),
                                  np.asarray(want[1]["batch_stats"][k]),
                                  TOL_MODULE, k)
            load_flax(tm, v)  # eval from the same running stats as JAX


@pytest.mark.parametrize("norm_type", ["naive-batch-norm",
                                       "naive-naive-batch-norm",
                                       "q-batch-norm"])
def test_phm_norm_dispatch_matches_jax(norm_type):
    """``PHMNorm`` for every norm type: the same flax names (``bn`` or
    ``qbn``), the training output, the running stats after one step, and the
    eval output after that step."""
    n, d = 120, 8
    x, mask, _, _, _ = _inputs(n, d, 12)
    jm = JaxPHMNorm(num_features=4 * d, phm_dim=4, norm_type=norm_type)
    v = numpy_tree(jm.init(jax.random.key(1), jnp.asarray(x), training=True,
                           mask=jnp.asarray(mask)))
    if norm_type == "q-batch-norm":
        v["params"]["qbn"] = _randomize_qbn(
            {"params": v["params"]["qbn"],
             "batch_stats": v["batch_stats"]["qbn"]}, 4)["params"]
    tm = load_flax(PHMNorm(4 * d, 4, norm_type), v)
    y, up = jm.apply(v, jnp.asarray(x), training=True, mask=jnp.asarray(mask),
                     mutable=["batch_stats"])
    got = tm(torch.from_numpy(x), training=True, mask=torch.from_numpy(mask))
    assert_close(got.detach(), np.asarray(y), TOL_MODULE)
    buffers = dict(tm.named_buffers())
    want_stats = numpy_tree(up["batch_stats"])
    sub = "qbn" if norm_type == "q-batch-norm" else "bn"
    assert set(buffers) == {f"{sub}.{k}" for k in want_stats[sub]}
    for k, arr in want_stats[sub].items():
        assert_leaf_close(buffers[f"{sub}.{k}"], arr, TOL_MODULE, k)
    v_after = {"params": v["params"], "batch_stats": want_stats}
    want_eval = jm.apply(v_after, jnp.asarray(x), training=False)
    with torch.no_grad():
        got_eval = tm(torch.from_numpy(x), training=False)
    assert_close(got_eval, np.asarray(want_eval), TOL_MODULE)


def test_q_batch_norm_needs_quaternions():
    with pytest.raises(ValueError, match="phm_dim=4"):
        PHMNorm(24, 2, "q-batch-norm")
    with pytest.raises(ValueError, match="unknown norm_type"):
        PHMNorm(24, 4, "layer-norm")
