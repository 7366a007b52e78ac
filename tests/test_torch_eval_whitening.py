"""The eval-mode quaternion whitening's backward against JAX.

JAX's eval path (phc_gnn_tpu/nn/norm.py:331-345) whitens with the running
mean and covariance, and ``jax.grad`` differentiates it in the input, Gamma
and beta; the running stats are batch stats and get no gradient.  The port's
``QuaternionWhiteningNorm`` in eval mode runs ``fused_whitening.
eval_whitening``: the running stats' Cholesky and K forward, and one launch
backward: the frozen variant of L (``dbeta``, ``dGamma``), writing ``dx = w
= L^{-T} Gamma^T g`` from its sweep where the input needs a gradient too, or
M's frozen variant alone where only the input does; their plain versions on
the CPU.  Held here: the module's eval gradients against ``jax.grad``
through the flax module in each of the three cases of that dispatch, the
frozen plain versions against autograd through the plain forward in
float64, and a quaternion preset's eval-mode parameter gradients
(fine-tuning with frozen running stats) against JAX's.

Tolerances: ``TOL_GRAD`` 1e-5 of each leaf's max (the same f32 formula,
summed over rows in another order); ``TOL_EXACT`` 1e-12 in float64 (the
closed form against autograd of the same forward); ``TOL_MODEL`` 2e-5 per
leaf for the preset's gradients, as tests/test_torch_quat.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phc_gnn_tpu.data import synthetic_batch as jax_synthetic_batch
from phc_gnn_tpu.models import presets as jpresets
from phc_gnn_tpu.nn.norm import QuaternionWhiteningNorm as JaxWhiteningNorm
from phc_gnn_torch.data import ZINC_ATOM_DIMS, ZINC_BOND_DIMS, synthetic_batch
from phc_gnn_torch.graph import attach_csr_plan
from phc_gnn_torch.models import presets
from phc_gnn_torch.nn.norm import QuaternionWhiteningNorm
from phc_gnn_torch.ops import fused_whitening as tfw
from torch_parity import assert_leaf_close, load_flax, numpy_tree, spd_cov
from torch_threads import one_torch_thread  # noqa: F401

TOL_GRAD = 1e-5
TOL_EXACT = 1e-12
TOL_MODEL = 2e-5
EPS = 1e-5


def _variables(d, seed):
    """Flax-shaped variables of one whitening norm: Gamma 0.5 I + N(0, 0.1),
    beta ~ N(0, 0.3), running mean ~ N(0, 0.3), a random SPD running cov."""
    rng = np.random.default_rng(seed)
    gamma = (0.5 * np.eye(4)[..., None] + rng.normal(size=(4, 4, d)) * 0.1)
    return {"params": {"gamma": gamma.astype(np.float32),
                       "beta": (rng.normal(size=(4, d)) * 0.3).astype(
                           np.float32)},
            "batch_stats": {"mean": (rng.normal(size=(4, d)) * 0.3).astype(
                                np.float32),
                            "cov": spd_cov(rng, d)}}


# whether x and (Gamma, beta) need a gradient, and the one wrapper call
# the backward makes for that: (its name, its with_dx)
DISPATCH = {"x and params": (True, True, ("wbn_bwd_sums", True)),
            "x only": (True, False, ("wbn_dx", None)),
            "params only": (False, True, ("wbn_bwd_sums", False))}


@pytest.mark.parametrize("case", list(DISPATCH))
@pytest.mark.parametrize("n,d,layout", [(96, 6, "flat"), (257, 13, "flat"),
                                        (64, 5, "stacked")])
def test_eval_whitening_gradients_match_jax(n, d, layout, case, monkeypatch):
    """dx, dGamma and dbeta of sum(y * g) in eval mode, each where it is
    asked for, through one call of the wrapper the dispatch picks."""
    need_x, need_p, (wrapper, with_dx) = DISPATCH[case]
    calls = []

    def spy(name):
        real = getattr(tfw, name)

        def spied(*args, **kwargs):
            calls.append((name, kwargs.get("with_dx")))
            return real(*args, **kwargs)
        return spied

    for name in ("wbn_bwd_sums", "wbn_dx"):
        monkeypatch.setattr(tfw, name, spy(name))
    rng = np.random.default_rng(n + d)
    shape = (n, 4 * d) if layout == "flat" else (n, 4, d)
    x = (rng.normal(size=shape) * 1.2 - 0.4).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    v = _variables(d, n)
    jm = JaxWhiteningNorm(num_features=d)

    def f(x_, params):
        y = jm.apply({"params": params, "batch_stats": v["batch_stats"]}, x_,
                     training=False)
        return jnp.sum(y * jnp.asarray(g))

    dx_j, dp_j = jax.grad(f, argnums=(0, 1))(
        jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, v["params"]))
    tm = load_flax(QuaternionWhiteningNorm(d), v)
    tm.gamma.requires_grad_(need_p)
    tm.beta.requires_grad_(need_p)
    xt = torch.tensor(x, requires_grad=need_x)
    y = tm(xt, training=False)
    assert y.shape == shape
    (y * torch.from_numpy(g)).sum().backward()
    assert calls == [(wrapper, with_dx)]
    if need_x:
        assert_leaf_close(xt.grad, np.asarray(dx_j), TOL_GRAD, "dx")
    else:
        assert xt.grad is None
    if need_p:
        assert_leaf_close(tm.gamma.grad, np.asarray(dp_j["gamma"]), TOL_GRAD,
                          "dgamma")
        assert_leaf_close(tm.beta.grad, np.asarray(dp_j["beta"]), TOL_GRAD,
                          "dbeta")
    else:
        assert tm.gamma.grad is None and tm.beta.grad is None
    assert tm.mean.grad is None and tm.cov.grad is None


def test_frozen_plain_versions_are_the_closed_form():
    """In float64, the frozen variants of L and M, and L's with dx,
    against autograd through K's plain version with the mean and L held
    fixed: dx = w on every row (no mean-path term, whatever rows a mask
    would mark), and dGamma, dbeta are the sums of the training variant.
    ``with_dx`` without ``frozen`` raises."""
    rng = np.random.default_rng(5)
    n, d = 70, 7
    x = torch.tensor(rng.normal(size=(n, 4 * d)), requires_grad=True)
    g = torch.tensor(rng.normal(size=(n, 4 * d)))
    v = _variables(d, 6)
    gamma = torch.tensor(v["params"]["gamma"], dtype=torch.float64,
                         requires_grad=True)
    beta = torch.tensor(v["params"]["beta"], dtype=torch.float64,
                        requires_grad=True)
    mean = torch.tensor(v["batch_stats"]["mean"], dtype=torch.float64)
    l = tfw.wbn_cholesky_plain(torch.tensor(v["batch_stats"]["cov"],
                                            dtype=torch.float64), EPS)
    y = tfw.wbn_transform_plain(x, mean, l, gamma, beta)
    (y * g).sum().backward()
    with torch.no_grad():
        dgamma, dbeta = tfw.wbn_bwd_sums(x, g, gamma, mean, l, frozen=True)
        dx = tfw.wbn_dx(x, g, None, gamma, mean, l, None, None, None,
                        frozen=True)
        full = tfw.wbn_bwd_sums(x, g, gamma, mean, l)
        fused = tfw.wbn_bwd_sums(x, g, gamma, mean, l, frozen=True,
                                 with_dx=True)
    assert len(fused) == 3
    for got, want in ((dx, x.grad), (dgamma, gamma.grad), (dbeta, beta.grad),
                      (dgamma, full[0]), (dbeta, full[1]),
                      (fused[0], gamma.grad), (fused[1], beta.grad),
                      (fused[2], x.grad)):
        assert_leaf_close(got, want.numpy(), TOL_EXACT)
    with pytest.raises(ValueError, match="frozen"):
        tfw.wbn_bwd_sums(x, g, gamma, mean, l, with_dx=True)


def test_eval_whitening_is_a_function_of_the_running_stats_alone():
    """The eval forward reads neither a mask nor the batch's statistics:
    whitening a batch and one of its rows gives that row the same output,
    and its gradient flows without a NaN where every row would be masked."""
    v = _variables(4, 7)
    tm = load_flax(QuaternionWhiteningNorm(4), v)
    x = torch.randn(12, 16, generator=torch.Generator().manual_seed(0))
    xt = x.clone().requires_grad_(True)
    y = tm(xt, training=False, mask=torch.zeros(12, dtype=torch.bool))
    torch.testing.assert_close(tm(x[5:6], training=False), y[5:6].detach())
    y.sum().backward()
    assert torch.isfinite(xt.grad).all() and torch.isfinite(tm.gamma.grad).all()


def _quat_config(dim=32, layers=2):
    """bench_presets.py's ``build("add", "q-batch-norm")`` at width ``dim``
    without dropout."""
    return dict(atom_input_dims=ZINC_ATOM_DIMS, bond_input_dims=ZINC_BOND_DIMS,
                atom_encoded_dim=dim, mp_layers=(dim,) * layers,
                dropout_mpnn=(0.0,) * layers, downstream_layers=(dim, dim // 2),
                target_dim=1, dropout_dn=(0.0, 0.0), msg_aggr="softmax",
                mlp_mp=True, sc_type="last", norm_mp="q-batch-norm",
                norm_dn="naive-batch-norm")


def _randomize(v, seed):
    rng = np.random.default_rng(seed)

    def walk(tree, col):
        out = {}
        for k, leaf in tree.items():
            if hasattr(leaf, "items"):
                out[k] = walk(leaf, col)
            elif col == "batch_stats" and k == "cov":
                out[k] = spd_cov(rng, leaf.shape[-1])
            elif col == "batch_stats" and k == "mean":
                out[k] = rng.normal(0.0, 0.3, leaf.shape).astype(np.float32)
            elif col == "batch_stats" and k == "var":
                out[k] = rng.uniform(0.5, 2.0, leaf.shape).astype(np.float32)
            else:
                out[k] = leaf
        return out

    return {col: walk(tree, col) for col, tree in numpy_tree(v).items()}


def test_quaternion_preset_eval_gradients_match_jax():
    """Fine-tuning with frozen running stats: every parameter's gradient of
    the L1 loss of the eval forward of ``QuaternionSkipConnectAdd`` (8
    whitening sites), the port with its CSR plan on the CPU."""
    cfg = _quat_config()
    jm = jpresets.QuaternionSkipConnectAdd(**cfg)
    jb = jax_synthetic_batch(8, 256, 512, seed=4)
    v = _randomize(jax.jit(lambda b: jm.init(jax.random.key(0), b,
                                             training=False))(jb), 4)
    y = jnp.nan_to_num(jb.y)
    gm = jb.graph_mask[:, None]

    def loss(params):
        out = jm.apply({"params": params, "batch_stats": v["batch_stats"]},
                       jb, training=False)
        return jnp.sum(jnp.abs(out - y) * gm) / jnp.sum(gm)

    want = numpy_tree(jax.jit(jax.grad(loss))(
        jax.tree_util.tree_map(jnp.asarray, v["params"])))
    model = load_flax(presets.QuaternionSkipConnectAdd(**cfg, device="cpu"),
                      v)
    tb = attach_csr_plan(synthetic_batch(8, 256, 512, seed=4))
    out = model(tb, training=False)
    tm = tb.graph_mask[:, None]
    ((out - torch.nan_to_num(tb.y)).abs() * tm).sum().div(tm.sum()).backward()
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
        key = ".".join(p.key for p in path)
        if key.endswith(".kernel"):
            key, leaf = key[:-len("kernel")] + "weight", leaf.T
        flat[key] = leaf
    n_qbn = 0
    for key, p in model.named_parameters():
        if not p.requires_grad:
            continue
        n_qbn += key.endswith("qbn.gamma")
        assert_leaf_close(p.grad, flat[key], TOL_MODEL, key)
    assert n_qbn == 2 * 2  # two whitening sites a layer, in the MLP and after
