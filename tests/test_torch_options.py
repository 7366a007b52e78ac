"""The model options and the algebra that the port added last, against the
JAX package on numpy inputs from seeds: ``unique_phm`` (one rule shared by
the whole network), the real transformer's 'sum', 'mean' and 'norm', the
quaternion gating activations, ``kron`` and ``batched_kron``, the
quaternion helpers and the layout bijection, the quaternion QR, and the
quaternion and orthogonal inits.

Tolerances, each with its reason:
- ``REL_OUT`` 1e-5 normwise: outputs and losses, f32 on both sides through
  two layers, summed in other orders (as ``tests/test_torch_train.py``);
  the eval forward ``REL_EVAL`` 1e-4, as ``tests/test_torch_model.py``.
- ``REL_GRAD`` 2e-5 per leaf of the leaf's max |grad|, as
  ``tests/test_torch_train.py``; the biases a batch norm follows (a zero
  gradient in exact arithmetic) are held to 1e-5 of the largest gradient.
- ``REL`` 1e-6 for the elementwise functions and small products in f32
  (a few roundings each), NaN where JAX gives NaN: the 2-norm's gradient at
  a zero vector, which the port follows.
- ``REL_F64`` 1e-12 for the QR in float64.
- The inits draw from two generators, so they are held on shape and
  distribution: per-component means within 4 standard errors of 0 on both
  sides, variances within ``VAR_REL`` 5 % of JAX's sample (40,000 draws a
  component: a sample variance's own spread is under 2 %), and the
  orthogonal init's stacked Q orthonormal to 1e-6 on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phc_gnn_tpu.data import synthetic_batch as jax_synthetic_batch
from phc_gnn_tpu.hypercomplex import inits as jinits
from phc_gnn_tpu.hypercomplex.kron import batched_kron as jax_batched_kron
from phc_gnn_tpu.hypercomplex.kron import kron as jax_kron
from phc_gnn_tpu.hypercomplex import layout as jlayout
from phc_gnn_tpu.hypercomplex import qr as jqr
from phc_gnn_tpu.hypercomplex import quaternion as jquat
from phc_gnn_tpu.models import PHCGNN as JaxPHCGNN
from phc_gnn_tpu.nn import activations as jact
from phc_gnn_tpu.nn import phm_linear as jlin
from phc_gnn_tpu.nn import regularization as jreg
from phc_gnn_tpu.train import loss as jloss
from phc_gnn_tpu.train.state import make_loss_and_aux
from phc_gnn_torch import hypercomplex as hc
from phc_gnn_torch.data import ZINC_ATOM_DIMS, ZINC_BOND_DIMS, synthetic_batch
from phc_gnn_torch.hypercomplex import qr
from phc_gnn_torch.models import PHCGNN
from phc_gnn_torch.nn import (RealTransformer, activations,
                              multiplication_rule_regularization)
from phc_gnn_torch.train import make_eval_step, make_loss_and_grads, masked_l1
from torch_parity import (assert_close, assert_leaf_close, load_flax,
                          numpy_tree, port_flat, randomize)
from torch_threads import one_torch_thread  # noqa: F401

REL_OUT = 1e-5
REL_EVAL = 1e-4
REL_GRAD = 2e-5
REL = 1e-6
REL_F64 = 1e-12
VAR_REL = 0.05
LR = 1e-3
WD = 0.1
WD2 = 0.1
SHAPE = (8, 256, 512)
GATES = ("qrelu_naive", "qrelu_naive2", "interaction_gate",
         "qrelu_interaction", "qswish_interaction")


def _config(dim=16, layers=2, **over):
    """The flagship configuration (bench.py:140-146) at width ``dim``,
    every dropout rate 0."""
    cfg = dict(phm_dim=4, atom_input_dims=ZINC_ATOM_DIMS,
               bond_input_dims=ZINC_BOND_DIMS, atom_encoded_dim=dim,
               mp_layers=(dim,) * layers, dropout_mpnn=(0.0,) * layers,
               downstream_layers=(dim, dim // 2), target_dim=1,
               dropout_dn=(0.0, 0.0), msg_aggr="softmax", mlp_mp=True,
               sc_type="last")
    cfg.update(over)
    return cfg


def _shift_invariant(key: str) -> bool:
    """Biases of the PHM layers that a batch norm follows."""
    return key.endswith(("transform.linear1.b", "transform.linear2.b")) or (
        key.startswith("downstream.affine_") and key.endswith(".b")
        and key != "downstream.affine_2.b")


def _close_nan(got: torch.Tensor, want, rel: float, name: str = ""):
    """Equal NaN patterns, the rest within ``rel`` of the largest |want|."""
    want = np.asarray(want, dtype=np.float64)
    got = got.detach().double().numpy()
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan), name
    scale = max(float(np.abs(np.where(nan, 0, want)).max()), 1e-30)
    err = float(np.abs(np.where(nan, 0, got - want)).max())
    assert err <= rel * scale, f"{name}: {err:.3g} > {rel * scale:.3g}"


def _vjp(torch_fn, jax_fn, x: np.ndarray, seed: int):
    """Outputs and input gradients of both functions for one cotangent."""
    xt = torch.tensor(x, requires_grad=True)
    out = torch_fn(xt)
    g = np.random.default_rng(seed).normal(size=out.shape).astype(np.float32)
    (gx,) = torch.autograd.grad(out, xt, torch.from_numpy(g))
    want, pull = jax.vjp(jax_fn, jnp.asarray(x))
    (wx,) = pull(jnp.asarray(g))
    return out, gx, np.asarray(want), np.asarray(wx)


def test_unique_phm_matches_jax():
    """One ``phm_rule_shared`` for the whole network: the converted model's
    eval forward, its training loss (with the weight and rule
    regularizations, which in both packages skip the shared rule) and the
    gradient of every parameter, the shared rule's included.  With
    ``learn_phm=False`` and a random rule (``c_init="random"``) no gradient
    reaches the rule, in JAX (a zero gradient) or the port (no leaf).  The
    convs sum their messages into the PHM MLP (``PHMGINEConv``): a softmax
    beta's gradient is a sum that cancels to ~5e-5 of itself in f32 on
    either side (ROADMAP §3), which says nothing of the shared rule."""
    jb = jax_synthetic_batch(*SHAPE, seed=5)
    tb = synthetic_batch(*SHAPE, seed=5)
    for learn, c_init in ((True, "standard"), (False, "random")):
        cfg = _config(unique_phm=True, learn_phm=learn, c_init=c_init,
                      msg_aggr="sum")
        jm = JaxPHCGNN(**cfg)
        v = randomize(jm.init(jax.random.key(0), jb, training=False), seed=5)
        assert v["params"]["phm_rule_shared"].shape == (4, 4, 4)
        model = load_flax(PHCGNN(**cfg, device="cpu"), v)
        assert not any(k.endswith(".phm_rule") for k in model.state_dict())
        assert_close(make_eval_step(model, device="cpu")(tb),
                     np.asarray(jm.apply(v, jb, training=False)), REL_EVAL)

        f = make_loss_and_aux(jm, lambda o, b: jloss.masked_l1(o, b.y), WD,
                              WD2, 2, v["batch_stats"], jb, None,
                              jnp.float32(LR))
        (want_loss, (want_out, _)), want = jax.value_and_grad(
            f, has_aux=True)(v["params"])
        want = port_flat(numpy_tree(want))
        model.train()
        loss, out, grads = make_loss_and_grads(
            model, lambda o, b: masked_l1(o, b.y), WD, WD2, 2)(tb, LR)
        assert_close(loss, np.float32(want_loss), REL_OUT)
        assert_close(out, np.asarray(want_out), REL_OUT)
        named = dict(model.named_parameters())
        assert float(multiplication_rule_regularization(named)) == float(
            jreg.multiplication_rule_regularization(v["params"]))
        if not learn:
            assert "phm_rule_shared" not in grads
            assert not np.any(want.pop("phm_rule_shared"))
            want = {k: w for k, w in want.items()
                    if named[k].requires_grad}
        assert set(grads) == set(want)
        top = max(float(np.abs(w).max()) for w in want.values())
        for key, g in grads.items():
            if _shift_invariant(key):
                assert float(g.abs().max()) <= 1e-5 * top, key
            else:
                assert_leaf_close(g, want[key], REL_GRAD, key)


@pytest.mark.parametrize("trafo", ["sum", "mean", "norm"])
def test_real_trafo_matches_jax(trafo):
    """The real transformer on [..., n*d], value and input gradient, a few
    component vectors all 0 (where the norm's gradient is NaN in JAX and in
    the port); then a whole model whose pooling and head end in it, eval
    forward against JAX."""
    x = np.random.default_rng(7).normal(size=(2, 6, 32)).astype(np.float32)
    x[0, 1, 0::8] = 0.0
    x[1, 4, 3::8] = 0.0
    jm = jlin.RealTransformer(trafo, 32, 4)
    v = jm.init(jax.random.key(0), jnp.asarray(x))
    out, gx, want, wx = _vjp(RealTransformer(trafo, 32, 4),
                             lambda a: jm.apply(v, a), x, seed=8)
    assert out.shape == want.shape == (2, 6, 8)
    _close_nan(out, want, REL, "value")
    _close_nan(gx, wx, REL, "gradient")
    assert np.isnan(wx).any() == (trafo == "norm")

    cfg = _config(real_trafo=trafo, downstream_layers=(16, 8), target_dim=3)
    jm = JaxPHCGNN(**cfg)
    jb = jax_synthetic_batch(*SHAPE, seed=6)
    v = randomize(jm.init(jax.random.key(1), jb, training=False), seed=6)
    model = load_flax(PHCGNN(**cfg, device="cpu"), v)
    got = make_eval_step(model, device="cpu")(synthetic_batch(*SHAPE, seed=6))
    assert got.shape == (SHAPE[0] + 1, 3)
    assert_close(got, np.asarray(jm.apply(v, jb, training=False)), REL_EVAL)


@pytest.mark.parametrize("name", GATES)
def test_gating_activation_matches_jax(name):
    """A quaternion gating activation on stacked [..., 4, d], value and
    input gradient; one quaternion is all 0 (the interaction gate's norm
    has JAX's NaN gradient there) and one row of components sums to 0
    exactly (the naive gate's threshold)."""
    x = np.random.default_rng(9).normal(size=(3, 5, 4, 12)).astype(np.float32)
    x[1, 2, :, 7] = 0.0
    x[2, 0, :, 1] = np.array([1.5, -0.5, -1.0, 0.0], np.float32)
    out, gx, want, wx = _vjp(getattr(activations, name),
                             getattr(jact, name), x, seed=10)
    assert out.shape == want.shape
    _close_nan(out, want, REL, "value")
    _close_nan(gx, wx, REL, "gradient")


def test_algebra_on_values_matches_jax():
    """``kron``, ``batched_kron``, every quaternion helper and the layout
    bijection, on the same f32 inputs."""
    rng = np.random.default_rng(11)

    def arr(*shape):
        return rng.normal(size=shape).astype(np.float32)

    jax_fns = {"kron": jax_kron, "batched_kron": jax_batched_kron}

    def both(fn, *xs):
        got = getattr(hc, fn)(*(torch.from_numpy(x) for x in xs))
        want = (jax_fns[fn] if fn in jax_fns else getattr(jquat, fn))(
            *(jnp.asarray(x) for x in xs))
        assert tuple(got.shape) == tuple(np.shape(want)), fn
        assert_close(got, np.asarray(want), REL)

    both("kron", arr(3, 4), arr(2, 5))
    both("batched_kron", arr(4, 3, 2), arr(4, 2, 5))
    q1, q2 = arr(2, 3, 4, 6), arr(2, 3, 4, 6)
    for fn in ("hamilton_product", "quaternion_dot"):
        both(fn, q1, q2)
    for fn in ("conjugate", "qnorm", "inverse", "normalize"):
        both(fn, q1)
    w = arr(4, 5, 6)
    both("real_matrix_representation", w)
    both("quaternion_matmul", w, arr(7, 4, 6))
    cm = hc.complex_matrix_representation(torch.from_numpy(w).double())
    np.testing.assert_allclose(
        cm.numpy(), jquat.complex_matrix_representation(w.astype(np.float64)),
        rtol=0, atol=REL_F64)
    flat = arr(5, 4 * 6)
    st = hc.to_stacked(torch.from_numpy(flat), 4)
    np.testing.assert_array_equal(st.numpy(),
                                  jlayout.to_stacked(jnp.asarray(flat), 4))
    np.testing.assert_array_equal(hc.to_flat(st).numpy(), flat)
    with pytest.raises(ValueError, match="components"):
        hc.to_stacked(torch.from_numpy(flat), 5)


def test_qr_matches_jax_in_float64():
    """The structure-preserving quaternion QR on float64 tensors against
    JAX's numpy module: the real representation, one Householder step,
    Q and R (tall and square), the Givens rotation and the QR with it."""
    rng = np.random.default_rng(12)
    for m, n in ((7, 4), (5, 5)):
        a = rng.normal(size=(4, m, n))
        np.testing.assert_allclose(qr.real_p(*a).numpy(), jqr.real_p(*a),
                                   rtol=0, atol=REL_F64)
        u, beta = qr.quat_householder(*a[:, :, 0], n=m)
        ju, jbeta = jqr.quat_householder(*a[:, :, 0], n=m)
        np.testing.assert_allclose(u.numpy(), ju, rtol=0, atol=REL_F64)
        assert abs(beta - jbeta) <= REL_F64 * abs(jbeta)
        for port_fn, jax_fn in ((qr.quat_qr, jqr.quat_qr),
                                (qr.quat_qr_givens, jqr.quat_qr_givens)):
            q, r = port_fn(*a)
            jq, jr = jax_fn(*a)
            assert q.dtype == r.dtype == torch.float64
            np.testing.assert_allclose(q.numpy(), jq, rtol=0, atol=1e-10)
            np.testing.assert_allclose(r.numpy(), jr, rtol=0, atol=1e-10)
    g = (0.3, -1.2, 0.7, 2.0)
    np.testing.assert_allclose(qr.grs_givens(*g).numpy(), jqr.grs_givens(*g),
                               rtol=0, atol=REL_F64)
    np.testing.assert_array_equal(qr.grs_givens(2.0, 0.0, 0.0, 0.0).numpy(),
                                  np.eye(4))


def test_inits_match_jax_in_distribution():
    """``quaternion_init``: (4, in, out), per-component means near 0 and
    variances as JAX's.  ``orthogonal_init``: (4, out, in) float32 for
    both orientations, and for out >= in the four components stacked
    (4 out, in) have orthonormal columns on both sides, per-component mean
    squares as JAX's."""
    for crit in ("glorot", "he"):
        got = hc.quaternion_init(torch.Generator().manual_seed(0), 200, 200,
                                 criterion=crit).numpy()
        want = np.asarray(jinits.quaternion_init(jax.random.key(0), 200,
                                                 200, criterion=crit))
        assert got.shape == want.shape == (4, 200, 200)
        assert got.dtype == np.float32
        for c in range(4):
            se = np.sqrt(want[c].var() / want[c].size)
            assert abs(got[c].mean()) <= 4 * se and abs(want[c].mean()) <= 4 * se
            assert abs(got[c].var() / want[c].var() - 1.0) <= VAR_REL, (crit, c)
    with pytest.raises(ValueError, match="criterion"):
        hc.quaternion_init(torch.Generator(), 4, 4, criterion="lecun")

    for fi, fo in ((6, 10), (10, 6), (8, 8)):
        got = hc.orthogonal_init(torch.Generator().manual_seed(1), fi, fo)
        want = np.asarray(jinits.orthogonal_init(jax.random.key(1), fi, fo))
        assert tuple(got.shape) == want.shape == (4, fo, fi)
        assert got.dtype == torch.float32
        if fo < fi:
            continue
        for w in (got.double().numpy(), want.astype(np.float64)):
            g = w.reshape(4 * fo, fi)
            np.testing.assert_allclose(g.T @ g, np.eye(fi), rtol=0, atol=1e-6)
        ms_got = (got.double().numpy() ** 2).mean(axis=(1, 2))
        ms_want = (want.astype(np.float64) ** 2).mean(axis=(1, 2))
        np.testing.assert_allclose(ms_got.sum(), ms_want.sum(), rtol=1e-6)
