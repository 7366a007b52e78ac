"""The port's training path against the JAX reference: the whole train step,
the losses, the regularization, the optimizer, dropout and the entry points.

The JAX side runs its flagship model at width 32 with 2 layers on
``synthetic_batch(8, 256, 512)`` with the scan plan: the Pallas kernels A, B
and C in interpret mode, and D and E forced into interpret mode through
``nn.norm._FORCE_FUSED_INTERPRET``.  Every dropout rate is 0, because the
two frameworks' random streams cannot match (PARITY #10).  The JAX step is
built and run once per file (a module-scoped fixture).

Tolerances, each with its reason:
- ``REL_OUT`` 1e-5 normwise: loss and outputs, f32 on both sides through two
  layers, summed in other orders (measured ~1e-6).
- ``REL_GRAD`` 2e-5 per leaf, scaled by the leaf's own max |grad|: the same
  arithmetic through forward and backward (measured <= 4e-6).  The bias of a
  PHM layer that a batch norm follows has a zero gradient in exact
  arithmetic (the norm removes any shift), so both sides return rounding
  noise; those leaves are held to |grad| <= 1e-5 of the largest gradient
  instead, and Adam turns such noise into updates of +-lr whose sign neither
  side controls, so their parameters are compared only where the port's
  optimizer is fed JAX's gradients.
- ``REL_UPDATE`` 1e-5 per leaf on the update given equal gradients: the same
  formula, elementwise in f32; read from the parameters, each side's f32
  rounding of ``p - lr * u`` adds up to 1 ulp of ``max |p|`` (``assert_update``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from phc_gnn_tpu.data import synthetic_batch as jax_synthetic_batch
from phc_gnn_tpu.models import PHCGNN as JaxPHCGNN
from phc_gnn_tpu.nn import regularization as jreg
from phc_gnn_tpu.nn.dropout import phm_dropout as jax_phm_dropout
from phc_gnn_tpu.ops.stream_scan import attach_scan_plan
from phc_gnn_tpu.train import loss as jloss
from phc_gnn_tpu.train import make_optimizer as jax_make_optimizer
from phc_gnn_tpu.train import make_train_step as jax_make_train_step
from phc_gnn_tpu.train.optim import ReduceLROnPlateau as JaxPlateau
from phc_gnn_tpu.train.state import TrainState, make_loss_and_aux
from phc_gnn_torch.convert import adam_state_from_optax, from_flax_variables
from phc_gnn_torch.data import ZINC_ATOM_DIMS, ZINC_BOND_DIMS, synthetic_batch
from phc_gnn_torch.graph import attach_csr_plan, conv
from phc_gnn_torch.models import PHCGNN
from phc_gnn_torch.nn import (multiplication_rule_regularization, phm_dropout,
                              phm_weight_regularization)
from phc_gnn_torch.train import (ReduceLROnPlateau, loss as tloss,
                                 make_loss_and_grads, make_optimizer,
                                 make_train_step)
from torch_parity import (assert_close, assert_leaf_close, assert_update,
                          numpy_tree, port_flat, randomize)
from torch_threads import one_torch_thread  # noqa: F401

REL_OUT = 1e-5
REL_GRAD = 2e-5
REL_UPDATE = 1e-5
LR = 1e-3
WD = 0.1
CLIP = 2.0
SHAPE = (8, 256, 512)


def _config(dim=32, layers=2):
    """The flagship configuration (bench.py:140-146) at width ``dim``, with
    every dropout rate 0."""
    return dict(phm_dim=4, atom_input_dims=ZINC_ATOM_DIMS,
                bond_input_dims=ZINC_BOND_DIMS, atom_encoded_dim=dim,
                mp_layers=(dim,) * layers, dropout_mpnn=(0.0,) * layers,
                downstream_layers=(dim, dim // 2), target_dim=1,
                dropout_dn=(0.0, 0.0), msg_aggr="softmax", mlp_mp=True,
                sc_type="last")


def _shift_invariant(key: str) -> bool:
    """Biases of the PHM layers that a batch norm follows: the MLP's
    ``linear1`` (its norm) and ``linear2`` (the layer's norm), and the
    downstream head's hidden layers."""
    return key.endswith(("transform.linear1.b", "transform.linear2.b")) or (
        key.startswith("downstream.affine_") and key.endswith(".b")
        and key != "downstream.affine_2.b")


@pytest.fixture(scope="module")
def jax_run():
    """The JAX train step from randomised variables: the gradients at the
    start and after two steps, and the states after steps 1, 2 and 3."""
    cfg = _config()
    jm = JaxPHCGNN(**cfg)
    jb = attach_scan_plan(jax_synthetic_batch(*SHAPE, seed=3))
    v = randomize(jm.init(jax.random.key(0), jb, training=False), seed=3)
    tx = jax_make_optimizer(LR, grad_clip=CLIP)
    loss_fn = lambda out, b: jloss.masked_l1(out, b.y)  # noqa: E731
    lr = jnp.float32(LR)
    with pytest.MonkeyPatch.context() as mp:
        import phc_gnn_tpu.nn.norm as jnorm
        mp.setattr(jnorm, "_FORCE_FUSED_INTERPRET", True)
        params = jax.tree_util.tree_map(jnp.asarray, v["params"])
        state0 = TrainState(
            params=params,
            batch_stats=jax.tree_util.tree_map(jnp.asarray, v["batch_stats"]),
            opt_state=tx.init(params), rng=jax.random.key(1),
            step=jnp.zeros((), jnp.int32))

        @jax.jit
        def grads_at(state):
            f = make_loss_and_aux(jm, loss_fn, WD, 0.0, 2, state.batch_stats,
                                  jb, state.rng, lr)
            (loss, (out, _)), g = jax.value_and_grad(f, has_aux=True)(
                state.params)
            return loss, out, g

        step = jax_make_train_step(jm, tx, loss_fn, weight_decay=WD,
                                   donate=False)
        states, losses, outs = [state0], [], []
        for _ in range(3):
            s, loss, out = step(states[-1], jb, lr)
            states.append(s)
            losses.append(float(loss))
            outs.append(np.asarray(out))
        grads0 = numpy_tree(grads_at(state0)[2])
        grads2 = numpy_tree(grads_at(states[2])[2])
    adam = [s.opt_state[1] for s in states]  # (clip, scale_by_adam, scale)
    return dict(cfg=cfg, variables=v, states=states, losses=losses, outs=outs,
                grads=[grads0, None, grads2], adam=adam)


def _variables(state):
    return numpy_tree({"params": state.params,
                       "batch_stats": state.batch_stats})


def _port_model(cfg, variables):
    model = PHCGNN(**cfg, device="cpu")
    model.load_state_dict(from_flax_variables(variables, model))
    return model


def _loss_fn(out, batch):
    return tloss.masked_l1(out, batch.y)


def _batch():
    return attach_csr_plan(synthetic_batch(*SHAPE, seed=3))


def test_train_step_matches_jax(jax_run):
    """One ``make_train_step`` step on the CPU: the loss, the output and the
    running stats after it."""
    model = _port_model(jax_run["cfg"], jax_run["variables"])
    opt = make_optimizer(dict(model.named_parameters()), grad_clip=CLIP)
    step = make_train_step(model, opt, _loss_fn, weight_decay=WD,
                           device="cpu")
    loss, out = step(_batch(), LR)
    assert loss.device.type == "cpu" and loss.ndim == 0
    assert_close(loss, np.float32(jax_run["losses"][0]), REL_OUT)
    assert_close(out, jax_run["outs"][0], REL_OUT)
    want = port_flat(numpy_tree(jax_run["states"][1].batch_stats))
    got = dict(model.named_buffers())
    assert set(got) == set(want)
    for key, arr in want.items():
        assert_leaf_close(got[key], arr, REL_OUT, key)


@pytest.mark.parametrize("at", [0, 2])
def test_train_step_gradients_match_jax(jax_run, at):
    """Every parameter's gradient, at the start and after two JAX steps."""
    model = _port_model(jax_run["cfg"], _variables(jax_run["states"][at]))
    loss_and_grads = make_loss_and_grads(model, _loss_fn, WD, 0.0, 2)
    _, _, grads = loss_and_grads(_batch(), LR)
    want = port_flat(jax_run["grads"][at])
    assert set(grads) == set(want)
    top = max(float(np.abs(w).max()) for w in want.values())
    for key, g in grads.items():
        if _shift_invariant(key):
            assert float(g.abs().max()) <= 1e-5 * top, key
            assert float(np.abs(want[key]).max()) <= 1e-5 * top, key
        else:
            assert_leaf_close(g, want[key], REL_GRAD, key)


def test_third_step_from_carried_optax_state(jax_run):
    """The port continues a JAX run: the params, running stats and optax Adam
    state after two JAX steps go into the port, which takes the third step.
    Given the same gradients, its update matches optax's on every leaf; with
    its own gradients, the parameters after the step match JAX's on every
    leaf whose gradient is not rounding noise."""
    cfg, states = jax_run["cfg"], jax_run["states"]
    adam = jax_run["adam"][2]
    mu, nu = numpy_tree(adam.mu), numpy_tree(adam.nu)
    assert int(adam.count) == 2

    model = _port_model(cfg, _variables(states[2]))
    opt = make_optimizer(dict(model.named_parameters()), grad_clip=CLIP)
    opt.load_state(*adam_state_from_optax(adam.count, mu, nu, model))
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    tx = jax_make_optimizer(LR, grad_clip=CLIP)
    upd, _ = tx.update(jax_run["grads"][2], states[2].opt_state,
                       states[2].params)
    want = port_flat(numpy_tree(optax.apply_updates(
        states[2].params, jax.tree_util.tree_map(lambda u: LR * u, upd))))
    jgrads = port_flat(jax_run["grads"][2])
    opt.step([torch.tensor(jgrads[k]) for k in opt.params], LR)
    assert opt.count == 3
    for key, p in model.named_parameters():
        assert_update(p, before[key], want[key], REL_UPDATE, key)

    model = _port_model(cfg, _variables(states[2]))
    opt = make_optimizer(dict(model.named_parameters()), grad_clip=CLIP)
    opt.load_state(*adam_state_from_optax(adam.count, mu, nu, model))
    step = make_train_step(model, opt, _loss_fn, weight_decay=WD,
                           device="cpu")
    loss, _ = step(_batch(), LR)
    assert_close(loss, np.float32(jax_run["losses"][2]), REL_OUT)
    want = port_flat(numpy_tree(states[3].params))
    for key, p in model.named_parameters():
        if not _shift_invariant(key):
            assert_leaf_close(p.detach(), want[key], REL_OUT, key)


def _grad_tree(rng, scale):
    """A flax-shaped tree of random leaves times ``scale``."""
    tree = {"conv_0": {"conv": {"beta": np.float32(rng.normal()),
                                "transform": {"linear1": {
                                    "W": rng.normal(size=(4, 3, 5)),
                                    "b": rng.normal(size=(20,))}}}},
            "pooling": {"real_trafo": {"affine": {
                "kernel": rng.normal(size=(8, 2)),
                "bias": rng.normal(size=(2,))}}}}
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a * scale, np.float32), tree)


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("scale", [1.0, 1e-3])
def test_optimizer_matches_optax(carried, scale):
    """The same gradients into the port's Adam and optax's
    ``make_optimizer(grad_clip=2.0)``: a global norm above the clip (scale
    1, norm ~8) and below it (scale 1e-3), from a fresh state and from an
    optax state carried over after two steps."""
    rng = np.random.default_rng(int(carried) * 10 + int(scale == 1.0))
    params = _grad_tree(rng, 1.0)
    grads = [_grad_tree(rng, scale) for _ in range(3)]
    norm = float(optax.global_norm(grads[-1]))
    assert (norm > CLIP) == (scale == 1.0)
    tx = jax_make_optimizer(LR, grad_clip=CLIP)

    def apply(jparams, state, g):
        upd, state = tx.update(g, state, jparams)
        return optax.apply_updates(
            jparams, jax.tree_util.tree_map(lambda u: LR * u, upd)), state

    jparams, state = params, tx.init(params)
    if carried:
        for g in grads[:2]:
            jparams, state = apply(jparams, state, g)
    start = port_flat(numpy_tree(jparams))
    want = port_flat(numpy_tree(apply(jparams, state, grads[-1])[0]))

    port = {k: torch.tensor(v, requires_grad=True) for k, v in start.items()}
    opt = make_optimizer(port, grad_clip=CLIP)
    if carried:
        adam = state[1]  # (clip, scale_by_adam, scale)
        moments = [{k: torch.tensor(v) for k, v in
                    port_flat(numpy_tree(t)).items()}
                   for t in (adam.mu, adam.nu)]
        opt.load_state(int(adam.count), *moments)
    g = port_flat(grads[-1])
    opt.step([torch.tensor(g[k]) for k in opt.params], LR)
    for key, p in port.items():
        assert_update(p, torch.tensor(start[key]), want[key], REL_UPDATE,
                      key)


@pytest.mark.parametrize("name", ["masked_l1", "masked_mse",
                                  "masked_bce_with_logits"])
def test_masked_losses_match_jax(name):
    """Values and gradients, with NaN targets masked out."""
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(9, 3)).astype(np.float32) * 3
    targets = rng.normal(size=(9, 3)).astype(np.float32)
    if name == "masked_bce_with_logits":
        targets = (targets > 0).astype(np.float32)
    targets[rng.random((9, 3)) < 0.3] = np.nan
    targets[-1] = np.nan
    jfn, tfn = getattr(jloss, name), getattr(tloss, name)
    want, want_g = jax.value_and_grad(jfn)(jnp.asarray(logits),
                                           jnp.asarray(targets))
    x = torch.tensor(logits, requires_grad=True)
    got = tfn(x, torch.from_numpy(targets))
    got.backward()
    assert_leaf_close(got.detach(), np.asarray(want), 1e-6, name)
    assert_leaf_close(x.grad, np.asarray(want_g), 1e-6, name)


def test_masked_cross_entropy_matches_jax():
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(7, 4)).astype(np.float32) * 2
    labels = rng.integers(0, 4, size=7).astype(np.int32)
    gmask = np.array([1, 1, 0, 1, 1, 1, 0], bool)
    want, want_g = jax.value_and_grad(jloss.masked_cross_entropy)(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(gmask))
    x = torch.tensor(logits, requires_grad=True)
    got = tloss.masked_cross_entropy(x, torch.from_numpy(labels),
                                     torch.from_numpy(gmask))
    got.backward()
    assert_leaf_close(got.detach(), np.asarray(want), 1e-6)
    assert_leaf_close(x.grad, np.asarray(want_g), 1e-6)


@pytest.mark.parametrize("kind,p", [("weight", 1), ("weight", 2),
                                    ("rule", 1), ("rule", 2)])
def test_regularization_matches_jax(kind, p):
    """Over every ``W`` / ``phm_rule`` of the model, values and gradients."""
    cfg = _config(dim=16)
    jm = JaxPHCGNN(**cfg)
    jb = jax_synthetic_batch(4, 128, 256, seed=0)
    v = numpy_tree(jm.init(jax.random.key(2), jb, training=False))
    jfn = (jreg.phm_weight_regularization if kind == "weight"
           else jreg.multiplication_rule_regularization)
    tfn = (phm_weight_regularization if kind == "weight"
           else multiplication_rule_regularization)
    want, want_g = jax.value_and_grad(lambda t: jfn(t, p=p))(
        jax.tree_util.tree_map(jnp.asarray, v["params"]))
    model = _port_model(cfg, v)
    params = dict(model.named_parameters())
    got = tfn(params, p=p)
    got.backward()
    assert_leaf_close(got.detach(), np.asarray(want), 1e-6)
    want_g = port_flat(numpy_tree(want_g))
    leaf = "W" if kind == "weight" else "phm_rule"
    for key, t in params.items():
        if key.rsplit(".", 1)[-1] == leaf:
            assert_leaf_close(t.grad, want_g[key], 1e-5, key)
        else:
            assert t.grad is None, key


@pytest.mark.parametrize("same", [False, True])
def test_dropout_keep_share_and_scaling(same):
    """Statistically, as the RNG streams differ: the keep share is 1 - p
    within 5 standard errors, kept entries are x / (1 - p), and with
    ``same=True`` one mask is shared by the n components; JAX's dropout
    passes the same checks."""
    n, d, rows, p = 4, 50, 400, 0.3
    x = torch.rand(rows, n * d) + 0.5  # no zeros, so a zero means dropped
    gen = torch.Generator().manual_seed(0)
    y = phm_dropout(x, p, n, gen, training=True, same=same)
    jy = np.asarray(jax_phm_dropout(jax.random.key(0), jnp.asarray(x.numpy()),
                                    p, n, training=True, same=same))
    for out in (y.numpy(), jy):
        kept = out != 0
        share = kept.mean()
        samples = rows * d if same else rows * n * d
        assert abs(share - (1 - p)) < 5 * np.sqrt(p * (1 - p) / samples)
        np.testing.assert_allclose(out[kept], x.numpy()[kept] / (1 - p),
                                   rtol=1e-6)
        comps = kept.reshape(rows, n, d)
        shared = bool((comps == comps[:, :1]).all())
        assert shared == same
    assert phm_dropout(x, p, n, gen, training=False) is x
    assert phm_dropout(x, 0.0, n, None, training=True) is x
    with pytest.raises(ValueError, match="Generator"):
        phm_dropout(x, p, n, None, training=True)
    with pytest.raises(ValueError, match=r"\[0, 1\]"):
        phm_dropout(x, 1.5, n, gen)


def test_reduce_lr_on_plateau_matches_jax():
    metrics = [0.5, 0.6, 0.6, 0.59, 0.6, 0.61, 0.3, 0.3, 0.2, 0.9, -0.1,
               -0.1, -0.1]
    for mode in ("max", "min"):
        ref = JaxPlateau(lr=1e-3, mode=mode, factor=0.5, patience=1)
        got = ReduceLROnPlateau(lr=1e-3, mode=mode, factor=0.5, patience=1)
        for m in metrics:
            assert got.step(m) == ref.step(m)


def test_train_entry_points_need_cuda_or_a_plan(monkeypatch):
    """``make_train_step`` raises without CUDA unless ``device="cpu"``; a
    gather off the CPU that needs a gradient raises without the sender plan
    (a ``meta`` tensor stands in for a CUDA one here); the optimizer must be
    built on the model's own parameters."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = PHCGNN(**_config(), device="cpu")
    opt = make_optimizer(dict(model.named_parameters()))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_train_step(model, opt, _loss_fn)
    other = PHCGNN(**_config(), device="cpu")
    with pytest.raises(ValueError, match="not built on this model"):
        make_train_step(model, make_optimizer(dict(other.named_parameters())),
                        _loss_fn, device="cpu")
    step = make_train_step(model, opt, _loss_fn, device="cpu")
    loss, out = step(attach_csr_plan(synthetic_batch(4, 128, 256)), LR)
    assert torch.isfinite(loss) and out.shape == (5, 1)

    x = torch.empty(6, 8, device="meta", requires_grad=True)
    senders = torch.empty(10, dtype=torch.int32, device="meta")
    edge_attr = torch.empty(10, 8, device="meta")
    with pytest.raises(ValueError, match="sender plan"):
        conv._messages(x, senders, edge_attr, "identity")
