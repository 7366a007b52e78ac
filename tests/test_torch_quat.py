"""The quaternion family with whitening batch norm against JAX: both presets
(``QuaternionSkipConnectAdd``, ``QuaternionSkipConnectConcat``) with
``norm_mp="q-batch-norm"``, the concat skip, ``PHMConvSoftmax`` and
``PHMConv`` with ``same_dim``, the converter and ``build_model``.

The configurations are the repository's whitening configurations
(scripts/bench_presets.py:29-46) at width 32 with 2 layers: phm_dim 4, ZINC
encoders, softmax aggregation with the MLP, ``sc_type`` "last" (add) or
"first" (concat), soft attention pooling, a (32, 16) -> 1 head with naive BN.
JAX runs its formula path of the whitening (the Pallas kernels are held to it
in tests/test_torch_whitening.py) and its XLA softmax composite (kernels A
and B are held to it in tests/test_torch_model.py); the port runs its CSR
plan through the kernels' plain versions on the CPU.  Every
dropout rate is 0 in the train step (the random streams differ, PARITY #10).

Tolerances, each with its reason:
- ``REL`` 1e-4 normwise for the eval forward (two layers of f32 GEMMs and
  whitening in other orders), as tests/test_torch_model.py.
- ``REL_OUT`` 1e-5 for the loss, outputs and running stats of one step.
- ``REL_GRAD`` 2e-5 per leaf of its own max, as tests/test_torch_train.py;
  the biases a norm follows have zero gradient in exact arithmetic (the
  whitening removes any shift) and are held to a noise bound; the frozen
  quaternion rule has no gradient in the port and zeros in JAX.
- ``REL_UPDATE`` 1e-5 on the Adam update given equal gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from phc_gnn_tpu.data import synthetic_batch as jax_synthetic_batch
from phc_gnn_tpu.graph import conv as jconv
from phc_gnn_tpu.models import presets as jpresets
from phc_gnn_tpu.train import loss as jloss
from phc_gnn_tpu.train import make_optimizer as jax_make_optimizer
from phc_gnn_tpu.train import make_train_step as jax_make_train_step
from phc_gnn_tpu.train.config import ExperimentConfig as JaxConfig
from phc_gnn_tpu.train.state import TrainState, make_loss_and_aux
from phc_gnn_tpu.train.trainer import build_model as jax_build_model
from phc_gnn_torch.convert import adam_state_from_optax, from_flax_variables
from phc_gnn_torch.data import (ATOM_FEATURE_DIMS, BOND_FEATURE_DIMS,
                                ZINC_ATOM_DIMS, ZINC_BOND_DIMS, synthetic_batch)
from phc_gnn_torch.graph import attach_csr_plan, conv
from phc_gnn_torch.models import presets
from phc_gnn_torch.train import (loss as tloss, make_eval_step,
                                 make_loss_and_grads, make_optimizer,
                                 make_train_step)
from phc_gnn_torch.train.config import ExperimentConfig
from phc_gnn_torch.train.trainer import build_model
from torch_parity import (assert_close, assert_leaf_close, assert_update,
                          load_flax, numpy_tree, port_flat, spd_cov)
from torch_threads import one_torch_thread  # noqa: F401

REL = 1e-4
REL_OUT = 1e-5
REL_GRAD = 2e-5
REL_UPDATE = 1e-5
LR = 1e-3
WD = 0.1
CLIP = 2.0
SHAPE = (8, 256, 512)
FAMILIES = {"add": ("QuaternionSkipConnectAdd", "last"),
            "concat": ("QuaternionSkipConnectConcat", "first")}


def _config(family, dim=32, layers=2, dropout=False):
    """bench_presets.py's ``build(family, "q-batch-norm")`` at width
    ``dim``; with ``dropout=False`` every rate is 0."""
    return dict(atom_input_dims=ZINC_ATOM_DIMS, bond_input_dims=ZINC_BOND_DIMS,
                atom_encoded_dim=dim, mp_layers=(dim,) * layers,
                dropout_mpnn=((0.1 if dropout else 0.0),) * layers,
                downstream_layers=(dim, dim // 2), target_dim=1,
                dropout_dn=(0.2, 0.1) if dropout else (0.0, 0.0),
                msg_aggr="softmax", mlp_mp=True, sc_type=FAMILIES[family][1],
                norm_mp="q-batch-norm", norm_dn="naive-batch-norm")


def _models(family, cfg):
    name = FAMILIES[family][0]
    return getattr(jpresets, name)(**cfg), getattr(presets, name)


def _init(jm, jb):
    return jax.jit(lambda b: jm.init(jax.random.key(0), b, training=False))(jb)


def randomize_quat(variables, seed):
    """Non-trivial eval state: BN mean ~ N(0, 0.3), var ~ U(0.5, 2), the
    whitening's running cov a random SPD 4x4 per feature, its Gamma 0.5 I +
    N(0, 0.1) and beta ~ N(0, 0.3), every conv's beta ~ U(0.5, 2.5)."""
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
            elif col == "batch_stats" and k == "cov":
                out[k] = spd_cov(rng, v.shape[-1])
            elif col == "params" and k == "beta" and v.ndim == 0:
                out[k] = np.float32(rng.uniform(0.5, 2.5))
            elif col == "params" and k in ("gamma", "beta"):
                out[k] = (v + rng.normal(0.0, 0.1 if k == "gamma" else 0.3,
                                         v.shape)).astype(np.float32)
            else:
                out[k] = v
        return out

    variables = numpy_tree(variables)
    return {col: walk(tree, col) for col, tree in variables.items()}


def _shift_invariant(key: str) -> bool:
    """Biases of the PHM layers that a norm follows: the MLP's ``linear1``
    (its whitening) and ``linear2`` (the layer's whitening), and the head's
    hidden layers (naive BN)."""
    return key.endswith(("transform.linear1.b", "transform.linear2.b")) or (
        key.startswith("downstream.affine_") and key.endswith(".b")
        and key != "downstream.affine_2.b")


@pytest.mark.parametrize("family", ["add", "concat"])
def test_quaternion_eval_forward_matches_jax(family):
    cfg = _config(family)
    jm, tcls = _models(family, cfg)
    jb = jax_synthetic_batch(*SHAPE, seed=3)
    tb = attach_csr_plan(synthetic_batch(*SHAPE, seed=3))
    v = randomize_quat(_init(jm, jb), 3)
    want = np.asarray(jax.jit(lambda v_, b: jm.apply(v_, b, training=False))(
        v, jb))
    model = load_flax(tcls(**cfg, device="cpu"), v)
    got = make_eval_step(model, device="cpu")(tb)
    assert got.shape == want.shape == (9, 1)
    assert_close(got, want, REL)


@pytest.fixture(scope="module", params=["add", "concat"])
def jax_run(request):
    """The JAX train step of one quaternion preset from randomised variables:
    the gradients at the start and after two steps, and the states after
    steps 1, 2 and 3."""
    family = request.param
    cfg = _config(family)
    jm, tcls = _models(family, cfg)
    jb = jax_synthetic_batch(*SHAPE, seed=3)
    v = randomize_quat(_init(jm, jb), 3)
    tx = jax_make_optimizer(LR, grad_clip=CLIP)
    loss_fn = lambda out, b: jloss.masked_l1(out, b.y)  # noqa: E731
    lr = jnp.float32(LR)
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    state0 = TrainState(
        params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray, v["batch_stats"]),
        opt_state=tx.init(params), rng=jax.random.key(1),
        step=jnp.zeros((), jnp.int32))

    @jax.jit
    def grads_at(state):
        f = make_loss_and_aux(jm, loss_fn, WD, 0.0, 2, state.batch_stats, jb,
                              state.rng, lr)
        return jax.grad(lambda p: f(p)[0])(state.params)

    step = jax_make_train_step(jm, tx, loss_fn, weight_decay=WD, donate=False)
    states, losses, outs = [state0], [], []
    for _ in range(3):
        s, loss, out = step(states[-1], jb, lr)
        states.append(s)
        losses.append(float(loss))
        outs.append(np.asarray(out))
    grads = [numpy_tree(grads_at(state0)), None,
             numpy_tree(grads_at(states[2]))]
    adam = [s.opt_state[1] for s in states]  # (clip, scale_by_adam, scale)
    return dict(cfg=cfg, tcls=tcls, variables=v, states=states, losses=losses,
                outs=outs, grads=grads, adam=adam)


def _variables(state):
    return numpy_tree({"params": state.params,
                       "batch_stats": state.batch_stats})


def _port_model(run, variables):
    model = run["tcls"](**run["cfg"], device="cpu")
    model.load_state_dict(from_flax_variables(variables, model))
    return model


def _loss_fn(out, batch):
    return tloss.masked_l1(out, batch.y)


def _batch():
    return attach_csr_plan(synthetic_batch(*SHAPE, seed=3))


def test_quaternion_train_step_matches_jax(jax_run):
    """One ``make_train_step`` step on the CPU: the loss, the output and the
    running stats (whitening mean and biased cov, the head's BN) after it."""
    model = _port_model(jax_run, jax_run["variables"])
    opt = make_optimizer(dict(model.named_parameters()), grad_clip=CLIP)
    step = make_train_step(model, opt, _loss_fn, weight_decay=WD,
                           device="cpu")
    loss, out = step(_batch(), LR)
    assert_close(loss, np.float32(jax_run["losses"][0]), REL_OUT)
    assert_close(out, jax_run["outs"][0], REL_OUT)
    want = port_flat(numpy_tree(jax_run["states"][1].batch_stats))
    got = dict(model.named_buffers())
    assert set(got) == set(want)
    assert any(k.endswith("qbn.cov") for k in got)
    for key, arr in want.items():
        assert_leaf_close(got[key], arr, REL_OUT, key)


@pytest.mark.parametrize("at", [0, 2])
def test_quaternion_gradients_match_jax(jax_run, at):
    """Every parameter's gradient, at the start and after two JAX steps;
    the frozen rules have none in the port and zeros in JAX."""
    model = _port_model(jax_run, _variables(jax_run["states"][at]))
    _, _, grads = make_loss_and_grads(model, _loss_fn, WD, 0.0, 2)(_batch(),
                                                                   LR)
    want = port_flat(jax_run["grads"][at])
    frozen = {k for k in want if k.endswith("phm_rule")}
    assert frozen and set(grads) == set(want) - frozen
    for key in frozen:
        assert not np.abs(want[key]).any(), key
    top = max(float(np.abs(w).max()) for w in want.values())
    for key, g in grads.items():
        if _shift_invariant(key):
            assert float(g.abs().max()) <= 1e-5 * top, key
            assert float(np.abs(want[key]).max()) <= 1e-5 * top, key
        else:
            assert_leaf_close(g, want[key], REL_GRAD, key)


def test_quaternion_third_step_from_carried_optax_state(jax_run):
    """The params, running stats and optax Adam state after two JAX steps go
    into the port: given JAX's gradients its update matches optax's on every
    leaf (the frozen rules stay put on both sides); with its own gradients
    the loss and the parameters after the step match JAX's."""
    states, adam = jax_run["states"], jax_run["adam"][2]
    mu, nu = numpy_tree(adam.mu), numpy_tree(adam.nu)
    model = _port_model(jax_run, _variables(states[2]))
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
    for key, p in model.named_parameters():
        assert_update(p, before[key], want[key], REL_UPDATE, key)

    model = _port_model(jax_run, _variables(states[2]))
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


@pytest.mark.parametrize("family", ["add", "concat"])
def test_converter_maps_every_quaternion_key(family):
    """Full width (200, 4 layers, bench_presets.py's widths; the concat
    convs take 200/400/400/400 and pooling 400): every flax leaf lands on a
    port entry of the same shape, the whitening as ``qbn.{gamma, beta,
    mean, cov}``."""
    cfg = _config(family, dim=200, layers=4, dropout=True)
    jm, tcls = _models(family, cfg)
    jb = jax_synthetic_batch(4, 128, 256, seed=0)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jb,
                                            training=False))
    v = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32),
                               shapes)
    model = tcls(**cfg, device="cpu")
    sd = from_flax_variables(v, model)
    n_leaves = sum(len(jax.tree_util.tree_leaves(v[c])) for c in v)
    assert len(sd) == n_leaves == len(model.state_dict())
    for key, ref in model.state_dict().items():
        assert sd[key].shape == ref.shape, key
    for i in range(4):
        for site in (f"norm_{i}.qbn", f"conv_{i}.conv.transform.norm.qbn"):
            assert sd[f"{site}.cov"].shape == (4, 4, 50)
            assert sd[f"{site}.gamma"].shape == (4, 4, 50)
    wide = 400 if family == "concat" else 200
    assert sd["pooling.real_trafo.affine.weight"].shape == (wide // 4, wide)
    for i in range(1, 4):
        assert sd[f"conv_{i}.conv.transform.linear1.W"].shape == (
            4, wide // 4, 50)
    model.load_state_dict(sd)


def _experiment(model_type):
    """The whitening configuration as an ``ExperimentConfig`` at width 32."""
    return dict(dataset="zinc", model_type=model_type, phm_dim=4,
                learn_phm=False, c_init="standard", input_embed_dim=32,
                mp_units=(32, 32), norm_mp="q-batch-norm", aggr_msg="softmax",
                mlp_mp=True, sc_type="last" if model_type == "add" else "first",
                d_units=(32, 16), dropout_mpnn=(0.1,), dropout_dn=(0.2, 0.1))


@pytest.mark.parametrize("model_type", ["add", "concat"])
def test_build_model_builds_both_families(model_type):
    """``train.trainer.build_model`` picks the family by ``model_type``: the
    port's model has the JAX model's every variable, of the same shape."""
    exp = _experiment(model_type)
    jm = jax_build_model(JaxConfig(**exp), ATOM_FEATURE_DIMS,
                         BOND_FEATURE_DIMS)
    model = build_model(ExperimentConfig(**exp), ATOM_FEATURE_DIMS,
                        BOND_FEATURE_DIMS, device="cpu")
    jb = jax_synthetic_batch(4, 128, 256, seed=0, num_node_feats=9,
                             num_edge_feats=3)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jb,
                                            training=False))
    v = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32),
                               shapes)
    sd = from_flax_variables(v, model)
    assert len(sd) == len(model.state_dict())
    assert model.concat == (model_type == "concat")
    assert not any(p.requires_grad for k, p in model.named_parameters()
                   if k.endswith("phm_rule"))


@pytest.mark.parametrize("variant,same_dim", [
    ("softmax", True), ("softmax", False), ("sum", False)])
def test_linear_convs_place_the_self_loop_by_same_dim(variant, same_dim):
    """``PHMConvSoftmax`` and ``PHMConv`` (mlp=False): ``transform(aggr) +
    x`` with ``same_dim``, ``transform(aggr + x)`` without, which lets the
    width change (24 -> 16 here), against the flax modules."""
    rng = np.random.default_rng(9)
    tb = attach_csr_plan(synthetic_batch(4, 128, 256, seed=9))
    jb = jax_synthetic_batch(4, 128, 256, seed=9)
    out_f = 24 if same_dim else 16
    x = rng.normal(size=(128, 24)).astype(np.float32)
    ea = rng.normal(size=(256, 24)).astype(np.float32)
    jm = jconv.PHMMessagePassing(24, out_f, 4, aggr=variant, mlp=False,
                                 same_dim=same_dim)
    args = (jnp.asarray(x), jb.senders, jb.receivers, jnp.asarray(ea),
            jb.edge_mask)
    v = numpy_tree(jm.init(jax.random.key(9), *args))
    if variant == "softmax":
        v["params"]["conv"]["beta"] = np.float32(1.7)
    want = np.asarray(jm.apply(v, *args))
    tm = load_flax(conv.PHMMessagePassing(24, out_f, 4, aggr=variant,
                                          mlp=False, same_dim=same_dim), v)
    for rowptr in (tb.rowptr, None):
        got = tm(torch.from_numpy(x), tb.senders, tb.receivers,
                 torch.from_numpy(ea), tb.edge_mask, rowptr=rowptr)
        assert_close(got.detach(), want, REL_OUT)
