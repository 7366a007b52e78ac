"""The PNA conv and model against JAX: ``PHMPNAConvSimple`` (1 and 2 post
layers) and the fixed-aggregation convs (``PHMConv``, ``PHMGINEConv`` with
mean, min and max) against flax with converted weights, and the PNA model of
the repository's ZINC PHC-4 recipe with ``--aggr_msg pna``
(benchmarks/run_script_zinc_phm4.sh over train_zinc.py: phm_dim 4, width 200,
4 layers, ``sc_type`` "last", soft attention pooling, a (128, 64) -> 1 head,
L1 loss, clip 2.0, lr 1e-3, no weight decay) at width 32 with 2 layers: its
eval forward, one train step (loss, gradients, running stats), the update
from a carried optax state, and the converter at full width.

JAX runs its streamed aggregators with a scan plan (``attach_scan_plan(...,
block_edges=128)``; the Pallas kernels in interpret mode on the CPU)
wherever the port runs its CSR plan, since the two routes split a tie at a
min or max differently (the aggregations themselves:
tests/test_torch_pna_plan.py and tests/test_torch_pna_composite.py).

Tolerances, each with its reason:
- ``REL`` 1e-5 normwise for the convs, as tests/test_torch_sum_aggr.py;
- ``REL_MODEL`` 1e-4 for the model's eval forward, as
  tests/test_torch_model.py;
- the train step as tests/test_torch_quat.py (``REL_OUT`` 1e-5,
  ``REL_STEP_GRAD`` 2e-5 per leaf, ``REL_UPDATE`` 1e-5), with chip_smoke.py's
  rule for a gradient leaf whose own f32 error is larger: the std
  aggregation's ``E[m^2] - E[m]^2`` cancels on lanes of small variance and
  ``d std / d var`` grows to 158 as var falls, so the leaves under a std (the
  first conv and the encoders) carry ~1e-4 of f32 rounding, measured against
  the same port in float64; such a leaf may differ from JAX by ``COND_GRAD``
  (10) times that error, up to ``GRAD_CAP`` (1e-3).
"""

import contextlib
import copy
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from phc_gnn_tpu.data import synthetic_batch as jax_synthetic_batch
from phc_gnn_tpu.graph import conv as jconv
from phc_gnn_tpu.models import PHCGNN as JaxPHCGNN
from phc_gnn_tpu.ops.stream_scan import STREAMED_AGGREGATORS, attach_scan_plan
from phc_gnn_tpu.train import loss as jloss
from phc_gnn_tpu.train import make_optimizer as jax_make_optimizer
from phc_gnn_tpu.train.state import (TrainState, apply_optimizer,
                                     make_loss_and_aux)
from phc_gnn_torch.convert import adam_state_from_optax, from_flax_variables
from phc_gnn_torch.data import ZINC_ATOM_DIMS, ZINC_BOND_DIMS, synthetic_batch
from phc_gnn_torch.graph import attach_csr_plan, conv
from phc_gnn_torch.models import PHCGNN
from phc_gnn_torch.ops import segment_reduce as sr
from phc_gnn_torch.train import (loss as tloss, make_eval_step,
                                 make_loss_and_grads, make_optimizer,
                                 make_train_step)
from torch_parity import (assert_close, assert_leaf_close, assert_update,
                          load_flax, numpy_tree, port_flat, randomize)
from torch_threads import one_torch_thread  # noqa: F401

REL = 1e-5
REL_MODEL = 1e-4
REL_OUT = 1e-5
REL_STEP_GRAD = 2e-5
COND_GRAD = 10.0
GRAD_CAP = 1e-3
REL_UPDATE = 1e-5
LR = 1e-3
CLIP = 2.0
SHAPE = (8, 256, 512)
AVG_DEG = {"lin": 2.2, "log": 1.15, "exp": 10.9}


def _graph_inputs(seed, width=32):
    jb = attach_scan_plan(jax_synthetic_batch(*SHAPE, seed=seed),
                          block_edges=128)
    tb = attach_csr_plan(synthetic_batch(*SHAPE, seed=seed))
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(jb.num_nodes, width)).astype(np.float32)
    ea = rng.normal(size=(jb.num_edges, width)).astype(np.float32)
    return jb, tb, x, ea


def _conv_against_flax(kw, seed, width=32):
    """The facade ``PHMMessagePassing(**kw)`` at phm_dim 4, eval mode, its
    output and the gradient of x against flax's with converted weights,
    JAX with its scan plan and the port with its CSR plan."""
    jb, tb, x, ea = _graph_inputs(seed, width)
    jm = jconv.PHMMessagePassing(width, width, 4, **kw)
    plan = (jb.scan_flags, jb.scan_cont, jb.last_edge,
            jb.snd_perm, jb.snd_flags, jb.snd_cont, jb.snd_last)
    args = (jnp.asarray(x), jb.senders, jb.receivers, jnp.asarray(ea),
            jb.edge_mask)
    v = randomize(jm.init(jax.random.key(seed), *args, training=False,
                          node_mask=jb.node_mask, scan_plan=plan), seed)
    want, vjp = jax.vjp(lambda x_: jm.apply(
        v, x_, *args[1:], training=False, node_mask=jb.node_mask,
        scan_plan=plan), jnp.asarray(x))
    g = np.random.default_rng(seed + 1).normal(size=want.shape).astype(
        np.float32)
    (dx_j,) = vjp(jnp.asarray(g))
    tm = load_flax(conv.PHMMessagePassing(width, width, 4, **kw), v)
    xt = torch.tensor(x, requires_grad=True)
    got = tm(xt, tb.senders, tb.receivers, torch.from_numpy(ea), tb.edge_mask,
             node_mask=tb.node_mask, rowptr=tb.rowptr, snd_perm=tb.snd_perm,
             snd_rowptr=tb.snd_rowptr)
    assert_close(got, np.asarray(want), REL)
    got.backward(torch.from_numpy(g))
    assert_close(xt.grad, np.asarray(dx_j), REL)
    return tm


@pytest.mark.parametrize("post_layers", [1, 2])
def test_pna_conv_matches_flax(post_layers):
    """``PHMPNAConvSimple`` through the facade (aggr="pna": the message
    encoder relu, no self loop) over the plan; with 2 post layers, the
    hardcoded naive batch norm ``post_norm_1`` whatever ``norm`` says.  (The
    composites without a plan: test_composite_aggregators_match_xla; the
    model without a plan: test_pna_eval_forward_matches_jax.)"""
    tm = _conv_against_flax(dict(aggr="pna", norm="q-batch-norm",
                                 avg_deg=AVG_DEG, post_layers=post_layers,
                                 msg_encoder="identity", mlp=True),
                            20 + post_layers)
    assert isinstance(tm.conv, conv.PHMPNAConvSimple)
    assert tm.conv.msg_encoder == "relu"
    keys = set(tm.state_dict())
    assert ("conv.post_norm_1.bn.var" in keys) == (post_layers == 2)
    assert tm.conv.post_0.W.shape == (4, 12 * 32 // 4, 32 // 4)


@pytest.mark.parametrize("aggr", ["mean", "min", "max"])
@pytest.mark.parametrize("mlp", [False, True])
def test_fixed_aggregation_convs_match_flax(aggr, mlp):
    """``PHMConv`` (mlp=False) and ``PHMGINEConv`` (mlp=True, with a batch
    norm) with mean, min and max over the plan."""
    tm = _conv_against_flax(dict(aggr=aggr, mlp=mlp, norm="naive-batch-norm"),
                            30 + mlp)
    assert isinstance(tm.conv, conv.PHMGINEConv if mlp else conv.PHMConv)


def _pna_config(dim=32, layers=2, dropout=False, avg_deg=None):
    """The ZINC PHC-4 recipe with ``--aggr_msg pna`` at width ``dim``; with
    ``dropout=False`` every rate is 0."""
    return dict(phm_dim=4, atom_input_dims=ZINC_ATOM_DIMS,
                bond_input_dims=ZINC_BOND_DIMS, atom_encoded_dim=dim,
                mp_layers=(dim,) * layers, dropout_mpnn=(0.0,) * layers,
                downstream_layers=(128, 64), target_dim=1,
                dropout_dn=(0.2, 0.1) if dropout else (0.0, 0.0),
                msg_aggr="pna", mlp_mp=True, sc_type="last",
                avg_deg=avg_deg or AVG_DEG)


def _jax_batch(seed=3):
    return attach_scan_plan(jax_synthetic_batch(*SHAPE, seed=seed),
                            block_edges=128)


def _port_batch(seed=3):
    return attach_csr_plan(synthetic_batch(*SHAPE, seed=seed))


def _init(jm, jb):
    return jax.jit(lambda b: jm.init(jax.random.key(0), b, training=False))(jb)


def test_pna_eval_forward_matches_jax():
    cfg = _pna_config()
    jm = JaxPHCGNN(**cfg)
    jb = jax_synthetic_batch(*SHAPE, seed=3)
    v = randomize(_init(jm, jb), seed=3)
    want = np.asarray(jax.jit(lambda v_, b: jm.apply(v_, b, training=False))(
        v, jb))
    model = load_flax(PHCGNN(**cfg, device="cpu"), v)
    got = make_eval_step(model, device="cpu")(_port_batch())
    assert got.shape == want.shape == (9, 1)
    assert_close(got, want, REL_MODEL)


def _shift_invariant(key: str) -> bool:
    """Biases that a batch norm follows, zero gradient in exact arithmetic:
    each conv's ``post_0`` (``norm_i``) and the head's hidden layers."""
    return key.endswith("conv.post_0.b") or (
        key.startswith("downstream.affine_") and key.endswith(".b")
        and key != "downstream.affine_2.b")


@pytest.fixture(scope="module")
def jax_run():
    """JAX's train step with its scan plan from randomised variables, twice:
    the body of ``make_train_step`` (state.py:86-104: ``make_loss_and_aux``,
    its value and gradient, ``apply_optimizer``) jitted once with the
    gradients returned too, so that the step and its gradients compile as
    one program.  The gradients at the start and after one step, and the
    states after steps 1 and 2."""
    cfg = _pna_config()
    jm = JaxPHCGNN(**cfg)
    jb = _jax_batch()
    v = randomize(_init(jm, jb), seed=3)
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
    def step(state):
        f = make_loss_and_aux(jm, loss_fn, 0.0, 0.0, 2, state.batch_stats, jb,
                              jax.random.fold_in(state.rng, state.step), lr)
        (loss, (out, stats)), grads = jax.value_and_grad(f, has_aux=True)(
            state.params)
        params, opt_state = apply_optimizer(tx, grads, state, lr)
        return state.replace(params=params, batch_stats=stats,
                             opt_state=opt_state,
                             step=state.step + 1), loss, out, grads

    states, losses, outs, grads = [state0], [], [], []
    for _ in range(2):
        s, loss, out, g = step(states[-1])
        states.append(s)
        losses.append(float(loss))
        outs.append(np.asarray(out))
        grads.append(numpy_tree(g))
    return dict(cfg=cfg, variables=v, states=states, losses=losses, outs=outs,
                grads=grads,
                adam=[s.opt_state[1] for s in states],
                var_positive=_jax_var_positive(jm, v, jb))


def _jax_var_positive(jm, variables, jb):
    """Where JAX's std aggregation takes relu's positive branch, ``var >
    0`` [N, D], per layer of its training forward from ``variables``: the
    model's loop (sc_type "last", no dropout) with each layer's messages
    handed to the streamed var as the conv hands them."""
    plan = (jb.scan_flags, jb.scan_cont, jb.last_edge, jb.snd_perm,
            jb.snd_flags, jb.snd_cont, jb.snd_last)

    def layers(module, g):
        atom = module.atomencoder(g.nodes)
        atom = atom.reshape(atom.shape[0], -1)
        x, out = atom, []
        for i, conv_i in enumerate(module.convs):
            e = module.bondencoders[i](g.edges)
            e = e.reshape(e.shape[0], -1)
            msgs = jconv._messages(x, g.senders, e, "relu", None, plan)
            out.append(STREAMED_AGGREGATORS["var"](
                msgs, g.receivers, *plan[:3], g.num_nodes, g.edge_mask) > 0)
            h = conv_i(x, g.senders, g.receivers, e, g.edge_mask, None,
                       training=True, node_mask=g.node_mask, scan_plan=plan)
            h = module.norms[i](h, training=True, mask=g.node_mask)
            x = jax.nn.relu(h) + x
        return out

    got, _ = jm.apply(variables, jb, method=layers, mutable=["batch_stats"])
    return [torch.from_numpy(np.asarray(m)) for m in got]


@contextlib.contextmanager
def _replayed_std(var_positive):
    """The port's std aggregations with ``var_positive`` in relu's place,
    one pattern per call in order: the GPU-vs-CPU rule of chip_smoke.py
    applied to JAX's pattern.  Where one framework's f32 var of a lane of
    near-equal messages rounds to the other side of 0 (its spread under
    ~3e-4 of the values, which layers past the first produce ~1e-7 apart
    in the two frameworks), d std / d var ~ 158 moves that lane's
    gradient by ~1e-2: a difference of the inputs' rounding, not of the
    arithmetic under test (test_std_gradient_at_the_relu_kink holds the
    kink itself)."""
    calls = iter(var_positive)

    def std(msgs, receivers, mask, rowptr, counts):
        var = sr.segment_var_aggregate(msgs, receivers, mask, rowptr, counts)
        return torch.sqrt(torch.where(next(calls), var, 0.0) + sr.STD_EPS)

    with mock.patch.object(conv, "segment_std_aggregate", std):
        yield


def _variables(state):
    return numpy_tree({"params": state.params,
                       "batch_stats": state.batch_stats})


def _port_model(run, variables):
    model = PHCGNN(**run["cfg"], device="cpu")
    model.load_state_dict(from_flax_variables(variables, model))
    return model


def _loss_fn(out, batch):
    return tloss.masked_l1(out, batch.y)


def test_pna_train_step_matches_jax(jax_run):
    """One dropout-free ``make_train_step`` step on the CPU: the loss, the
    output, the running stats after it and every parameter's gradient at the
    start (the biases a norm follows to a noise bound), with JAX's var > 0
    pattern in the std aggregations."""
    model = _port_model(jax_run, jax_run["variables"])
    exact = copy.deepcopy(model).double()
    batch = _port_batch()
    with _replayed_std(jax_run["var_positive"]):
        _, _, grads = make_loss_and_grads(model, _loss_fn)(batch, LR)
    with _replayed_std(jax_run["var_positive"]):
        _, _, e_grads = make_loss_and_grads(exact, _loss_fn)(
            batch.replace(y=batch.y.double()), LR)
    want = port_flat(jax_run["grads"][0])
    assert set(grads) == set(want)
    top = max(float(np.abs(w).max()) for w in want.values())
    for key, g in grads.items():
        if _shift_invariant(key):
            assert float(g.abs().max()) <= 1e-5 * top, key
            assert float(np.abs(want[key]).max()) <= 1e-5 * top, key
            continue
        own = float((g.double() - e_grads[key]).abs().max()) / float(
            e_grads[key].abs().max())
        assert_leaf_close(g, want[key], max(
            REL_STEP_GRAD, min(GRAD_CAP, COND_GRAD * own)), key)

    model = _port_model(jax_run, jax_run["variables"])
    opt = make_optimizer(dict(model.named_parameters()), grad_clip=CLIP)
    step = make_train_step(model, opt, _loss_fn, device="cpu")
    with _replayed_std(jax_run["var_positive"]):
        loss, out = step(_port_batch(), LR)
    assert_close(loss, np.float32(jax_run["losses"][0]), REL_OUT)
    assert_close(out, jax_run["outs"][0], REL_OUT)
    want = port_flat(numpy_tree(jax_run["states"][1].batch_stats))
    got = dict(model.named_buffers())
    assert set(got) == set(want)
    for key, arr in want.items():
        assert_leaf_close(got[key], arr, REL_OUT, key)


def test_pna_second_step_from_carried_optax_state(jax_run):
    """The params and the optax Adam state after one JAX step go into the
    port: given JAX's gradients there, its update matches optax's on every
    leaf."""
    states, adam = jax_run["states"], jax_run["adam"][1]
    model = _port_model(jax_run, _variables(states[1]))
    opt = make_optimizer(dict(model.named_parameters()), grad_clip=CLIP)
    opt.load_state(*adam_state_from_optax(adam.count, numpy_tree(adam.mu),
                                          numpy_tree(adam.nu), model))
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    tx = jax_make_optimizer(LR, grad_clip=CLIP)

    @jax.jit
    def updated(grads, opt_state, params):
        upd, _ = tx.update(grads, opt_state, params)
        return optax.apply_updates(
            params, jax.tree_util.tree_map(lambda u: LR * u, upd))

    want = port_flat(numpy_tree(updated(jax_run["grads"][1],
                                         states[1].opt_state,
                                         states[1].params)))
    jgrads = port_flat(jax_run["grads"][1])
    opt.step([torch.tensor(jgrads[k]) for k in opt.params], LR)
    for key, p in model.named_parameters():
        assert_update(p, before[key], want[key], REL_UPDATE, key)


def test_converter_maps_every_pna_key():
    """The recipe at full width (200, 4 layers): every flax leaf lands on a
    port entry of the same shape, the PNA convs' ``post_0`` taking
    4 aggregators x 3 scalers x 200 features."""
    cfg = _pna_config(dim=200, layers=4, dropout=True)
    jm = JaxPHCGNN(**cfg)
    jb = jax_synthetic_batch(4, 128, 256, seed=0)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jb,
                                            training=False))
    v = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32),
                               shapes)
    model = PHCGNN(**cfg, device="cpu")
    sd = from_flax_variables(v, model)
    n_leaves = sum(len(jax.tree_util.tree_leaves(v[c])) for c in v)
    assert len(sd) == n_leaves == len(model.state_dict())
    for key, ref in model.state_dict().items():
        assert sd[key].shape == ref.shape, key
    for i in range(4):
        assert sd[f"conv_{i}.conv.post_0.W"].shape == (4, 2400 // 4, 50)
        assert f"norm_{i}.bn.var" in sd
    model.load_state_dict(sd)
