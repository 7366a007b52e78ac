"""The molpcba PHC-2 configuration of the port against the JAX reference:
the model, built by name from the configuration, its serving forward, its
training forward and the accumulated train step.

The configuration is ``benchmarks/run_script_pcba_phm2.sh`` on top of
``DATASET_DEFAULTS["pcba"]``: ``phm_dim=2``, ``PHMConv`` with sum
aggregation (``mlp_mp=False``), naive batch norm, ``sc_type="first"``, OGB
atom and bond encoders (9 and 3 features), a (768, 256) head and 128 tasks
under a masked BCE.  Here it is narrowed to 3 layers at width 16, a (32, 16)
head and 8 tasks, on ``synthetic_batch(8, 256, 512)`` graphs with 9 atom and
3 bond features and 0/1 labels with a share missing (NaN), as molpcba has.
The converter is checked at the full widths.

The JAX side runs its scan plans (Pallas kernel C in interpret mode) and its
fused batch norms in interpret mode (``_FORCE_FUSED_INTERPRET``); both
sides' size gate is lowered to 8,192 bytes, so that the convs' norms ([256,
2, 8], 16 KB) take the row-blocked family (F and G) as pcba's [4096, 2,
256] does, and the head's stay on the single-block pair, as at full size.
Every dropout rate is 0, because the two frameworks' random streams cannot
match (PARITY #10).

Tolerances, each with its reason:
- ``REL_OUT`` 1e-5 normwise for outputs and losses, per leaf for running
  stats: f32 on both sides through three layers, sums in other orders.
- ``REL_EVAL`` 1e-4 normwise for the eval forward, as the flagship's
  (``tests/test_torch_model.py``).
- ``REL_GRAD`` 2e-5 per leaf, scaled by the leaf's own max |grad|, as the
  flagship's; the biases that a batch norm follows (each conv's
  ``transform.b`` and the head's hidden layers) have a zero gradient in
  exact arithmetic and are held to 1e-5 of the largest gradient instead.
- ``REL_UPDATE`` 3e-5 of a leaf's largest step on the Adam update given
  equal gradients, at optax's second step: optax forms ``1 - 0.999^t`` in
  f32, which at t = 2 is off by 1.3e-5 of itself, and the step by half that
  plus rounding (measured 1.02e-5 on ``norm_0.bn.bias``, whose float64
  update the port's matches to 2e-7).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import phc_gnn_tpu.nn.norm as jnorm
import phc_gnn_tpu.ops.fused_bn as jfused
from phc_gnn_tpu.data import synthetic_batch as jax_synthetic_batch
from phc_gnn_tpu.data.features import (ATOM_FEATURE_DIMS as J_ATOM,
                                       BOND_FEATURE_DIMS as J_BOND)
from phc_gnn_tpu.models import PHCGNN as JaxPHCGNN
from phc_gnn_tpu.ops.stream_scan import attach_scan_plan
from phc_gnn_tpu.parallel.dp import loss_weight as jax_loss_weight
from phc_gnn_tpu.parallel.dp import make_dummy_batch
from phc_gnn_tpu.train import loss as jloss
from phc_gnn_tpu.train import make_optimizer as jax_make_optimizer
from phc_gnn_tpu.train.config import (DATASET_DEFAULTS as J_DEFAULTS,
                                      ExperimentConfig as JaxConfig)
from phc_gnn_tpu.train.state import TrainState
from phc_gnn_tpu.train.state import make_accum_train_step as jax_accum_step
from phc_gnn_tpu.train.trainer import build_model as jax_build_model
from phc_gnn_torch.convert import adam_state_from_optax, from_flax_variables
from phc_gnn_torch.data import (ATOM_FEATURE_DIMS, BOND_FEATURE_DIMS,
                                synthetic_batch)
from phc_gnn_torch.graph import attach_csr_plan
from phc_gnn_torch.models import PHCGNN
from phc_gnn_torch.ops import fused_bn
from phc_gnn_torch.parallel import loss_weight
from phc_gnn_torch.train import (make_accum_train_step, make_eval_step,
                                 make_optimizer, masked_bce_with_logits)
from phc_gnn_torch.train.config import DATASET_DEFAULTS, ExperimentConfig
from phc_gnn_torch.train.trainer import build_loss, build_model
from torch_parity import (assert_close, assert_leaf_close, load_flax,
                          numpy_tree, port_flat, randomize)
from torch_threads import one_torch_thread  # noqa: F401

REL_OUT = 1e-5
REL_EVAL = 1e-4
REL_GRAD = 2e-5
REL_UPDATE = 3e-5
GATE = 8192
SHAPE = (8, 256, 512)
FEATS = dict(num_node_feats=9, num_edge_feats=3)
TASKS = 8
LR = 1e-3
CLIP = 2.0
# run_script_pcba_phm2.sh:11-18 over DATASET_DEFAULTS["pcba"]
SCRIPT = dict(phm_dim=2, model_type="add", aggr_msg="sum", mlp_mp=False,
              input_embed_dim=512, mp_units=(512,) * 7, d_units=(768, 256),
              dropout_mpnn=(0.3,) * 7, dropout_dn=(0.4, 0.2), batch_size=128,
              grad_accum=4, max_nodes=4096, max_edges=8192,
              eval_batch_size=512, lr=1e-3, patience=5, factor=0.75,
              epochs=150, weightdecay=0.0)


def _config(dim=16, layers=3):
    """The pcba model at width ``dim``, every dropout rate 0."""
    return dict(phm_dim=2, learn_phm=True, c_init="standard", w_init="phm",
                atom_input_dims=tuple(ATOM_FEATURE_DIMS),
                bond_input_dims=tuple(BOND_FEATURE_DIMS),
                atom_encoded_dim=dim, mp_layers=(dim,) * layers,
                msg_aggr="sum", mlp_mp=False, norm_mp="naive-batch-norm",
                sc_type="first", skip_connect="add", pooling="softattention",
                downstream_layers=(2 * dim, dim), target_dim=TASKS,
                dropout_mpnn=(0.0,) * layers, dropout_dn=(0.0, 0.0),
                norm_dn="naive-batch-norm")


def _labels(graph_mask: np.ndarray, seed: int) -> np.ndarray:
    """0/1 labels with ~40 % missing (NaN), NaN on the padding graphs."""
    rng = np.random.default_rng(1000 + seed)
    y = (rng.random((graph_mask.shape[0], TASKS)) < 0.3).astype(np.float32)
    y[rng.random(y.shape) < 0.4] = np.nan
    y[~graph_mask] = np.nan
    return y


def _batches(seeds, dummy=()):
    """(JAX, port) batches with their plans and the same labels; the seeds in
    ``dummy`` give fully masked sub-batches."""
    jbs, tbs = [], []
    for s in seeds:
        jb = jax_synthetic_batch(*SHAPE, seed=s, target_dim=TASKS, **FEATS)
        tb = synthetic_batch(*SHAPE, seed=s, target_dim=TASKS, **FEATS)
        y = _labels(np.asarray(jb.graph_mask), s)
        jb, tb = jb.replace(y=jnp.asarray(y)), tb.replace(y=torch.from_numpy(y))
        if s in dummy:
            jb = make_dummy_batch(jb)
            tb = tb.replace(node_mask=torch.zeros_like(tb.node_mask),
                            edge_mask=torch.zeros_like(tb.edge_mask),
                            graph_mask=torch.zeros_like(tb.graph_mask),
                            y=torch.full_like(tb.y, float("nan")))
        jbs.append(attach_scan_plan(jb))
        tbs.append(attach_csr_plan(tb))
    return jbs, tbs


def _shift_invariant(key: str) -> bool:
    """Biases that a batch norm follows: each conv's transform (its
    ``norm_i``) and the head's hidden layers."""
    return key.endswith("conv.transform.b") or (
        key.startswith("downstream.affine_") and key.endswith(".b")
        and key != "downstream.affine_2.b")


@pytest.fixture
def blocked_gate(monkeypatch):
    monkeypatch.setattr(jnorm, "_FORCE_FUSED_INTERPRET", True)
    monkeypatch.setattr(jfused, "FUSED_BN_VMEM_LIMIT", GATE)
    monkeypatch.setattr(fused_bn, "FUSED_BN_VMEM_LIMIT", GATE)


def test_pcba_forward_matches_jax(blocked_gate):
    """Eval: the serving entry point against ``PHCGNN.apply(training=False)``
    with random running stats.  Train (dropout off): the output and every
    running stat after the forward, through the blocked norms."""
    cfg = _config()
    jm = JaxPHCGNN(**cfg)
    (jb,), (tb,) = _batches([3])
    v = randomize(jm.init(jax.random.key(0), jb, training=False), seed=3)
    model = load_flax(PHCGNN(**cfg, device="cpu"), v)
    assert_close(make_eval_step(model, device="cpu")(tb),
                 np.asarray(jm.apply(v, jb, training=False)), REL_EVAL)

    want, upd = jm.apply(v, jb, training=True, mutable=["batch_stats"])
    model = load_flax(PHCGNN(**cfg, device="cpu"), v).train()
    got = model(tb, training=True)
    assert got.shape == want.shape == (SHAPE[0] + 1, TASKS)
    assert_close(got.detach(), np.asarray(want), REL_OUT)
    stats = port_flat(numpy_tree(upd["batch_stats"]))
    bufs = dict(model.named_buffers())
    assert set(bufs) == set(stats)
    for key, arr in stats.items():
        assert_leaf_close(bufs[key], arr, REL_OUT, key)


def test_config_builds_the_pcba_model_at_full_width():
    """``build_model`` of the pcba configuration in both packages: the port's
    model has every flax leaf at its shape (7 layers of width 512, phm 2,
    per-layer bond encoders over 3 bond features, a 128-task head), and the
    configuration copies agree."""
    assert dataclasses.asdict(ExperimentConfig()) == dataclasses.asdict(JaxConfig())
    assert DATASET_DEFAULTS == J_DEFAULTS
    pcba = {**DATASET_DEFAULTS["pcba"], **SCRIPT, "dataset": "pcba"}
    cfg = ExperimentConfig(**pcba)
    assert cfg.sc_type == "first" and cfg.target_dim == 128  # the default
    model = build_model(cfg, ATOM_FEATURE_DIMS, BOND_FEATURE_DIMS,
                        device="cpu")
    jm = jax_build_model(JaxConfig(**pcba), J_ATOM, J_BOND)
    jb = attach_scan_plan(jax_synthetic_batch(2, 64, 128, seed=0,
                                              target_dim=128, **FEATS))
    shapes = jax.eval_shape(
        lambda: jm.init(jax.random.key(0), jb, training=False))
    v = numpy_tree(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes))
    sd = from_flax_variables(v, model)
    n_leaves = sum(len(jax.tree_util.tree_leaves(v[c])) for c in v)
    assert len(sd) == n_leaves == len(model.state_dict())
    assert sd["conv_6.conv.transform.W"].shape == (2, 256, 256)
    assert sd["conv_0.conv.transform.phm_rule"].shape == (2, 2, 2)
    assert sd["bondencoder_6.encoder_1.integer.embedding_2"].shape == (2, 256)
    assert sd["norm_6.bn.var"].shape == (2, 256)
    assert sd["downstream.real_trafo.affine.weight"].shape == (128, 256)
    assert model.sc_type == "first" and model.num_layers == 7
    loss_fn = build_loss(cfg)
    out = torch.zeros(3, 2)
    y = torch.tensor([[1.0, float("nan")], [0.0, 1.0], [float("nan")] * 2])
    b = synthetic_batch(2, 64, 128).replace(y=y)
    assert torch.equal(loss_fn(out, b), masked_bce_with_logits(out, y))


def test_loss_weight_matches_jax():
    (jb, jd), (tb, td) = _batches([0, 1], dummy=(1,))
    for name in ("bce", "l1", "ce"):
        for j, t in ((jb, tb), (jd, td)):
            assert float(loss_weight(t, name)) == float(jax_loss_weight(j, name))
    assert float(loss_weight(tb, "bce")) > 0 and float(loss_weight(td, "bce")) == 0


@pytest.fixture(scope="module")
def jax_accum():
    """JAX's accumulated step over K = 3 sub-batches (the second fully
    masked), from randomised variables, with plain SGD at lr 1e6 so that the
    accumulated gradient reads off the parameters; and optax's clip + Adam
    update from a state carried over one step."""
    cfg = _config()
    jm = JaxPHCGNN(**cfg)
    jbs, _ = _batches([4, 5, 6], dummy=(5,))
    v = randomize(jm.init(jax.random.key(0), jbs[0], training=False), seed=4)
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *jbs)
    loss_fn = lambda out, b: jloss.masked_bce_with_logits(out, b.y)  # noqa: E731
    sgd = optax.scale(-1.0)
    lr = 1e6  # p - lr * g: the f32 rounding is relative to lr * g
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnorm, "_FORCE_FUSED_INTERPRET", True)
        mp.setattr(jfused, "FUSED_BN_VMEM_LIMIT", GATE)
        params = jax.tree_util.tree_map(jnp.asarray, v["params"])
        state = TrainState(params=params, batch_stats=jax.tree_util.tree_map(
            jnp.asarray, v["batch_stats"]), opt_state=sgd.init(params),
            rng=jax.random.key(1), step=jnp.zeros((), jnp.int32))
        step = jax_accum_step(jm, sgd, loss_fn, donate=False, loss_name="bce")
        new, loss, outs = step(state, stacked, jnp.float32(lr))
    p0, p1 = port_flat(numpy_tree(params)), port_flat(numpy_tree(new.params))
    grads = {k: (p0[k].astype(np.float64) - p1[k]) / lr for k in p0}
    tx = jax_make_optimizer(LR, grad_clip=CLIP)
    jgrads = jax.tree_util.tree_map(
        lambda a, b: ((a.astype(np.float64) - b) / lr).astype(np.float32),
        numpy_tree(params), numpy_tree(new.params))
    opt0 = tx.init(params)
    _, opt1 = tx.update(jax.tree_util.tree_map(lambda g: 0.5 * g, jgrads),
                        opt0, params)
    upd, _ = tx.update(jgrads, opt1, params)
    after = port_flat(numpy_tree(optax.apply_updates(
        params, jax.tree_util.tree_map(lambda u: LR * u, upd))))
    return dict(cfg=cfg, variables=v, loss=float(loss), outs=np.asarray(outs),
                grads=grads, stats=port_flat(numpy_tree(new.batch_stats)),
                adam=opt1[1], after=after)


def _port_step(jax_accum, carried: bool):
    """The port's model from JAX's variables, its accumulated step on the
    same sub-batches, and the gradients its optimizer was handed."""
    model = PHCGNN(**jax_accum["cfg"], device="cpu")
    model.load_state_dict(from_flax_variables(jax_accum["variables"], model))
    opt = make_optimizer(dict(model.named_parameters()), grad_clip=CLIP)
    if carried:
        adam = jax_accum["adam"]
        opt.load_state(*adam_state_from_optax(
            adam.count, numpy_tree(adam.mu), numpy_tree(adam.nu), model))
    seen = {}
    real_step = opt.step

    def spy(grads, lr):
        seen.update(zip(opt.params, (g.clone() for g in grads)))
        real_step(grads, lr)

    opt.step = spy
    step = make_accum_train_step(
        model, opt, lambda out, b: masked_bce_with_logits(out, b.y),
        loss_name="bce", device="cpu")
    _, tbs = _batches([4, 5, 6], dummy=(5,))
    loss, outs = step(tbs, LR)
    return model, loss, outs, seen


def test_accum_step_matches_jax(jax_accum, blocked_gate):
    """K = 3 with a fully masked sub-batch: the loss (finite, the masked
    sub-batch weighing 0), the outputs [K, G, T], the accumulated gradient
    per leaf and the running stats (each sub-batch from the same stats,
    combined by real node counts)."""
    model, loss, outs, grads = _port_step(jax_accum, carried=False)
    assert torch.isfinite(loss) and loss.ndim == 0
    assert_close(loss, np.float32(jax_accum["loss"]), REL_OUT)
    assert outs.shape == (3, SHAPE[0] + 1, TASKS)
    assert_close(outs, jax_accum["outs"], REL_OUT)
    want = jax_accum["grads"]
    assert set(grads) == set(want)
    top = max(float(np.abs(w).max()) for w in want.values())
    for key, g in grads.items():
        assert torch.isfinite(g).all(), key
        if _shift_invariant(key):
            assert float(g.abs().max()) <= 1e-5 * top, key
            assert float(np.abs(want[key]).max()) <= 1e-5 * top, key
        else:
            assert_leaf_close(g, want[key], REL_GRAD, key)
    bufs = dict(model.named_buffers())
    assert set(bufs) == set(jax_accum["stats"])
    for key, arr in jax_accum["stats"].items():
        assert_leaf_close(bufs[key], arr, REL_OUT, key)


def test_accum_step_update_from_carried_optax_state(jax_accum, blocked_gate):
    """The port's accumulated step with its Adam loaded from an optax state
    carried over one step.  Given JAX's accumulated gradient, its update
    matches optax's on every leaf (``REL_UPDATE`` of the leaf's largest step plus 2 ulp
    of its largest entry: both sides round ``p - lr * u`` to f32).  With its
    own gradients, the parameters after the step match optax's normwise on
    every leaf whose gradient is not rounding noise (Adam divides each entry
    by its own scale, so a rounding-sized gradient entry takes a step of
    +-lr whose sign neither side controls)."""
    model, _, _, _ = _port_step(jax_accum, carried=True)
    want = jax_accum["after"]
    before = port_flat(numpy_tree(jax_accum["variables"]["params"]))
    for key, p in model.named_parameters():
        if not _shift_invariant(key):
            assert_close(p.detach(), want[key], REL_OUT)

    model = PHCGNN(**jax_accum["cfg"], device="cpu")
    model.load_state_dict(from_flax_variables(jax_accum["variables"], model))
    opt = make_optimizer(dict(model.named_parameters()), grad_clip=CLIP)
    adam = jax_accum["adam"]
    opt.load_state(*adam_state_from_optax(
        adam.count, numpy_tree(adam.mu), numpy_tree(adam.nu), model))
    opt.step([torch.tensor(jax_accum["grads"][k], dtype=torch.float32)
              for k in opt.params], LR)
    assert opt.count == 2
    for key, p in model.named_parameters():
        new = p.detach().double().numpy()
        err = np.abs(new - want[key]).max()
        ulp = float(np.spacing(np.float32(np.abs(want[key]).max())))
        tol = REL_UPDATE * np.abs(want[key] - before[key]).max() + 2 * ulp
        assert err <= tol, f"{key}: update err {err:.3g} > {tol:.3g}"
