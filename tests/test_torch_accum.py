"""The accumulated train step of the port (``make_accum_train_step``) and
the eager body that its CUDA graph captures (``_eager_accum_train_step``),
on the CPU.

On the card ``make_accum_train_step`` replays one CUDA graph of the whole
step (``chip_smoke.py`` holds it to the eager body bit for bit); on the CPU
both run the same body eagerly.  The eager body is held here to JAX's
``make_accum_train_step`` on ``tests/test_torch_pcba.py``'s K = 3 fixture
(the pcba model at width 16, its second sub-batch fully masked), at that
file's tolerances: ``REL_OUT`` 1e-5 for the loss, the outputs and the
running stats, ``REL_GRAD`` 2e-5 per leaf for the accumulated gradient,
1e-5 of the largest gradient for the biases a batch norm follows.  The
rest (the public step against the eager body, a stack, the shape check,
the optimizer's count) is held bit for bit.
"""

import pytest
import torch

from phc_gnn_torch.data import synthetic_batch
from phc_gnn_torch.graph import attach_csr_plan, stack_batches
from phc_gnn_torch.models import PHCGNN
from phc_gnn_torch.train import (make_accum_train_step, make_optimizer,
                                 masked_bce_with_logits)
from phc_gnn_torch.train.state import _eager_accum_train_step
from test_torch_pcba import (CLIP, LR, REL_GRAD, REL_OUT, SHAPE, TASKS,
                             _batches, _config, _shift_invariant,
                             blocked_gate, jax_accum)  # noqa: F401
from torch_parity import assert_close, assert_leaf_close, load_flax
from torch_threads import one_torch_thread  # noqa: F401

SEEDS = (4, 5, 6)
DUMMY = (5,)


def _loss_fn(out, b):
    return masked_bce_with_logits(out, b.y)


def _model(dropout: bool = False):
    cfg = _config()
    if dropout:
        cfg.update(dropout_mpnn=(0.3,) * 3, dropout_dn=(0.4, 0.2))
    return PHCGNN(**cfg, seed=2, device="cpu")


def _step(make, model, seed: int = 0):
    opt = make_optimizer(dict(model.named_parameters()), grad_clip=CLIP)
    return opt, make(model, opt, _loss_fn, loss_name="bce", seed=seed,
                     device="cpu")


def _state(model, opt):
    out = {f"p {k}": p.detach().clone() for k, p in model.named_parameters()}
    out.update({f"b {k}": b.clone() for k, b in model.named_buffers()})
    out.update({f"s {i}": t.clone()
                for i, t in enumerate(opt.state_tensors())})
    return out


def _assert_equal_state(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_eager_body_matches_jax(jax_accum, blocked_gate):  # noqa: F811
    """The eager body on K = 3 sub-batches, the second fully masked: the
    loss (the masked sub-batch weighing 0), the outputs [K, G, T], the
    accumulated gradient that reaches the optimizer, per leaf, and the
    running stats, against JAX's accumulated step."""
    model = load_flax(PHCGNN(**jax_accum["cfg"], device="cpu"),
                      jax_accum["variables"])
    opt = make_optimizer(dict(model.named_parameters()), grad_clip=CLIP)
    seen, real_step = {}, opt.step

    def spy(grads, lr):
        seen.update(zip(opt.params, (g.clone() for g in grads)))
        real_step(grads, lr)

    opt.step = spy
    step = _eager_accum_train_step(model, opt, _loss_fn, loss_name="bce",
                                   device="cpu")
    _, tbs = _batches(SEEDS, dummy=DUMMY)
    loss, outs = step(tbs, LR)
    assert torch.isfinite(loss) and loss.ndim == 0
    assert_close(loss, jax_accum["loss"], REL_OUT)
    assert outs.shape == (3, SHAPE[0] + 1, TASKS)
    assert_close(outs, jax_accum["outs"], REL_OUT)
    want = jax_accum["grads"]
    assert set(seen) == set(want)
    top = max(float(abs(w).max()) for w in want.values())
    for key, g in seen.items():
        if _shift_invariant(key):
            assert float(g.abs().max()) <= 1e-5 * top, key
        else:
            assert_leaf_close(g, want[key], REL_GRAD, key)
    bufs = dict(model.named_buffers())
    for key, arr in jax_accum["stats"].items():
        assert_leaf_close(bufs[key], arr, REL_OUT, key)


@pytest.mark.parametrize("dropout", [False, True])
def test_step_equals_eager_body(dropout, blocked_gate):  # noqa: F811
    """Two calls of ``make_accum_train_step`` and of the eager body from
    the same weights and generator seed, a fully masked sub-batch among
    the three, dropout masks drawn in the same order: losses, outputs and
    every parameter, running stat and Adam tensor bit-equal."""
    _, tbs = _batches(SEEDS, dummy=DUMMY)
    runs = []
    for make in (make_accum_train_step, _eager_accum_train_step):
        model = _model(dropout)
        opt, step = _step(make, model, seed=7)
        res = [step(tbs, LR), step(tbs, LR / 2)]
        runs.append((res, _state(model, opt)))
    for (la, oa), (lb, ob) in zip(runs[0][0], runs[1][0]):
        assert torch.equal(la, lb) and torch.equal(oa, ob)
        assert torch.isfinite(la)
    _assert_equal_state(runs[0][1], runs[1][1])


def test_stack_input_equals_list(blocked_gate):  # noqa: F811
    """A stack from ``stack_batches`` is accepted, as the scanned steps
    accept one, and steps bit for bit as the list of its sub-batches."""
    _, tbs = _batches(SEEDS, dummy=DUMMY)
    runs = []
    for batches in (tbs, stack_batches(tbs)):
        model = _model()
        opt, step = _step(make_accum_train_step, model)
        loss, outs = step(batches, LR)
        runs.append((loss, outs, _state(model, opt)))
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
    _assert_equal_state(runs[0][2], runs[1][2])


@pytest.mark.parametrize("make", [make_accum_train_step,
                                  _eager_accum_train_step])
def test_sub_batches_of_two_shapes_raise(make):
    """All K sub-batches share one bucket shape, as JAX's stacked input
    does: two shapes raise a ``ValueError`` that names both, and an empty
    list raises too; neither takes a step."""
    model = _model()
    opt, step = _step(make, model)
    _, tbs = _batches(SEEDS[:1])
    other = attach_csr_plan(synthetic_batch(
        SHAPE[0], SHAPE[1], 2 * SHAPE[2], seed=1, target_dim=TASKS,
        num_node_feats=9, num_edge_feats=3))
    with pytest.raises(ValueError, match="two shapes") as err:
        step([tbs[0], other], LR)
    assert str((SHAPE[1],)) in str(err.value)
    assert str((2 * SHAPE[2],)) in str(err.value)
    with pytest.raises(ValueError, match="at least one batch"):
        step([], LR)
    assert opt.count == 0


def test_optimizer_count_advances_one_a_call(blocked_gate):  # noqa: F811
    """Each call is one optimizer step whatever K is: the count reads 3
    after three calls (K = 3, 1 and 3), and so does each parameter's Adam
    step count."""
    _, tbs = _batches(SEEDS, dummy=DUMMY)
    model = _model()
    opt, step = _step(make_accum_train_step, model)
    for batches in (tbs, tbs[:1], tbs):
        step(batches, LR)
    assert opt.count == 3
    steps = {float(s["step"]) for s in opt.adam.state.values()}
    assert steps == {3.0}
