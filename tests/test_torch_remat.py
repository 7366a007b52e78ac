"""``PHCGNN(remat=True)``: each conv rematerialized, on the CPU.

``remat=True`` wraps every conv in ``torch.utils.checkpoint`` (JAX's
``nn.remat``, phc_gnn_tpu/models/phc_gnn.py:233-240): the backward
recomputes the conv from its inputs instead of keeping its activations.
The recompute runs the same operations on the same inputs, so the port
holds ``remat=True`` to ``remat=False`` bit for bit: the losses, the
outputs, every parameter (so every gradient and Adam update) and every
running statistic after 2 steps, dropout on.  The recompute leaves the
running stats alone (``nn.norm.frozen_running_stats``), so they are updated
once a step, which the bit-equality shows and the counts of the conv's
calls (two a step: the forward and the recompute) make visible.  Against
JAX's ``remat=True`` the gradients and the running stats agree within
tests/test_torch_train.py's tolerances (``REL_OUT`` 1e-5, ``REL_GRAD``
2e-5 per leaf; the biases that a batch norm follows, whose gradients are
rounding noise on both sides, held to 1e-5 of the largest gradient).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import phc_gnn_tpu.nn.norm as jnorm
from phc_gnn_tpu.data import synthetic_batch as jax_synthetic_batch
from phc_gnn_tpu.models import PHCGNN as JaxPHCGNN
from phc_gnn_tpu.ops.stream_scan import attach_scan_plan
from phc_gnn_torch.convert import from_flax_variables
from phc_gnn_torch.data import ZINC_ATOM_DIMS, ZINC_BOND_DIMS, synthetic_batch
from phc_gnn_torch.graph import attach_csr_plan
from phc_gnn_torch.models import PHCGNN
from phc_gnn_torch.nn.norm import PHMNorm, frozen_running_stats
from phc_gnn_torch.train import (loss as tloss, make_accum_train_step,
                                 make_optimizer, make_scan_train_steps,
                                 make_train_step)
from torch_parity import (assert_close, assert_leaf_close, numpy_tree,
                          port_flat, randomize)
from torch_threads import one_torch_thread  # noqa: F401

REL_OUT = 1e-5
REL_GRAD = 2e-5
SHAPE = (8, 256, 512)
DIM = 32
BASE = dict(atom_input_dims=ZINC_ATOM_DIMS, bond_input_dims=ZINC_BOND_DIMS,
            atom_encoded_dim=DIM, mp_layers=(DIM, DIM),
            dropout_mpnn=(0.1, 0.1), target_dim=1, dropout_dn=(0.2, 0.1))
MODELS = {
    "flagship": dict(phm_dim=4, downstream_layers=(DIM, DIM // 2),
                     msg_aggr="softmax", mlp_mp=True, sc_type="last"),
    "pcba": dict(phm_dim=2, downstream_layers=(2 * DIM, DIM), msg_aggr="sum",
                 mlp_mp=False, sc_type="first", norm_mp="naive-batch-norm",
                 norm_dn="naive-batch-norm"),
    "pna": dict(phm_dim=4, downstream_layers=(DIM, DIM // 2), msg_aggr="pna",
                mlp_mp=True, sc_type="last",
                avg_deg={"lin": 2.2, "log": 1.15, "exp": 10.9}),
    "quat": dict(phm_dim=4, downstream_layers=(DIM, DIM // 2),
                 msg_aggr="softmax", mlp_mp=True, sc_type="last",
                 norm_mp="q-batch-norm", norm_dn="naive-batch-norm"),
}


def _loss_fn(out, batch):
    return tloss.masked_l1(out, batch.y)


def _batches(n=2):
    return [attach_csr_plan(synthetic_batch(*SHAPE, seed=s))
            for s in range(n)]


def _count_calls(module):
    """A list that grows by one at each run of ``module``'s forward (the
    checkpoint's recompute runs it without the module's hooks)."""
    calls, forward = [], module.forward

    def counted(*args, **kwargs):
        calls.append(1)
        return forward(*args, **kwargs)

    module.forward = counted
    return calls


def _two_steps(cfg, remat, dtype=None):
    """The losses, outputs and state_dict after 2 ``make_train_step`` steps,
    and the calls of the first conv."""
    model = PHCGNN(**cfg, remat=remat, compute_dtype=dtype, device="cpu")
    calls = _count_calls(model.conv_0)
    opt = make_optimizer(dict(model.named_parameters()), grad_clip=2.0)
    step = make_train_step(model, opt, _loss_fn, weight_decay=0.1,
                           device="cpu")
    outs = [step(b, 1e-3) for b in _batches()]
    return outs, model.state_dict(), len(calls)


def _assert_equal(a, b):
    (outs_a, state_a, _), (outs_b, state_b, _) = a, b
    for (la, oa), (lb, ob) in zip(outs_a, outs_b):
        assert torch.equal(la, lb) and torch.equal(oa, ob)
    assert sorted(state_a) == sorted(state_b)
    for k in state_a:
        assert torch.equal(state_a[k], state_b[k]), k


@pytest.mark.parametrize("name", sorted(MODELS))
def test_remat_steps_bit_equal(name):
    """2 train steps, dropout on: ``remat=True`` bit-equal to ``False``;
    the first conv runs twice a step with remat (forward, recompute) and
    once without."""
    cfg = {**BASE, **MODELS[name]}
    plain, remat = _two_steps(cfg, False), _two_steps(cfg, True)
    _assert_equal(plain, remat)
    assert (plain[2], remat[2]) == (2, 4)


def test_remat_bf16_bit_equal():
    """``remat`` and ``compute_dtype=bf16`` together: bit-equal to the bf16
    model without remat."""
    cfg = {**BASE, **MODELS["flagship"]}
    _assert_equal(_two_steps(cfg, False, torch.bfloat16),
                  _two_steps(cfg, True, torch.bfloat16))


def _accum(remat):
    cfg = {**BASE, **MODELS["pcba"]}
    model = PHCGNN(**cfg, remat=remat, device="cpu")
    opt = make_optimizer(dict(model.named_parameters()), grad_clip=2.0)
    step = make_accum_train_step(model, opt, _loss_fn, loss_name="l1",
                                 device="cpu")
    outs = [step(_batches(2), 1e-3), step(_batches(2)[::-1], 1e-3)]
    return ([(loss, torch.stack(list(o))) for loss, o in outs],
            model.state_dict(), 0)


def test_remat_accumulated_step_bit_equal():
    """pcba's accumulated step (K = 2, its running stats restored before
    each sub-batch and node-weighted after): bit-equal with remat."""
    _assert_equal(_accum(False), _accum(True))


def _scan(remat):
    cfg = {**BASE, **MODELS["flagship"]}
    model = PHCGNN(**cfg, remat=remat, device="cpu")
    opt = make_optimizer(dict(model.named_parameters()), grad_clip=2.0)
    steps = make_scan_train_steps(model, opt, _loss_fn, weight_decay=0.1,
                                  device="cpu")
    losses, outs = steps(_batches(3), 1e-3)
    return [(losses, torch.stack(list(outs)))], model.state_dict(), 0


def test_remat_scanned_steps_bit_equal():
    """``make_scan_train_steps`` over 3 batches: bit-equal with remat."""
    _assert_equal(_scan(False), _scan(True))


def test_frozen_running_stats_leaves_the_stats():
    """A training-mode norm inside ``frozen_running_stats`` returns what it
    returns outside and leaves its running stats as they were; outside, the
    stats move."""
    torch.manual_seed(0)
    x = torch.randn(64, 16)
    mask = torch.rand(64) > 0.2
    for norm_type in ("naive-batch-norm", "q-batch-norm"):
        norm = PHMNorm(16, 4, norm_type)
        before = {k: b.clone() for k, b in norm.named_buffers()}
        with frozen_running_stats():
            y_frozen = norm(x, training=True, mask=mask)
        for k, b in norm.named_buffers():
            assert torch.equal(b, before[k]), (norm_type, k)
        y = norm(x, training=True, mask=mask)
        assert torch.equal(y, y_frozen)
        assert any(not torch.equal(b, before[k])
                   for k, b in norm.named_buffers()), norm_type


def test_remat_without_grad_is_the_plain_forward():
    """Under ``torch.no_grad`` (eval and the eval steps) remat changes
    nothing: the conv runs once and the output is bit-equal."""
    cfg = {**BASE, **MODELS["flagship"]}
    a = PHCGNN(**cfg, device="cpu")
    b = PHCGNN(**cfg, remat=True, device="cpu")
    calls = _count_calls(b.conv_0)
    batch = _batches(1)[0]
    with torch.no_grad():
        for training in (False, True):
            g = torch.Generator().manual_seed(1)
            h = torch.Generator().manual_seed(1)
            assert torch.equal(a(batch, training=training, generator=g),
                               b(batch, training=training, generator=h))
    assert len(calls) == 2


def test_remat_matches_jax_remat(monkeypatch):
    """The port's ``remat=True`` flagship against JAX's ``remat=True``, one
    dropout-free training forward and backward from the same randomised
    variables: the output, every gradient and the running stats."""
    monkeypatch.setattr(jnorm, "_FORCE_FUSED_INTERPRET", True)
    cfg = {**BASE, **MODELS["flagship"], "dropout_mpnn": (0.0, 0.0),
           "dropout_dn": (0.0, 0.0)}
    jm = JaxPHCGNN(**cfg, remat=True)
    jb = attach_scan_plan(jax_synthetic_batch(*SHAPE, seed=3))
    v = randomize(jm.init(jax.random.key(0), jb, training=False), seed=3)

    def f(p):
        out, upd = jm.apply({"params": p, "batch_stats": v["batch_stats"]},
                            jb, training=True, mutable=["batch_stats"])
        return jnp.mean(jnp.abs(out - 0.3)), (out, upd["batch_stats"])

    (_, (out_j, stats_j)), g_j = jax.jit(jax.value_and_grad(
        f, has_aux=True))(v["params"])
    model = PHCGNN(**cfg, remat=True, device="cpu")
    model.load_state_dict(from_flax_variables(v, model))
    out = model(attach_csr_plan(synthetic_batch(*SHAPE, seed=3)),
                training=True)
    names = [k for k, _ in model.named_parameters()]
    grads = torch.autograd.grad((out - 0.3).abs().mean(),
                                list(model.parameters()))
    assert_close(out.detach(), np.asarray(out_j), REL_OUT)
    want = port_flat(numpy_tree(g_j))
    top = max(float(np.abs(w).max()) for w in want.values())
    for k, g in zip(names, grads):
        if float(np.abs(want[k]).max()) <= 1e-5 * top:
            assert float(g.abs().max()) <= 1e-5 * top, k
        else:
            assert_leaf_close(g, want[k], REL_GRAD, k)
    stats = port_flat(numpy_tree(stats_j))
    for k, b in model.named_buffers():
        assert_leaf_close(b, stats[k], REL_OUT, k)
