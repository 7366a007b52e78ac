"""The port's scanned train and eval steps (``make_scan_train_steps``,
``make_scan_eval_steps``), the batch buffers they need and
``iter_scan_chunks``, on the CPU (the bench entry point's tests are in
``tests/test_torch_bench.py``).

On the CPU the scanned steps run eagerly (on the card they replay a CUDA
graph, which ``chip_smoke.py`` holds to the eager steps).  They must equal
``make_train_step`` called S times bit for bit, dropout included (the same
generator, the same order), and JAX's ``make_scan_train_steps`` /
``make_scan_eval_steps`` on the same weights with dropout off.  The JAX side
runs the flagship at width 32 with 2 layers on ``synthetic_batch(8, 256,
512)`` graphs with its scan plan (the Pallas kernels A, B and C in
interpret mode, D and E through ``nn.norm._FORCE_FUSED_INTERPRET``).

Tolerances, as ``tests/test_torch_train.py``'s for one step: ``REL_OUT``
1e-5 normwise for losses and outputs and per leaf for running stats and
parameters after the steps; the eval forward 1e-4 normwise, as
``tests/test_torch_model.py``.  The biases that a batch norm follows have a
gradient of rounding noise on both sides, which Adam turns into steps of
about +-lr: after S steps they may part by ``BIAS_WALK`` a step, and the
running means of the norms after them, which read those biases, by
``MEAN_SLACK`` more than ``REL_OUT``.
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
from phc_gnn_tpu.train import loss as jloss
from phc_gnn_tpu.train import make_optimizer as jax_make_optimizer
from phc_gnn_tpu.train.state import TrainState
from phc_gnn_tpu.train.state import make_scan_eval_steps as jax_scan_eval
from phc_gnn_tpu.train.state import make_scan_train_steps as jax_scan_train
from phc_gnn_tpu.train.trainer import iter_scan_chunks as jax_iter_scan_chunks
from phc_gnn_torch.convert import from_flax_variables
from phc_gnn_torch.data import ZINC_ATOM_DIMS, ZINC_BOND_DIMS, synthetic_batch
from phc_gnn_torch.graph import attach_csr_plan, stack_batches, unstack_batches
from phc_gnn_torch.models import PHCGNN
from phc_gnn_torch.train import (make_loss_and_grads, make_optimizer,
                                 make_scan_eval_steps, make_scan_train_steps,
                                 make_train_step, masked_l1)
from phc_gnn_torch.train.trainer import iter_scan_chunks
from torch_parity import (assert_close, assert_leaf_close, numpy_tree,
                          port_flat, randomize)
from torch_threads import one_torch_thread  # noqa: F401

REL_OUT = 1e-5
REL_EVAL = 1e-4
LR = 1e-3
WD = 0.1
CLIP = 2.0
SHAPE = (8, 256, 512)
S = 3
# a bias that a batch norm follows has a gradient of rounding noise on both
# sides, and Adam moves it by about +-lr a step whatever the noise's size:
# two such walks part by at most 2 lr a step; a running mean (momentum 0.1)
# reads the bias of each earlier step
BIAS_WALK = 2 * LR
MEAN_SLACK = 0.1 * sum(BIAS_WALK * k for k in range(1, S))


def _config(dropout: bool, dim=32, layers=2):
    """The flagship configuration (bench.py:140-146) at width ``dim``."""
    return dict(phm_dim=4, atom_input_dims=ZINC_ATOM_DIMS,
                bond_input_dims=ZINC_BOND_DIMS, atom_encoded_dim=dim,
                mp_layers=(dim,) * layers,
                dropout_mpnn=(0.1 if dropout else 0.0,) * layers,
                downstream_layers=(dim, dim // 2), target_dim=1,
                dropout_dn=(0.2, 0.1) if dropout else (0.0, 0.0),
                msg_aggr="softmax", mlp_mp=True, sc_type="last")


def _loss_fn(out, batch):
    return masked_l1(out, batch.y)


def _batches(n=S):
    return [attach_csr_plan(synthetic_batch(*SHAPE, seed=s)) for s in range(n)]


def _shift_invariant(key: str) -> bool:
    """Biases of the PHM layers that a batch norm follows."""
    return key.endswith(("transform.linear1.b", "transform.linear2.b")) or (
        key.startswith("downstream.affine_") and key.endswith(".b")
        and key != "downstream.affine_2.b")


def _state(model, opt):
    """Parameters, buffers and Adam state, keyed by name."""
    out = {f"p {k}": p.detach() for k, p in model.named_parameters()}
    out.update({f"b {k}": b for k, b in model.named_buffers()})
    for k, p in opt.params.items():
        out.update({f"adam {n} {k}": t for n, t in opt.adam.state[p].items()})
    return out


@pytest.mark.parametrize("stacked", [False, True])
def test_scan_steps_equal_train_steps_bit_for_bit(stacked):
    """S scanned steps, with dropout, from a sequence or a stack of batches,
    against S ``make_train_step`` calls from the same weights and seed:
    losses, outputs, parameters, running stats, Adam moments and steps, and
    the optimizer's host count, all bit-equal."""
    batches = _batches()
    runs = []
    for scanned in (True, False):
        model = PHCGNN(**_config(dropout=True), seed=1, device="cpu")
        opt = make_optimizer(dict(model.named_parameters()), grad_clip=CLIP)
        if scanned:
            steps = make_scan_train_steps(model, opt, _loss_fn,
                                          weight_decay=WD, seed=5,
                                          device="cpu")
            losses, outs = steps(stack_batches(batches) if stacked
                                 else batches, LR)
        else:
            step = make_train_step(model, opt, _loss_fn, weight_decay=WD,
                                   seed=5, device="cpu")
            res = [step(b, LR) for b in batches]
            losses = torch.stack([r[0] for r in res])
            outs = torch.stack([r[1] for r in res])
        runs.append((losses, outs, _state(model, opt), opt.count))
    (losses, outs, state, count), (e_losses, e_outs, e_state, e_count) = runs
    assert losses.shape == (S,) and outs.shape == (S, SHAPE[0] + 1, 1)
    assert torch.equal(losses, e_losses) and torch.equal(outs, e_outs)
    assert state.keys() == e_state.keys()
    for key, t in state.items():
        assert torch.equal(t, e_state[key]), key
    assert count == e_count == S
    assert float(state[f"adam step {next(iter(opt.params))}"]) == S


@pytest.fixture(scope="module")
def jax_scan():
    """JAX's scanned train and eval steps over S batches from randomised
    variables, with dropout off."""
    cfg = _config(dropout=False)
    jm = JaxPHCGNN(**cfg)
    jbs = [attach_scan_plan(jax_synthetic_batch(*SHAPE, seed=s))
           for s in range(S)]
    stacked = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *jbs)
    v = randomize(jm.init(jax.random.key(0), jbs[0], training=False), seed=3)
    tx = jax_make_optimizer(LR, grad_clip=CLIP)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnorm, "_FORCE_FUSED_INTERPRET", True)
        params = jax.tree_util.tree_map(jnp.asarray, v["params"])
        state0 = TrainState(
            params=params,
            batch_stats=jax.tree_util.tree_map(jnp.asarray, v["batch_stats"]),
            opt_state=tx.init(params), rng=jax.random.key(1),
            step=jnp.zeros((), jnp.int32))
        evals = np.asarray(jax_scan_eval(jm)(state0, stacked))
        steps = jax_scan_train(jm, tx, lambda out, b: jloss.masked_l1(out,
                                                                      b.y),
                               weight_decay=WD)
        state, losses, outs = steps(state0, stacked, jnp.float32(LR))
    return dict(cfg=cfg, variables=v, evals=evals, losses=np.asarray(losses),
                outs=np.asarray(outs), state=state)


def _port_model(cfg, variables):
    model = PHCGNN(**cfg, device="cpu")
    model.load_state_dict(from_flax_variables(variables, model))
    return model


def test_scan_train_steps_match_jax(jax_scan):
    """S scanned steps with dropout off against JAX's scanned steps on the
    same weights: losses, outputs, then the parameters and running stats."""
    model = _port_model(jax_scan["cfg"], jax_scan["variables"])
    opt = make_optimizer(dict(model.named_parameters()), grad_clip=CLIP)
    steps = make_scan_train_steps(model, opt, _loss_fn, weight_decay=WD,
                                  device="cpu")
    losses, outs = steps(_batches(), LR)
    assert_close(losses, jax_scan["losses"], REL_OUT)
    assert_close(outs, jax_scan["outs"], REL_OUT)
    state = jax_scan["state"]
    want = port_flat(numpy_tree({"params": state.params,
                                 "batch_stats": state.batch_stats}))
    want = {k.split(".", 1)[1]: v for k, v in want.items()}
    got = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    assert set(got) == set(want)
    for key, t in got.items():
        t = t.detach().numpy()
        if _shift_invariant(key):
            assert np.abs(t - want[key]).max() <= BIAS_WALK * S, key
        elif key.endswith(".bn.mean"):
            err = np.abs(t - want[key]).max()
            assert err <= MEAN_SLACK + REL_OUT * np.abs(want[key]).max(), key
        else:
            assert_leaf_close(t, want[key], REL_OUT, key)


def test_scan_eval_steps_match_jax(jax_scan):
    """S scanned eval forwards against JAX's on the same weights."""
    model = _port_model(jax_scan["cfg"], jax_scan["variables"])
    got = make_scan_eval_steps(model, device="cpu")(_batches())
    assert got.shape == jax_scan["evals"].shape == (S, SHAPE[0] + 1, 1)
    assert_close(got, jax_scan["evals"], REL_EVAL)


def test_regularization_follows_an_lr_tensor_that_changes():
    """The loss's regularization multiplies the lr tensor it is given, read
    at each call: filled with a new value between two calls, the loss moves
    by the new lr times wd times the regularization; and the scanned steps
    at a new lr equal eager steps at that lr."""
    batch = _batches(1)[0]
    model = PHCGNN(**_config(dropout=False), seed=2, device="cpu")
    f = make_loss_and_grads(model, _loss_fn, weight_decay=WD)
    no_reg = make_loss_and_grads(model, _loss_fn)
    lr = torch.zeros(())
    base = float(no_reg(batch, lr)[0])
    seen = []
    for value in (1e-3, 5e-2):
        lr.fill_(value)
        seen.append(float(f(batch, lr)[0]) - base)
        assert float(f(batch, value)[0]) - base == pytest.approx(
            seen[-1], rel=1e-6)
    assert seen[1] / seen[0] == pytest.approx(50.0, rel=1e-4)

    runs = []
    for scanned in (True, False):
        m = PHCGNN(**_config(dropout=False), seed=2, device="cpu")
        opt = make_optimizer(dict(m.named_parameters()), grad_clip=CLIP)
        if scanned:
            steps = make_scan_train_steps(m, opt, _loss_fn, weight_decay=WD,
                                          device="cpu")
            losses = torch.cat([steps([batch], LR)[0],
                                steps([batch], torch.tensor(LR / 4))[0]])
        else:
            step = make_train_step(m, opt, _loss_fn, weight_decay=WD,
                                   device="cpu")
            losses = torch.stack([step(batch, LR)[0],
                                  step(batch, LR / 4)[0]])
        runs.append((losses, [p.detach().clone() for p in m.parameters()],
                     float(opt.lr)))
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    assert runs[0][2] == runs[1][2] == pytest.approx(LR / 4)


def test_scan_steps_need_one_bucket_and_cuda_or_cpu(monkeypatch):
    """A chunk of two bucket shapes raises; without CUDA the entry points
    raise unless asked for the CPU."""
    model = PHCGNN(**_config(dropout=False), device="cpu")
    opt = make_optimizer(dict(model.named_parameters()))
    steps = make_scan_train_steps(model, opt, _loss_fn, device="cpu")
    mixed = [_batches(1)[0], attach_csr_plan(synthetic_batch(8, 512, 512))]
    with pytest.raises(ValueError, match="shapes"):
        steps(mixed, LR)
    with pytest.raises(ValueError, match="shapes"):
        make_scan_eval_steps(model, device="cpu")(mixed)
    with pytest.raises(ValueError, match="at least one batch"):
        steps([], LR)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_scan_train_steps(model, opt, _loss_fn)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_scan_eval_steps(model)


def test_optimizer_state_follows_a_moved_model(monkeypatch):
    """An optimizer built before its model moved: the train steps move its
    lr and Adam state to the parameters' device (here a stand-in, the meta
    device, as the CPU has no second one), in each tensor's shape, dtype and
    strides, and leave it alone when it is already there."""
    model = PHCGNN(**_config(dropout=False, dim=16), device="cpu")
    opt = make_optimizer(dict(model.named_parameters()), grad_clip=CLIP)
    make_train_step(model, opt, _loss_fn, weight_decay=WD,
                    device="cpu")(_batches(1)[0], LR)
    before = {p: {k: t for k, t in opt.adam.state[p].items()}
              for p in opt.params.values()}
    lr, adam = opt.lr, opt.adam
    make_scan_train_steps(model, opt, _loss_fn, device="cpu")
    assert opt.lr is lr and opt.adam is adam
    meta = torch.device("meta")
    monkeypatch.setattr(opt, "_params_device", lambda: meta)
    make_scan_train_steps(model, opt, _loss_fn, device="cpu")
    assert opt.lr.device == meta and opt.lr.dtype == torch.float32
    assert opt.adam is not adam and not opt.on_device
    assert set(opt.adam.state) == set(opt.params.values())
    for p, st in before.items():
        moved = opt.adam.state[p]
        assert set(moved) == set(st)
        for k, t in st.items():
            got = moved[k]
            assert got.device == meta, k
            assert (got.shape, got.dtype, got.stride()) == (
                t.shape, t.dtype, t.stride()), k
    assert all(t.device == meta for t in opt.state_tensors())


def test_batch_buffers_copy_and_stack():
    """``empty_like`` and ``copy_`` fill static buffers in place (CSR plans
    included) and refuse another shape; ``stack_batches`` and
    ``unstack_batches`` undo each other."""
    a, b = _batches(2)
    buf = a.empty_like("cpu")
    ptrs = [t.data_ptr() for _, t in buf.tensors()]
    assert buf.copy_(b) is buf
    assert [t.data_ptr() for _, t in buf.tensors()] == ptrs
    for (name, t), (_, want) in zip(buf.tensors(), b.tensors()):
        torch.testing.assert_close(t, want, rtol=0, atol=0, equal_nan=True,
                                   msg=name)
    assert {n for n, _ in buf.tensors()} >= {"rowptr", "snd_perm",
                                             "snd_rowptr", "y"}
    with pytest.raises(ValueError, match="does not fit"):
        buf.copy_(b.replace(rowptr=None))
    stacked = stack_batches([a, b])
    assert stacked.senders.shape == (2, SHAPE[2])
    for got, want in zip(unstack_batches(stacked), (a, b)):
        assert got.shape_key() == want.shape_key()
        for (name, t), (_, w) in zip(got.tensors(), want.tensors()):
            torch.testing.assert_close(t, w, rtol=0, atol=0, equal_nan=True,
                                       msg=name)


@pytest.mark.parametrize("chunk_size", [1, 2, 3])
def test_iter_scan_chunks_groups_as_jax(chunk_size):
    """A mixed-shape stream of batches falls into the same chunks, in the
    same order, as JAX's ``iter_scan_chunks`` groups its own batches of the
    same buckets."""
    shapes = [(4, 128, 256), (4, 128, 256), (4, 128, 256), (8, 256, 512),
              (4, 128, 256), (4, 128, 512), (4, 128, 512), (8, 256, 512),
              (8, 256, 512), (8, 256, 512), (8, 256, 512)]
    port = [synthetic_batch(*s, seed=i) for i, s in enumerate(shapes)]
    ref = [jax_synthetic_batch(*s, seed=i) for i, s in enumerate(shapes)]

    def ids(chunks, batches):
        index = {id(b): i for i, b in enumerate(batches)}
        return [[index[id(b)] for b in c] for c in chunks]

    want = ids(jax_iter_scan_chunks(ref, chunk_size), ref)
    assert ids(iter_scan_chunks(port, chunk_size), port) == want
    assert sum(want, []) == list(range(len(shapes)))
