"""The multi-rank schemes' exactness at 8 ranks, the committed stress
records, and the choice between graphed and eager mesh steps.

``phc_gnn_torch.cli.stress`` is the counterpart of scripts/dryrun_stress.py
with ``__graft_entry__.exactness_check``: each scheme's step on a ``(dp,
ep)`` mesh held to the single-device accumulated step over the same dp
batches.  Here one start of 8 gloo ranks (tests/torch_ranks.py, one thread
each) runs the command's rank function at world 8, (4, 2) and (2, 4) in
both schemes, held to its oracle by its own ``hold`` within JAX's bounds
(loss < 1e-5, parameters < 1e-4); the oracle, the port's
``make_accum_train_step``, is held to JAX's on the same batches under
``optax.sgd(1e-3)``, whose parameter change over -1e-3 is its gradient
where JAX's step, which scales the optimizer's update by its own lr
argument, is called at lr 1 (both sides then add ``1 * wd * reg`` to the
loss): the loss within ``REL_LOSS`` 1e-5, each gradient entry within
``REL_GRAD`` 1e-4 of its leaf's largest plus the rounding of JAX's SGD
update divided by 1e-3 (one f32 spacing of the parameter, over 1e-3) plus
``NOISE`` 1e-5 of the largest gradient (the biases a batch norm follows,
zero but for rounding).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import __graft_entry__ as graft
from phc_gnn_tpu.data import synthetic_batch as jax_synthetic_batch
from phc_gnn_tpu.train import create_train_state
from phc_gnn_tpu.train.loss import masked_l1 as jax_masked_l1
from phc_gnn_tpu.train.state import make_accum_train_step as jax_accum
from phc_gnn_torch import parallel as P
from phc_gnn_torch.cli import stress
from phc_gnn_torch.convert import from_flax_params
from phc_gnn_torch.parallel import dp as dp_lib
from phc_gnn_torch.train import make_accum_train_step, make_optimizer
from phc_gnn_torch.train import state as state_lib
from torch_ranks import run_ranks

REL_LOSS = 1e-5
REL_GRAD = 1e-4
STEP_LR = 1.0   # the steps' lr argument: JAX's update is lr * sgd(1e-3)'s
SGD_LR = 1e-3
NOISE = 1e-5    # of the largest gradient: the biases a batch norm follows,
                # whose gradient is zero but for rounding
RECORDS = os.path.join(os.path.dirname(stress.__file__), os.pardir,
                       "stress_records")


def test_world_8_holds_jax_bounds(monkeypatch):
    """8 gloo ranks, one start: ``stress.rank_steps`` at world 8, the
    halo and replicated schemes on (4, 2) and (2, 4), each held by
    ``stress.hold`` to the single-device accumulated step within JAX's
    bounds; every rank's loss equal."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    res = run_ranks("stress_steps", 8, {})
    entries = stress.hold(res, torch.device("cpu"))
    assert [(e["scheme"], e["dp"], e["ep"]) for e in entries] == [
        ("halo", 4, 2), ("replicated", 4, 2), ("halo", 2, 4),
        ("replicated", 2, 4)]
    for e in entries:
        assert stress.within_bounds(e), e
        assert e["max_param_delta"] == stress.LR * e["max_grad_delta"]


def test_oracle_matches_jax_accum_under_sgd():
    """The stress command's oracle, the port's ``make_accum_train_step``
    over ``synthetic_batch(4, 128, 256, seed=d)`` for d < 2 with weight
    decay 0.1 and 0.01, from JAX's init (``convert.from_flax_params``)
    against JAX's ``make_accum_train_step`` under ``optax.sgd(1e-3)`` on
    the same batches, as ``exactness_check`` runs it: the loss, and the
    gradients that reach the port's optimizer against JAX's parameter
    change over -1e-3 (the steps at lr 1)."""
    jm = graft._flagship(tiny=True, nodrop=True)
    raw = [jax_synthetic_batch(**stress.BATCH, seed=d) for d in range(2)]
    tx = optax.sgd(SGD_LR)
    # jitted: the eager init dispatches op by op
    state0 = jax.jit(lambda b, key: create_train_state(jm, tx, b, key))(
        raw[0], jax.random.key(0))
    step = jax_accum(jm, tx, lambda out, b: jax_masked_l1(out, b.y),
                     weight_decay=stress.WEIGHT_DECAY,
                     weight_decay2=stress.WEIGHT_DECAY2, donate=False)
    new, jloss, _ = step(state0, jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs), *raw), jnp.float32(STEP_LR))
    p0 = jax.tree_util.tree_map(np.asarray, state0.params)
    top = max(float(np.abs(a - b).max()) for a, b in zip(
        jax.tree_util.tree_leaves(p0),
        jax.tree_util.tree_leaves(new.params))) / SGD_LR
    p1 = jax.tree_util.tree_map(np.asarray, new.params)

    model = stress.tiny_flagship()
    model.load_state_dict(from_flax_params(p0, model))
    before = {k: v.numpy().copy() for k, v in
              from_flax_params(p0, model).items()}
    after = from_flax_params(p1, model)
    opt = stress._recording_optimizer(model)
    loss, _ = make_accum_train_step(
        model, opt, stress._loss_fn, weight_decay=stress.WEIGHT_DECAY,
        weight_decay2=stress.WEIGHT_DECAY2, loss_name="l1", device="cpu")(
        stress.dp_batches(2), STEP_LR)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=REL_LOSS)
    for k, g in zip(opt.params, opt.seen):
        a, b = before[k].astype(np.float64), after[k].numpy().astype(
            np.float64)
        want = (a - b) / SGD_LR
        spacing = np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(
            np.float32)).astype(np.float64) / SGD_LR
        tol = REL_GRAD * np.abs(want).max() + spacing + NOISE * top
        err = np.abs(g.numpy().astype(np.float64) - want)
        assert (err <= tol).all(), (k, float((err - tol).max()))


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_committed_stress_records(device):
    """``phc_gnn_torch/stress_records/<device>.json``, as the command wrote
    it: worlds 8, 16 and 32, each with its 4 (scheme, dp, ep) entries (12
    in all, JAX's six shapes in both schemes) within JAX's bounds; the
    card's record names an H100 and its power limit."""
    with open(os.path.join(RECORDS, f"{device}.json")) as f:
        rec = json.load(f)
    assert [w["n_ranks"] for w in rec["worlds"]] == [8, 16, 32]
    seen = set()
    for w in rec["worlds"]:
        n = w["n_ranks"]
        assert w["ok"] and w["wall_s"] > 0
        assert sorted((e["dp"], e["ep"]) for e in w["exactness"]) == sorted(
            2 * stress.shapes(n))
        for e in w["exactness"]:
            assert stress.within_bounds(e), e
            seen.add((e["scheme"], e["dp"], e["ep"]))
    assert len(seen) == 12
    if device == "cuda":
        assert "H100" in rec["device"] and rec["device"].endswith(" W")
    else:
        assert rec["device"] == "cpu"


@pytest.mark.parametrize("same", [False, True])
def test_shard_dropout_draws_alike_and_keeps_its_block(same):
    """The halo shards' node dropout (``phm_dropout(..., block=(s, S))``),
    which a CUDA graph can replay: every shard draws ``S`` masks from one
    generator state (the generators stay in step, so the head's dropout
    after it draws alike on every shard), shard ``s`` keeps mask ``s``,
    and the shards' masks differ."""
    from phc_gnn_torch.nn import phm_dropout
    x = torch.ones(64, 4 * 8)
    outs, states = [], []
    for s in range(3):
        gen = torch.Generator().manual_seed(7)
        outs.append(phm_dropout(x, 0.5, 4, gen, same=same, block=(s, 3)))
        states.append(gen.get_state())
        want_gen = torch.Generator().manual_seed(7)
        shape = (64, 1, 8) if same else (64, 32)
        keep = torch.rand((3,) + shape, generator=want_gen)[s] < 0.5
        want = torch.where(keep, x.reshape((64, 4, 8) if same else x.shape)
                           / 0.5, 0.0).reshape(x.shape)
        assert torch.equal(outs[-1], want)
    assert all(torch.equal(st, states[0]) for st in states)
    assert not torch.equal(outs[0], outs[1])


class _Recorder:
    """A stand-in for ``train.state._GraphedStep`` on the CPU, which cannot
    capture: it records each capture and runs the call eagerly."""

    made = []

    def __init__(self, fn, batches, dev, generator=None, restore=None,
                 capture_error_mode="global"):
        self.fn = fn
        _Recorder.made.append((batches[0].shape_key(), capture_error_mode))
        if restore is not None:
            restore()

    def run(self, groups):
        outs = [self.fn(*group) for group in groups]
        return [torch.stack(list(parts)) for parts in zip(*outs)]


def _small_model():
    from phc_gnn_torch.export import flagship_config
    from phc_gnn_torch.models import PHCGNN
    return PHCGNN(**flagship_config(8, 1, dropout=False), seed=0,
                  device="cpu")


MAKERS = {
    "dp": lambda m, o, mesh: P.make_dp_train_step(
        m, o, stress._loss_fn, mesh, device="cpu"),
    "scan_dp": lambda m, o, mesh: P.make_scan_dp_train_steps(
        m, o, stress._loss_fn, mesh, device="cpu"),
    "np": lambda m, o, mesh: P.make_np_train_step(
        m, o, stress._loss_fn, mesh, device="cpu"),
    "scan_np": lambda m, o, mesh: P.make_scan_np_train_steps(
        m, o, stress._loss_fn, mesh, device="cpu"),
    "dp_np": lambda m, o, mesh: P.make_dp_np_train_step(
        m, o, stress._loss_fn, mesh, device="cpu"),
    "ep": lambda m, o, mesh: P.make_ep_train_step(
        m, o, stress._loss_fn, mesh, device="cpu"),
    "dp_ep": lambda m, o, mesh: P.make_dp_ep_train_step(
        m, o, stress._loss_fn, mesh, device="cpu"),
    "eval": lambda m, o, mesh: P.make_dp_eval_step(m, mesh, device="cpu"),
    "np_eval": lambda m, o, mesh: P.make_np_eval_step(m, mesh, device="cpu"),
    "ep_eval": lambda m, o, mesh: P.make_ep_eval_step(m, mesh, device="cpu"),
}


@pytest.mark.parametrize("maker", sorted(MAKERS))
def test_nccl_meshes_graph_the_steps_and_gloo_stays_eager(maker,
                                                         monkeypatch):
    """``parallel.dp.graphed_on`` takes a CUDA device over NCCL alone (not
    gloo, not the CPU); where it does, every step maker of dp.py,
    halo.py and edge_partition.py captures one ``_GraphedStep`` a bucket
    shape in thread-local mode and replays it (a recording stand-in here,
    with ``graphed_on`` told the CPU is a card), and the results equal the
    eager steps'; on gloo nothing is captured."""
    cuda = torch.device("cuda")
    nccl, gloo = P.make_mesh(1, 1, "nccl"), P.make_mesh(1, 1, "gloo")
    assert dp_lib.graphed_on(nccl, cuda)
    assert not dp_lib.graphed_on(gloo, cuda)
    assert not dp_lib.graphed_on(nccl, torch.device("cpu"))
    monkeypatch.setattr(state_lib, "_GraphedStep", _Recorder)
    monkeypatch.setattr(dp_lib, "graphed_on",
                        lambda mesh, dev: mesh.backend == "nccl")
    small = stress.dp_batches(2)
    from phc_gnn_torch.data import synthetic_batch
    from phc_gnn_torch.graph import attach_csr_plan
    other = attach_csr_plan(synthetic_batch(4, 128, 320, seed=5))
    results = {}
    for mesh in (gloo, nccl):
        _Recorder.made = []
        model = _small_model()
        opt = make_optimizer(dict(model.named_parameters()))
        step = MAKERS[maker](model, opt, mesh)
        train = not maker.endswith("eval")
        call = ((lambda b: step([b], stress.LR)[0][0])
                if maker.startswith("scan") else
                (lambda b: step(b, stress.LR)[0]) if train else step)
        outs = [call(b) for b in (small[0], small[1], other)]
        results[mesh.backend] = outs
        if mesh.backend == "gloo":
            assert _Recorder.made == []
        else:
            assert _Recorder.made == [
                (small[0].shape_key(), dp_lib.NCCL_CAPTURE_MODE),
                (other.shape_key(), dp_lib.NCCL_CAPTURE_MODE)]
    for got, want in zip(results["nccl"], results["gloo"]):
        assert torch.equal(got, want)
