"""The port under ``compute_dtype=torch.bfloat16`` against the JAX package
under ``compute_dtype=jnp.bfloat16``, on the CPU at small size.

JAX keeps its parameters float32 and runs its activations in bf16
(tests/test_bf16.py holds its bf16 model to its f32 one); the port follows
it cast for cast.  The aggregation kernels read bf16 messages and return
float32: A, B and C on the card, their plain versions here, which upcast
first; JAX's Pallas kernels run in interpret mode over their scan plans.

- The modules that hold a kernel: the softmax aggregation (A, B), the sum
  and mean aggregations (C's forward role) and the message gather (C's
  backward role), fed the same bf16 messages.  Their float32 outputs agree
  within ``REL`` 1e-5 normwise (f32 sums in other orders); their bf16
  cotangents within ``BF16_ULP`` 2^-7 of the leaf's largest entry: one bf16
  rounding step, taken where the two sides' f32 values straddle a rounding
  boundary.
- Whole models (the flagship's softmax GINE, the pcba-shaped ``PHMConv``
  sum with ``sc_type="first"``, PNA, the quaternion whitening model; width
  32, 2 layers, ``synthetic_batch(8, 256, 512)``; JAX op by op, not
  jitted, so that it rounds to bf16 after each op as the port does): the
  eval output, the training output, loss and every gradient leaf, the
  port's bf16 distance from JAX's bf16 within ``FACTOR`` 0.5 of JAX bf16's
  own distance from JAX f32 (measured: outputs and losses at most 4e-5 of
  it but for PNA's training forward, 0.16 of it on the output and 0.32 on
  the loss, where the std aggregation's ``E[m^2] - E[m]^2`` amplifies
  single bf16 rounding steps in the second layer; gradients, as the
  largest leaf distance, at most 0.11 of it).  Gradient leaves whose f32
  value is below 1e-5 of the largest are rounding noise (the biases that a
  batch norm follows) and are left out.  Both bf16 outputs lie within
  tests/test_bf16.py's 0.05 of JAX's f32 one.
- One ``--compute_dtype bf16`` training run of the ZINC recipe through the
  CLI, both sides with ``--agg_kernel stream`` (JAX's CPU default, the XLA
  composite, sums bf16 messages in bf16 to a bf16 result; the stream
  kernels, as on a TPU and in the port, return float32): the rows' epochs
  and lrs equal, each epoch's train loss finite, falling and within
  tests/test_bf16.py's 0.05 of JAX's (measured at most 2.1e-2: bf16 noise
  in the gradients of the biases that a batch norm follows becomes +-lr
  steps, as in f32, only larger); and JAX's final state evaluated by the
  port in bf16 within ``FACTOR`` of the distance of the port's f32 eval of
  the same state from JAX's bf16 numbers (measured 0.21 and 0.04 of it on
  the valid loss and the last test MAE; JAX's jitted eval fuses bf16 ops
  and skips some of the roundings the port takes).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

import phc_gnn_tpu.nn.norm as jnorm
from benchmarks import common as jcli
from phc_gnn_tpu.data import synthetic_batch as jax_synthetic_batch
from phc_gnn_tpu.models import PHCGNN as JaxPHCGNN
from phc_gnn_tpu.ops.stream_scan import (STREAMED_AGGREGATORS,
                                         attach_scan_plan, build_scan_plan,
                                         build_sender_plan,
                                         gather_nodes_streamed,
                                         softmax_aggregate_streamed)
from phc_gnn_torch.cli import common as tcli
from phc_gnn_torch.convert import from_flax_variables
from phc_gnn_torch.data import ZINC_ATOM_DIMS, ZINC_BOND_DIMS, synthetic_batch
from phc_gnn_torch.graph import (attach_csr_plan, build_csr_rowptr,
                                 build_sender_csr, conv)
from phc_gnn_torch.models import PHCGNN
from phc_gnn_torch.ops import segment_softmax as ss
from phc_gnn_torch.ops import segment_sum as ssum
from test_torch_quat import randomize_quat
from test_torch_segment_softmax import CASES as SOFTMAX_CASES
from test_torch_trainer import (NO_DROPOUT, SMALL, _init_pickle, _json, _rel,
                                _rows)
from torch_parity import (adversarial_receivers, assert_close,
                          assert_leaf_close, numpy_tree, port_flat)
from torch_threads import one_torch_thread  # noqa: F401

REL = 1e-5
BF16_ULP = 2.0 ** -7
FACTOR = 0.5
F32_BOUND = 0.05  # tests/test_bf16.py's bf16-against-f32 bound
SHAPE = (8, 256, 512)
DIM, LAYERS = 32, 2
BASE = dict(atom_input_dims=ZINC_ATOM_DIMS, bond_input_dims=ZINC_BOND_DIMS,
            atom_encoded_dim=DIM, mp_layers=(DIM,) * LAYERS,
            dropout_mpnn=(0.0,) * LAYERS, target_dim=1, dropout_dn=(0.0, 0.0))
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


def _bf16_values(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to bf16 and held as float32, so that both frameworks'
    bf16 tensors made from it are the same exactly."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def test_plain_versions_take_bf16():
    """The wrappers' plain versions fed bf16 rows on the CPU give float32,
    equal to their own result on the upcast rows: they sum in float32 as
    the kernels do, not in bf16 as torch's ``index_add_`` would."""
    recv, mask, n = adversarial_receivers(2)
    rng = np.random.default_rng(2)
    m = torch.from_numpy(rng.normal(size=(recv.shape[0], 24)).astype(
        np.float32)).to(torch.bfloat16)
    k, rowptr = torch.from_numpy(mask), torch.from_numpy(
        build_csr_rowptr(recv, n, mask))
    beta = torch.tensor(1.3)
    pairs = [
        (ss.segment_logit_max(m, k, beta, rowptr),
         ss.segment_logit_max(m.float(), k, beta, rowptr)),
        (ssum.segment_sum_masked(m, k, rowptr),
         ssum.segment_sum_masked(m.float(), k, rowptr)),
        (ssum.segment_sum_perm(m, torch.from_numpy(recv), rowptr),
         ssum.segment_sum_perm(m.float(), torch.from_numpy(recv), rowptr))]
    smax = pairs[0][1]
    for got, want in zip(
            ss.segment_softmax_aggregate(m, k, beta, rowptr, smax, True),
            ss.segment_softmax_aggregate(m.float(), k, beta, rowptr, smax,
                                         True)):
        pairs.append((got, want))
    for got, want in pairs:
        assert got.dtype == torch.float32
        assert torch.equal(got, want)
    # a long segment: a bf16 sum would have lost the small rows
    lo, hi = int(rowptr[7]), int(rowptr[8])
    big = ssum.segment_sum_masked(m, k, rowptr)[7]
    exact = m.double()[lo:hi][k[lo:hi]].sum(0)
    assert float((big.double() - exact).abs().max()) <= 1e-4 * float(
        exact.abs().max())


@pytest.mark.parametrize("case", ["synthetic0", "adversarial0"])
def test_softmax_aggregation_bf16_matches_jax(case):
    """A and B on bf16 messages (plain versions) and the closed-form
    backward, against ``softmax_aggregate_streamed`` on the same bf16
    messages: the f32 output, the bf16 ``dm`` and the f32 ``dbeta``."""
    msgs, recv, mask, n, beta = SOFTMAX_CASES[case]()
    msgs = _bf16_values(msgs)
    flags, cont, last = map(jnp.asarray, build_scan_plan(recv, n,
                                                         edge_mask=mask))
    g = np.random.default_rng(5).normal(size=(n, msgs.shape[1])).astype(
        np.float32)

    def f(m, b):
        out = softmax_aggregate_streamed(
            m, jnp.asarray(recv), flags, cont, last, n, b,
            edge_mask=jnp.asarray(mask))
        return jnp.sum(out * g), out

    (_, out_j), (dm_j, db_j) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(jnp.asarray(msgs, jnp.bfloat16),
                                         jnp.float32(beta))
    m = torch.tensor(msgs).to(torch.bfloat16).requires_grad_()
    b = torch.tensor(beta, requires_grad=True)
    out = conv._softmax_aggr(m, torch.from_numpy(recv), n, b,
                             torch.from_numpy(mask), torch.from_numpy(
                                 build_csr_rowptr(recv, n, mask)))
    assert out.dtype == torch.float32 and out_j.dtype == jnp.float32
    assert_close(out, np.asarray(out_j), REL)
    (out * torch.from_numpy(g)).sum().backward()
    assert m.grad.dtype == torch.bfloat16 and dm_j.dtype == jnp.bfloat16
    assert_leaf_close(m.grad.float(), np.asarray(dm_j, np.float32), BF16_ULP,
                      "dmsgs")
    # dbeta sums E x D signed terms that cancel (|beta * m| up to 88 in the
    # adversarial case): its f32 rounding scales with the sum of |terms|,
    # as in tests/test_torch_segment_softmax.py
    assert b.grad.dtype == torch.float32
    k, r = torch.from_numpy(mask), torch.from_numpy(recv).long()
    rowptr = torch.from_numpy(build_csr_rowptr(recv, n, mask))
    md = m.detach().double()
    smax = ss.segment_logit_max_plain(md, k, b.detach(), rowptr)
    out, w, den = ss.segment_softmax_aggregate_plain(md, k, b.detach(),
                                                     rowptr, smax, True)
    gd = torch.from_numpy(g).double()[r]
    terms = (w.double() / den.double()[r]) * md * (md * gd
                                                   - out.double()[r] * gd)
    err = abs(float(b.grad) - float(db_j))
    assert err <= REL * float(terms.abs().sum()), (err, float(db_j))


@pytest.mark.parametrize("aggr", ["sum", "mean"])
def test_sum_aggregation_bf16_matches_jax(aggr):
    """C's forward role on bf16 messages (the sum, and the mean's sum)
    against JAX's streamed ``sum`` / ``mean`` on the same bf16 messages: the
    f32 output and the bf16 gradient."""
    recv, mask, n = adversarial_receivers(3)
    rng = np.random.default_rng(3)
    msgs = _bf16_values(rng.normal(size=(recv.shape[0], 24)).astype(
        np.float32))
    g = rng.normal(size=(n, 24)).astype(np.float32)
    flags, cont, last = map(jnp.asarray, build_scan_plan(recv, n, 128,
                                                         edge_mask=mask))
    out_j, vjp = jax.vjp(lambda m_: STREAMED_AGGREGATORS[aggr](
        m_, jnp.asarray(recv), flags, cont, last, n, jnp.asarray(mask)),
        jnp.asarray(msgs, jnp.bfloat16))
    (dm_j,) = vjp(jnp.asarray(g))
    m = torch.tensor(msgs).to(torch.bfloat16).requires_grad_()
    out = conv._fixed_aggr(m, torch.from_numpy(recv), n,
                           torch.from_numpy(mask), aggr,
                           torch.from_numpy(build_csr_rowptr(recv, n, mask)))
    assert out.dtype == torch.float32 and out_j.dtype == jnp.float32
    assert_close(out, np.asarray(out_j), REL)
    out.backward(torch.from_numpy(g))
    assert m.grad.dtype == torch.bfloat16 and dm_j.dtype == jnp.bfloat16
    assert_leaf_close(m.grad.float(), np.asarray(dm_j, np.float32), BF16_ULP,
                      "dmsgs")


def test_gather_backward_bf16_matches_jax():
    """C's backward role: the gather of bf16 node rows, whose bf16
    cotangent the port sums in C's bf16 instance (JAX casts it to f32
    first), against ``gather_nodes_streamed``: dx in bf16."""
    senders, mask, n = adversarial_receivers(4)
    rng = np.random.default_rng(4)
    senders = rng.permutation(senders).astype(np.int32)
    x = _bf16_values(rng.normal(size=(n, 24)).astype(np.float32))
    g = _bf16_values(rng.normal(size=(senders.shape[0], 24)).astype(
        np.float32))
    plan = tuple(map(jnp.asarray, build_sender_plan(senders, n,
                                                    edge_mask=mask)))
    y_j, vjp = jax.vjp(lambda x_: gather_nodes_streamed(
        x_, jnp.asarray(senders), *plan), jnp.asarray(x, jnp.bfloat16))
    (dx_j,) = vjp(jnp.asarray(g, jnp.bfloat16))
    perm, rowptr = (torch.from_numpy(a) for a in
                    build_sender_csr(senders, n, mask))
    xt = torch.tensor(x).to(torch.bfloat16).requires_grad_()
    y = ssum.gather_nodes(xt, torch.from_numpy(senders), perm, rowptr)
    np.testing.assert_array_equal(y.detach().float().numpy(),
                                  np.asarray(y_j, np.float32))
    y.backward(torch.tensor(g).to(torch.bfloat16))
    assert xt.grad.dtype == torch.bfloat16 and dx_j.dtype == jnp.bfloat16
    assert_leaf_close(xt.grad.float(), np.asarray(dx_j, np.float32),
                      BF16_ULP, "dx")


def _jax_train(model, variables, batch):
    """(loss, output, gradients) of JAX's model in training, op by op: the
    mean |out - 0.3| and its gradient in the params."""
    def f(p):
        out, _ = model.apply({"params": p,
                              "batch_stats": variables["batch_stats"]},
                             batch, training=True, mutable=["batch_stats"])
        return jnp.mean(jnp.abs(out.astype(jnp.float32) - 0.3)), out
    (loss, out), g = jax.value_and_grad(f, has_aux=True)(
        variables["params"])
    return float(loss), np.asarray(out), port_flat(numpy_tree(g))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_bf16_matches_jax(name, monkeypatch):
    """The eval output, and the training output, loss and gradients, of the
    port's bf16 model against JAX's bf16 model, within ``FACTOR`` of JAX
    bf16's distance from JAX f32; parameters, gradients and the output
    float32 and finite."""
    monkeypatch.setattr(jnorm, "_FORCE_FUSED_INTERPRET", True)
    cfg = {**BASE, **MODELS[name]}
    jb = attach_scan_plan(jax_synthetic_batch(*SHAPE, seed=3),
                          block_edges=128)
    j32 = JaxPHCGNN(**cfg)
    j16 = JaxPHCGNN(**cfg, compute_dtype=jnp.bfloat16)
    variables = randomize_quat(j32.init(jax.random.key(0), jb,
                                        training=False), seed=3)
    model = PHCGNN(**cfg, compute_dtype=torch.bfloat16, device="cpu")
    assert all(p.dtype == torch.float32 for p in model.parameters())
    model.load_state_dict(from_flax_variables(variables, model))
    batch = attach_csr_plan(synthetic_batch(*SHAPE, seed=3))

    def hold_out(out, o16, o32):
        assert out.dtype == torch.float32 and o16.dtype == np.float32
        scale = np.abs(o32).max()
        own = np.abs(o16 - o32).max() / scale
        assert own <= F32_BOUND
        out = out.detach().numpy()
        assert np.abs(out - o32).max() / scale <= F32_BOUND
        assert np.abs(out - o16).max() / scale <= FACTOR * own

    with torch.no_grad():
        hold_out(model(batch), np.asarray(j16.apply(variables, jb)),
                 np.asarray(j32.apply(variables, jb)))
    l32, o32, g32 = _jax_train(j32, variables, jb)
    l16, o16, g16 = _jax_train(j16, variables, jb)
    out = model(batch, training=True,
                generator=torch.Generator().manual_seed(0))
    hold_out(out, o16, o32)
    loss = (out - 0.3).abs().mean()
    assert abs(loss.item() - l16) <= FACTOR * abs(l16 - l32)
    grads = dict(zip([k for k, _ in model.named_parameters()],
                     torch.autograd.grad(loss, list(model.parameters()))))
    top = max(float(np.abs(g).max()) for g in g32.values())
    port_d = own_d = 0.0
    for k, g in grads.items():
        assert g.dtype == torch.float32 and torch.isfinite(g).all(), k
        s = float(np.abs(g32[k]).max())
        if s <= 1e-5 * top:
            continue
        port_d = max(port_d, float(np.abs(g.numpy() - g16[k]).max()) / s)
        own_d = max(own_d, float(np.abs(g16[k] - g32[k]).max()) / s)
    assert port_d <= FACTOR * own_d, (port_d, own_d)


def _restore_jax(save_dir, name):
    return ocp.StandardCheckpointer().restore(
        os.path.abspath(os.path.join(save_dir, "run_1", "ckpt", name)))


def test_cli_bf16_matches_jax(tmp_path):
    """``--compute_dtype bf16`` through both CLIs on the ZINC fixtures, 3
    epochs from one ``init_from`` pickle."""
    argv = SMALL + NO_DROPOUT + ["--epochs", "3", "--agg_kernel", "stream",
                                 "--init_from", _init_pickle(tmp_path)]
    bf16 = ["--compute_dtype", "bf16"]
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jcli.run_benchmark("zinc", argv + bf16 + ["--save_dir", jdir])
    tcli.run_benchmark("zinc", argv + bf16 + ["--save_dir", tdir,
                                              "--device", "cpu"])
    got, want = _rows(tdir), _rows(jdir)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g["epoch"] == w["epoch"] and g["lr"] == w["lr"]
        assert np.isfinite(g["train_loss"]) and np.isfinite(g["valid_loss"])
        assert _rel(g["train_loss"], w["train_loss"]) <= F32_BOUND, (g, w)
    assert got[-1]["train_loss"] < got[0]["train_loss"]
    want_vt = _json(os.path.join(jdir, "run_1", "val_test.json"))
    final = _restore_jax(jdir, "3/default")
    variables = {c: final[c] for c in ("params", "batch_stats")}
    evals = {}
    for dtype in ("bf16", "f32"):
        trainer = tcli.build_trainer("zinc", tcli.get_parser("zinc").parse_args(
            argv + ["--compute_dtype", dtype, "--device", "cpu",
                    "--save_dir", str(tmp_path / f"eval_{dtype}")]))
        trainer.model.load_state_dict(from_flax_variables(variables,
                                                          trainer.model))
        evals[dtype] = (trainer.evaluate(trainer.valid_batches())["loss"],
                        trainer.evaluate(trainer.test_batches())["mae"])
    for i, ref in enumerate((want[-1]["valid_loss"], want_vt["test_last"])):
        port, witness = evals["bf16"][i], evals["f32"][i]
        assert _rel(port, ref) <= FACTOR * _rel(witness, ref), (i, port,
                                                                witness, ref)
    with open(os.path.join(tdir, "params.json")) as f:
        assert json.load(f)["compute_dtype"] == "bf16"
