"""The port's exported eval forward (``phc_gnn_torch/export.py``) against
JAX's (``scripts/export_model.py``), and the kernels' ``torch.library`` ops.

JAX's side is built as ``scripts/export_model.py:30-40`` builds it: the
batch's eight arrays as arguments, no scan plan (``jax.export`` cannot
serialise a ``GraphsTuple``), exported, serialised, deserialised and
called, once for the module.  The port exports the same weights
(``load_flax``) on the batch with its CSR plan, whose kernels' plain
versions run on the CPU.  Tolerance: 1e-4 normwise relative for the whole
model, as ``tests/test_torch_model.py``; the exported program against the
port's own eager forward and its saved copy, bit for bit.
"""

import collections
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax import export as jax_export
from torch.utils._python_dispatch import TorchDispatchMode

from phc_gnn_tpu.data import synthetic_batch as jax_synthetic_batch
from phc_gnn_tpu.graph.batch import GraphsTuple as JaxGraphsTuple
from phc_gnn_tpu.models import PHCGNN as JaxPHCGNN
from phc_gnn_torch import export
from phc_gnn_torch.data import (ZINC_ATOM_DIMS, ZINC_BOND_DIMS,
                                avg_deg_from_histogram, degree_histogram,
                                synthetic_batch, synthetic_graphs)
from phc_gnn_torch.graph import attach_csr_plan, build_csr_rowptr
from phc_gnn_torch.models import PHCGNN, presets
from phc_gnn_torch.ops import fused_whitening as fw
from phc_gnn_torch.ops import segment_reduce as sr
from phc_gnn_torch.ops import segment_softmax as ss
from phc_gnn_torch.ops import segment_sum as ssum
from phc_gnn_torch.train import make_eval_step
from phc_gnn_torch.train.config import DATASET_DEFAULTS, ExperimentConfig
from phc_gnn_torch.train.trainer import build_model
from torch_parity import (adversarial_receivers, assert_close, load_flax,
                          randomize, spd_cov)
from torch_threads import one_torch_thread  # noqa: F401

REL = 1e-4
SHAPE = (8, 256, 512)
JAX_FIELDS = ("nodes", "edges", "senders", "receivers", "graph_ids",
              "node_mask", "edge_mask", "graph_mask")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config(dim=32, layers=2, **over):
    return {**export.flagship_config(dim, layers), **over}


@pytest.fixture(scope="module")
def jax_export_run():
    """``(variables, output)``: JAX's tiny flagship exported as
    ``scripts/export_model.py`` exports it, serialised, deserialised and
    called on the batch's eight arrays."""
    jm = JaxPHCGNN(**_config())
    jb = jax_synthetic_batch(*SHAPE, seed=3)
    init = jax.jit(lambda key, b: jm.init(key, b, training=False))
    v = randomize(init(jax.random.key(0), jb), seed=3)

    def forward(variables, *arrays):
        b = JaxGraphsTuple(**dict(zip(JAX_FIELDS, arrays)), y=None)
        return jm.apply(variables, b, training=False)

    args = (v,) + tuple(getattr(jb, f) for f in JAX_FIELDS)
    blob = jax_export.export(jax.jit(forward))(*args).serialize()
    return v, np.asarray(jax_export.deserialize(blob).call(*args))


@pytest.fixture(scope="module")
def tiny(jax_export_run):
    """The port's tiny flagship at JAX's variables, its CSR-planned batch
    and its exported program."""
    model = load_flax(PHCGNN(**_config(), device="cpu"), jax_export_run[0])
    batch = attach_csr_plan(synthetic_batch(*SHAPE, seed=3))
    return model, batch, export.export_forward(model, batch)


def _phc_gnn_calls(program) -> dict:
    """Count of each ``phc_gnn::`` op called in ``program``'s graph."""
    counts: dict = {}
    for node in program.graph.nodes:
        name = str(node.target)
        if node.op == "call_function" and name.startswith("phc_gnn."):
            counts[name] = counts.get(name, 0) + 1
    return counts


class _OpCounts(TorchDispatchMode):
    """Counts each aten or ``phc_gnn::`` op that reaches the dispatcher."""

    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[str(func)] += 1
        return func(*args, **(kwargs or {}))


def _ops_beyond_eager(model, program, batch) -> dict:
    """The ops one call of ``program`` runs more often than one eager eval
    of ``model``, but for ``_assert_tensor_metadata``, the exported graph's
    check of its inputs, which computes nothing: what the program would
    launch on the card that the eager forward does not."""
    eager = make_eval_step(model, device="cpu")
    module, args = program.module(), export.forward_args(batch)
    with torch.inference_mode():
        with _OpCounts() as want:
            eager(batch)
        with _OpCounts() as got:
            module(*args)
    extra = got.counts - want.counts
    del extra["aten._assert_tensor_metadata.default"]
    return dict(extra)


def test_exported_flagship_matches_jax_export(jax_export_run, tiny):
    model, batch, program = tiny
    got = program.module()(*export.forward_args(batch))
    assert got.shape == jax_export_run[1].shape == (SHAPE[0] + 1, 1)
    assert_close(got, jax_export_run[1], REL)
    assert torch.equal(got, make_eval_step(model, device="cpu")(batch))
    assert _ops_beyond_eager(model, program, batch) == {}


def test_saved_program_round_trips_bit_equal(tiny, tmp_path):
    """``save`` then ``load`` gives the same output bit for bit; the graph
    calls A fused into B once a layer and no other kernel; in a fresh
    process that
    imports only ``phc_gnn_torch.export``, the loaded program runs without
    ``phc_gnn_torch.models``."""
    _, batch, program = tiny
    args = export.forward_args(batch)
    path = tmp_path / "fwd.pt2"
    assert export.save(program, path) == path.stat().st_size > 0
    back = export.load(path)
    want = program.module()(*args)
    with torch.no_grad():
        assert torch.equal(back.module()(*args), want)
    assert _phc_gnn_calls(back) == {
        "phc_gnn.segment_softmax_fused.default": 2}

    torch.save(args, tmp_path / "args.pt")
    script = (
        "import sys, torch\n"
        "from phc_gnn_torch import export\n"
        "args = torch.load(sys.argv[2])\n"
        "with torch.no_grad():\n"
        "    out = export.load(sys.argv[1]).module()(*args)\n"
        "assert 'phc_gnn_torch.models' not in sys.modules\n"
        "torch.save(out, sys.argv[3])\n")
    subprocess.run([sys.executable, "-c", script, str(path),
                    str(tmp_path / "args.pt"), str(tmp_path / "out.pt")],
                   cwd=REPO, check=True, timeout=120)
    assert torch.equal(torch.load(tmp_path / "out.pt"), want)


def _op_cases():
    """``(op, args)`` of every kernel op an eval forward calls, on the
    adversarial CSR: an isolated node, a segment of 1,100 edges, an
    all-masked segment and a masked padding tail."""
    recv, mask, n = adversarial_receivers(5)
    rng = np.random.default_rng(5)
    d = 8
    msgs = torch.from_numpy(rng.normal(size=(recv.shape[0], d))
                            .astype(np.float32))
    mask = torch.from_numpy(mask)
    rowptr = torch.from_numpy(build_csr_rowptr(recv, n, mask.numpy()))
    beta = torch.tensor(-1.5)
    segmax = ss.segment_logit_max_plain(msgs, mask, beta, rowptr)
    bf16 = msgs.bfloat16()
    x = torch.from_numpy(rng.normal(size=(n, 4 * d)).astype(np.float32))
    cov = torch.from_numpy(spd_cov(rng, d).astype(np.float32))
    gamma = torch.eye(4)[:, :, None].repeat(1, 1, d) + 0.1 * torch.from_numpy(
        rng.normal(size=(4, 4, d)).astype(np.float32))
    mean, fbeta = (torch.from_numpy(rng.normal(size=(4, d)).astype(np.float32))
                   for _ in range(2))
    ops = torch.ops.phc_gnn
    return [
        (ops.segment_logit_max, (msgs, mask, beta, rowptr)),
        (ops.segment_softmax_aggregate, (msgs, mask, beta, rowptr, segmax)),
        (ops.segment_softmax_aggregate_train,
         (msgs, mask, beta, rowptr, segmax)),
        (ops.segment_softmax_fused, (msgs, mask, beta, rowptr)),
        (ops.segment_softmax_fused_train, (msgs, mask, beta, rowptr)),
        (ops.segment_softmax_fused, (bf16, mask, beta, rowptr)),
        (ops.segment_softmax_fused_train, (bf16, mask, beta, rowptr)),
        (ops.segment_sum_masked, (msgs, mask, rowptr)),
        (ops.segment_sum_masked, (bf16, mask, rowptr)),
        (ops.segment_extreme, (msgs, mask, rowptr, False)),
        (ops.segment_extreme, (msgs, mask, rowptr, True)),
        (ops.segment_moments, (msgs, mask, rowptr)),
        (ops.wbn_transform_eval, (x, mean, cov, gamma, fbeta, 1e-5)),
    ]


def test_kernel_ops_pass_opcheck_on_the_cpu():
    """``torch.library.opcheck`` of each op (its schema, its autograd
    registration, its fake implementation against the plain version, and
    its trace under ``aot_dispatch``), and each public wrapper dispatching
    through its op to the plain version."""
    cases = _op_cases()
    assert {op._qualified_op_name.split("::")[1] for op, _ in cases} == {
        "segment_logit_max", "segment_softmax_aggregate",
        "segment_softmax_aggregate_train", "segment_softmax_fused",
        "segment_softmax_fused_train", "segment_sum_masked",
        "segment_extreme", "segment_moments", "wbn_transform_eval"}
    for op, args in cases:
        result = torch.library.opcheck(op, args)
        assert set(result.values()) == {"SUCCESS"}, (op, result)
    msgs, mask, beta, rowptr, segmax = cases[1][1]
    x, mean, cov, gamma, fbeta, eps = cases[-1][1]
    for got, want in (
            (ss.segment_logit_max(msgs, mask, beta, rowptr), segmax),
            (ss.segment_softmax_aggregate(msgs, mask, beta, rowptr, segmax,
                                          emit_w=True),
             ss.segment_softmax_aggregate_plain(msgs, mask, beta, rowptr,
                                                segmax, emit_w=True)),
            (ssum.segment_sum_masked(msgs, mask, rowptr),
             ssum.segment_sum_masked_plain(msgs, mask, rowptr)),
            (sr.segment_extreme(msgs, mask, rowptr, True),
             sr.segment_extreme_plain(msgs, mask, rowptr, True)),
            (sr.segment_moments(msgs, mask, rowptr),
             sr.segment_moments_plain(msgs, mask, rowptr)),
            (fw.wbn_transform_eval(x, mean, cov, gamma, fbeta, eps),
             fw.wbn_transform_eval_plain(x, mean, cov, gamma, fbeta, eps))):
        for g, w in zip(*(t if isinstance(t, tuple) else (t,)
                          for t in (got, want))):
            assert torch.equal(g, w)


def test_export_refuses_what_it_cannot_serve(tmp_path):
    """A batch without its CSR plan raises (its program would hold the
    composites, not the kernels); the command raises on a box without a
    card unless given ``--device cpu``."""
    model = PHCGNN(**_config(16, 1), device="cpu")
    batch = synthetic_batch(*SHAPE, seed=3)
    with pytest.raises(ValueError, match="attach_csr_plan"):
        export.export_forward(model, batch)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            export.main([str(tmp_path / "fwd.pt2")])
    assert not (tmp_path / "fwd.pt2").exists()


def _family(name):
    if name == "quat":
        cfg = _config(16, 2, norm_mp="q-batch-norm")
        del cfg["phm_dim"]
        return presets.QuaternionSkipConnectAdd(**cfg, seed=0, device="cpu")
    cfg = ExperimentConfig(**{
        **DATASET_DEFAULTS["zinc"], "aggr_msg": "pna", "sc_type": "last",
        "phm_dim": 4, "input_embed_dim": 16, "mp_units": (16, 16),
        "d_units": (16, 8), "dropout_mpnn": (0.0, 0.0)})
    avg_deg = avg_deg_from_histogram(degree_histogram(synthetic_graphs(
        SHAPE[0], seed=0)))
    return build_model(cfg, ZINC_ATOM_DIMS, ZINC_BOND_DIMS, avg_deg=avg_deg,
                       seed=0, device="cpu")


@pytest.mark.parametrize("family,calls", [
    ("quat", {"phc_gnn.wbn_transform_eval.default": 4,
              "phc_gnn.segment_softmax_fused.default": 2}),
    ("pna", {"phc_gnn.segment_sum_masked.default": 2,
             "phc_gnn.segment_extreme.default": 4,
             "phc_gnn.segment_moments.default": 2})])
def test_family_exports_match_their_eager_eval(family, calls):
    """The quaternion preset with whitening (K's eval route) and PNA (C's
    masked role, H, I), random running stats, exported: bit-equal to their
    eager eval on the CPU, each kernel op called as the eager forward
    launches it."""
    model = _family(family)
    rng = np.random.default_rng(2)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith(".cov"):
                buf.copy_(torch.from_numpy(spd_cov(rng, buf.shape[-1])))
            elif name.endswith((".mean", ".var")):
                buf.copy_(torch.from_numpy(rng.uniform(
                    0.5, 1.5, buf.shape).astype(np.float32)))
    batch = attach_csr_plan(synthetic_batch(*SHAPE, seed=4))
    program = export.export_forward(model, batch)
    assert _phc_gnn_calls(program) == calls
    got = program.module()(*export.forward_args(batch))
    assert torch.equal(got, make_eval_step(model, device="cpu")(batch))
    assert _ops_beyond_eager(model, program, batch) == {}
