"""The port's encoders (``phc_gnn_torch/nn/encoder.py``) against their flax
counterparts (``phc_gnn_tpu/nn/encoder.py``), with the flax weights carried
over by ``convert.from_flax_variables`` and inputs from numpy seeds.

The sum of embeddings is a one-hot product over the concatenated tables on
both sides; indices past either end of a vocabulary must be clipped into the
column's own table.  ``combine="concat"`` follows ``jnp.take``: a negative
index counts from the end and one outside ``[-vocab, vocab)`` gives NaN.

Tolerances: ``REL_FWD`` 1e-6 normwise relative for forwards (each output is a
sum of a few table rows, or one dense layer, in f32 on both sides);
``REL_GRAD`` 1e-5 per leaf, scaled by the leaf's own max |grad|, for the
tables' gradients (sums of the cotangent's rows, in other orders); the whole
model's eval forward 1e-4 normwise, as ``tests/test_torch_model.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phc_gnn_tpu.data import synthetic_batch as jax_synthetic_batch
from phc_gnn_tpu.models import PHCGNN as JaxPHCGNN
from phc_gnn_tpu.nn import encoder as jenc
from phc_gnn_tpu.ops.stream_scan import attach_scan_plan
from phc_gnn_torch.convert import from_flax_variables
from phc_gnn_torch.data import ZINC_ATOM_DIMS, ZINC_BOND_DIMS, synthetic_batch
from phc_gnn_torch.graph import attach_csr_plan
from phc_gnn_torch.models import PHCGNN
from phc_gnn_torch.nn import IntegerEncoder, NaivePHMEncoder, PHMEncoder
from phc_gnn_torch.train import make_eval_step
from torch_parity import (assert_close, assert_leaf_close, numpy_tree,
                          port_flat, randomize)
from torch_threads import one_torch_thread  # noqa: F401

REL_FWD = 1e-6
REL_GRAD = 1e-5
REL_MODEL = 1e-4
DIMS = (28, 5, 7)
N4 = 4


def _indices(rows, seed, dims=DIMS, lo=-3, hi=4):
    """int32 [rows, F]: column i in ``[lo, dims[i] + hi)``, so some indices
    lie past either end of their vocabulary."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(lo, v + hi, rows) for v in dims],
                    1).astype(np.int32)


def _port(module, variables):
    module.load_state_dict(from_flax_variables(numpy_tree(variables), module))
    return module


def _grads_match(jm, v, tm, x, g):
    """The gradient of every parameter of ``jm`` (flax) and ``tm`` (the
    port) under the cotangent ``g`` of the output at input ``x``."""
    _, vjp = jax.vjp(lambda p: jm.apply({"params": p}, jnp.asarray(x)),
                     v["params"])
    want = port_flat(numpy_tree(vjp(jnp.asarray(g))[0]))
    out = tm(torch.from_numpy(x))
    grads = torch.autograd.grad(out, list(tm.parameters()),
                                torch.from_numpy(g))
    names = [k for k, _ in tm.named_parameters()]
    assert set(names) == set(want)
    for key, grad in zip(names, grads):
        assert_leaf_close(grad, want[key], REL_GRAD, key)


@pytest.mark.parametrize("combine", ["sum", "concat"])
def test_integer_encoder_matches_flax(combine):
    """Forward and the gradient of every table; indices past either end of
    each vocabulary (the sum clips each into its own table; concat gives
    NaN outside ``[-vocab, vocab)``, as ``jnp.take``)."""
    x = _indices(60, seed=1, lo=-9 if combine == "concat" else -3)
    jm = jenc.IntegerEncoder(out_dim=8, input_dims=DIMS, combine=combine)
    v = jm.init(jax.random.key(1), jnp.asarray(x))
    tm = _port(IntegerEncoder(8, DIMS, combine), v)
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    got = tm(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (60, 8 * (len(DIMS) if combine ==
                                                 "concat" else 1))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    if combine == "concat":
        assert np.isnan(want).any()  # the input reaches past [-vocab, vocab)
    ok = ~np.isnan(want)
    assert_close(got[ok], want[ok], REL_FWD)
    g = np.random.default_rng(2).normal(size=want.shape).astype(np.float32)
    _grads_match(jm, v, tm, x, g)


def test_sum_clips_into_the_columns_own_table():
    """An index past either end of column i reads column i's first or last
    row, and never a neighbouring table's: the one-hot sum equals the sum
    of clipped per-column lookups."""
    tm = IntegerEncoder(4, DIMS, generator=torch.Generator().manual_seed(0))
    x = torch.tensor([[-5, 5, 7], [28, -1, 99], [27, 0, 6]], dtype=torch.int32)
    want = sum(getattr(tm, f"embedding_{i}")[x[:, i].clamp(0, v - 1).long()]
               for i, v in enumerate(DIMS))
    assert_close(tm(x).detach(), want.detach().numpy(), REL_FWD)


def test_linear_encoder_from_flax_and_its_init():
    """The continuous-input encoder, a dense layer ``linear``: flax's kernel
    lands transposed in ``weight``, the outputs agree; the port's own init
    is centred uniform within 1/sqrt(fan_in), as JAX's."""
    x = np.random.default_rng(3).normal(size=(40, 6)).astype(np.float32)
    jm = jenc.PHMEncoder(out_dim=8, input_dims=6, phm_dim=N4)
    v = jm.init(jax.random.key(3), jnp.asarray(x))
    tm = _port(PHMEncoder(8, 6, N4), v)
    np.testing.assert_array_equal(
        tm.encoder_1.linear.weight.detach().numpy(),
        np.asarray(v["params"]["encoder_1"]["linear"]["kernel"]).T)
    assert_close(tm(torch.from_numpy(x)).detach(),
                 np.asarray(jm.apply(v, jnp.asarray(x))), REL_FWD)
    fresh = PHMEncoder(50, 64, N4, generator=torch.Generator().manual_seed(0))
    for t in (fresh.encoder_0.linear.weight, fresh.encoder_0.linear.bias):
        t = t.detach()
        assert float(t.abs().max()) <= 1 / 8
        assert abs(float(t.mean())) < 0.01
        assert float(t.abs().max()) > 0.9 / 8


@pytest.mark.parametrize("kind", ["sum", "concat", "linear"])
def test_phm_encoder_matches_flax(kind):
    """n independent encoders stacked to [N, n, d], forward and gradients;
    the sum's one GEMM against the components' tables side by side."""
    combine = "concat" if kind == "concat" else "sum"
    dims = 6 if kind == "linear" else DIMS
    x = (np.random.default_rng(4).normal(size=(50, 6)).astype(np.float32)
         if kind == "linear" else _indices(50, seed=4, lo=0, hi=0))
    jm = jenc.PHMEncoder(out_dim=8, input_dims=dims, phm_dim=N4,
                         combine=combine)
    v = jm.init(jax.random.key(4), jnp.asarray(x))
    tm = _port(PHMEncoder(8, dims, N4, combine), v)
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    got = tm(torch.from_numpy(x))
    assert got.shape == want.shape
    assert_close(got.detach(), want, REL_FWD)
    g = np.random.default_rng(5).normal(size=want.shape).astype(np.float32)
    _grads_match(jm, v, tm, x, g)


def test_phm_encoder_one_gemm_equals_the_component_stack():
    """The fused product equals the stack of each component's own encoder,
    out-of-range indices included."""
    tm = PHMEncoder(8, DIMS, N4, generator=torch.Generator().manual_seed(1))
    x = torch.from_numpy(_indices(70, seed=6))
    want = torch.stack([getattr(tm, f"encoder_{c}")(x) for c in range(N4)], 1)
    assert_close(tm(x).detach(), want.detach().numpy(), REL_FWD)


@pytest.mark.parametrize("kind", ["sum", "linear"])
def test_naive_phm_encoder_matches_flax(kind):
    """One encoder named ``encoder`` broadcast to the n components."""
    dims = 6 if kind == "linear" else DIMS
    x = (np.random.default_rng(7).normal(size=(30, 6)).astype(np.float32)
         if kind == "linear" else _indices(30, seed=7))
    jm = jenc.NaivePHMEncoder(out_dim=8, input_dims=dims, phm_dim=N4)
    v = jm.init(jax.random.key(7), jnp.asarray(x))
    tm = _port(NaivePHMEncoder(8, dims, N4), v)
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    got = tm(torch.from_numpy(x))
    assert got.shape == want.shape == (30, N4, 8)
    assert_close(got.detach(), want, REL_FWD)
    g = np.random.default_rng(8).normal(size=want.shape).astype(np.float32)
    _grads_match(jm, v, tm, x, g)


def _model_config(dim=32, layers=2, **over):
    cfg = dict(phm_dim=4, atom_input_dims=ZINC_ATOM_DIMS,
               bond_input_dims=ZINC_BOND_DIMS, atom_encoded_dim=dim,
               mp_layers=(dim,) * layers, dropout_mpnn=(0.0,) * layers,
               downstream_layers=(dim, dim // 2), target_dim=1,
               dropout_dn=(0.0, 0.0), msg_aggr="softmax", mlp_mp=True,
               sc_type="last")
    cfg.update(over)
    return cfg


def test_naive_encoder_model_eval_matches_jax():
    """``PHCGNN(naive_encoder=True)``: every atom and bond encoder is one
    encoder broadcast to the components; the eval forward on the converted
    weights against JAX's (its Pallas kernels in interpret mode)."""
    cfg = _model_config(naive_encoder=True)
    jm = JaxPHCGNN(**cfg)
    jb = attach_scan_plan(jax_synthetic_batch(8, 256, 512, seed=3))
    v = randomize(jm.init(jax.random.key(0), jb, training=False), seed=3)
    assert "encoder" in v["params"]["atomencoder"]
    want = np.asarray(jm.apply(v, jb, training=False))
    model = PHCGNN(**cfg, device="cpu")
    model.load_state_dict(from_flax_variables(v, model))
    got = make_eval_step(model, device="cpu")(
        attach_csr_plan(synthetic_batch(8, 256, 512, seed=3)))
    assert_close(got, want, REL_MODEL)


def test_sum_encoders_backward_runs_no_lookup():
    """The model's sum encoders are one-hot products: their backward is a
    matrix product, with no embedding lookup's scatter in the autograd
    graph."""
    model = PHCGNN(**_model_config(16), device="cpu")
    batch = synthetic_batch(4, 128, 256, seed=0)
    out = model.bondencoder_0(batch.edges)
    seen, todo = set(), [out.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        todo.extend(nxt for nxt, _ in fn.next_functions)
    names = {type(fn).__name__ for fn in seen}
    assert any("Mm" in n for n in names), names
    assert not any("Embedding" in n or "Index" in n for n in names), names
