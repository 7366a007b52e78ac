"""The port's sender plan and message gather (kernel C's plain version)
against the JAX reference.

``gather_nodes``' gradient is held to ``jax.vjp`` of
``gather_nodes_streamed`` over the batch's ``attach_scan_plan`` sender plan
(Pallas kernel C in interpret mode).  The cotangent is non-zero on masked
edges: both sides must ignore them.  Tolerance: 1e-6 per leaf, scaled by
the gradient's own max (sums of the same f32 rows in other orders; at most a
few hundred terms per sender).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phc_gnn_tpu.data import synthetic_batch as jax_synthetic_batch
from phc_gnn_tpu.ops.stream_scan import (attach_scan_plan, build_sender_plan,
                                         gather_nodes_streamed)
from phc_gnn_torch.data import synthetic_batch
from phc_gnn_torch.graph import attach_csr_plan, build_sender_csr
from phc_gnn_torch.ops import segment_sum as ssum
from torch_parity import assert_leaf_close
from torch_threads import one_torch_thread  # noqa: F401

REL = 1e-6


def _adversarial(seed: int, n: int = 40):
    """Senders in no order with: an isolated sender (3), one sender of 1,100
    edges (7), masked edges among real ones, and a masked tail of 40 edges on
    the last node, as the batcher pads."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, 6, size=n)
    counts[3] = 0
    counts[7] = 1100
    senders = rng.permutation(np.repeat(np.arange(n), counts))
    mask = rng.random(senders.shape[0]) > 0.2
    senders = np.concatenate([senders, np.full(40, n - 1)]).astype(np.int32)
    mask = np.concatenate([mask, np.zeros(40, bool)])
    return senders, mask, n


def _synthetic(seed: int):
    b = jax_synthetic_batch(8, 256, 512, seed=seed)
    return np.asarray(b.senders), np.asarray(b.edge_mask), b.num_nodes


CASES = {"synthetic0": lambda: _synthetic(0), "synthetic1": lambda: _synthetic(1),
         "adversarial0": lambda: _adversarial(0),
         "adversarial1": lambda: _adversarial(1)}


@pytest.mark.parametrize("case", sorted(CASES) + ["flagship"])
def test_sender_csr_matches_sender_plan(case):
    """``perm`` is JAX's, and ``rowptr[n+1] - 1`` is ``last[n]`` for every
    sender with a real edge (``last == -1`` for the rest): masked edges sort
    last and lie in no segment."""
    if case == "flagship":
        b = jax_synthetic_batch(128, 4096, 8192, seed=0)
        senders, mask, n = (np.asarray(b.senders), np.asarray(b.edge_mask),
                            b.num_nodes)
    else:
        senders, mask, n = CASES[case]()
    perm_j, _, _, last = build_sender_plan(senders, n, edge_mask=mask)
    perm, rowptr = build_sender_csr(senders, n, mask)
    np.testing.assert_array_equal(perm, perm_j)
    nonempty = rowptr[1:] > rowptr[:-1]
    np.testing.assert_array_equal(np.where(nonempty, rowptr[1:] - 1, -1), last)
    assert rowptr[-1] == mask.sum() and rowptr[0] == 0
    assert np.all(mask[perm[:rowptr[-1]]]) and not np.any(mask[perm[rowptr[-1]:]])
    if case == "flagship":
        assert rowptr[-1] == 6374


def test_attach_csr_plan_carries_the_sender_plan():
    b = attach_csr_plan(synthetic_batch(4, 128, 256, seed=0))
    jb = attach_scan_plan(jax_synthetic_batch(4, 128, 256, seed=0))
    assert b.snd_perm.dtype == b.snd_rowptr.dtype == torch.int32
    assert b.snd_rowptr.shape == (b.num_nodes + 1,)
    np.testing.assert_array_equal(b.snd_perm.numpy(), np.asarray(jb.snd_perm))


@pytest.mark.parametrize("case", sorted(CASES))
def test_gather_nodes_grad_matches_streamed_kernel(case):
    """Forward: the plain take.  Backward: dx[n] = sum of g over sender n's
    real edges, against jax.vjp through the streamed Pallas gather."""
    senders, mask, n = CASES[case]()
    d = 24
    rng = np.random.default_rng(7)
    x = rng.normal(size=(n, d)).astype(np.float32)
    g = rng.normal(size=(senders.shape[0], d)).astype(np.float32)  # masked too
    plan = tuple(map(jnp.asarray,
                     build_sender_plan(senders, n, edge_mask=mask)))
    y_j, vjp = jax.vjp(lambda x_: gather_nodes_streamed(
        x_, jnp.asarray(senders), *plan), jnp.asarray(x))
    (dx_j,) = vjp(jnp.asarray(g))

    perm, rowptr = (torch.from_numpy(a) for a in
                    build_sender_csr(senders, n, mask))
    xt = torch.tensor(x, requires_grad=True)
    y = ssum.gather_nodes(xt, torch.tensor(senders), perm, rowptr)
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(y_j))
    y.backward(torch.from_numpy(g))
    assert_leaf_close(xt.grad, np.asarray(dx_j), REL)
    if case.startswith("adversarial"):
        assert torch.all(xt.grad[3] == 0)  # the isolated sender
        real7 = g[(senders == 7) & mask].sum(0)
        np.testing.assert_allclose(xt.grad[7].numpy(), real7, rtol=1e-5,
                                   atol=1e-4)


def test_segment_sum_perm_plain_is_a_csr_sum():
    """out[n] = sum of values[perm[e]] over n's segment; 0 when empty."""
    values = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    perm = torch.tensor([5, 0, 3, 1, 2, 4], dtype=torch.int32)
    rowptr = torch.tensor([0, 2, 2, 5], dtype=torch.int32)
    out = ssum.segment_sum_perm(values, perm, rowptr)
    want = torch.stack([values[[5, 0]].sum(0), torch.zeros(2),
                        values[[3, 1, 2]].sum(0)])
    assert torch.equal(out, want)


def test_segment_sum_tolerance_separates_a_dropped_edge():
    """The limit that the card's checks hold kernel C to (1e-5 of the leaf's
    max, against a float64 sum) passes an f32 sum of the 1,100-edge sender
    and fails the same sum with one real edge dropped."""
    senders, mask, n = _adversarial(0)
    perm, rowptr = (torch.from_numpy(a) for a in
                    build_sender_csr(senders, n, mask))
    g = torch.randn((senders.shape[0], 200),
                    generator=torch.Generator().manual_seed(1))
    want = ssum.segment_sum_perm_plain(g.double(), perm, rowptr)
    top = float(want.abs().max())

    def reading(got):
        return float((got.double() - want).abs().max()) / top

    assert reading(ssum.segment_sum_perm_plain(g, perm, rowptr)) <= 1e-5
    lo = int(rowptr[7])
    dropped = torch.cat([perm[:lo], perm[lo + 1:]])
    short = rowptr.clone()
    short[8:] -= 1
    assert reading(ssum.segment_sum_perm_plain(g, dropped, short)) >= 1e-3


def test_wrappers_never_fall_back_for_non_cpu_tensors():
    v = torch.empty(4, 8, device="meta")
    perm = torch.empty(4, dtype=torch.int32, device="meta")
    rowptr = torch.empty(3, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ssum.segment_sum_perm(v, perm, rowptr)
    with pytest.raises(ValueError, match="entries"):
        ssum.gather_nodes(torch.zeros(5, 2), torch.zeros(3, dtype=torch.int32),
                          torch.zeros(3, dtype=torch.int32),
                          torch.zeros(3, dtype=torch.int32))
