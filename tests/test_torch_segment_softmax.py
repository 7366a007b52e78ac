"""The port's batch, CSR plan and segment softmax against the JAX reference.

The kernels' plain versions run here (CPU tensors); the CUDA kernels are held
to them on the card (test_torch_cuda.py, chip_smoke.py).  Tolerance: 1e-5
normwise relative (different summation order, same f32 arithmetic).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phc_gnn_tpu.data import synthetic_batch as jax_synthetic_batch
from phc_gnn_tpu.graph.aggregators import softmax_aggregate as jax_softmax_aggregate
from phc_gnn_tpu.ops.stream_scan import build_scan_plan, softmax_aggregate_streamed
from phc_gnn_torch.data import synthetic_batch
from phc_gnn_torch.graph import attach_csr_plan, build_csr_rowptr
from phc_gnn_torch.graph.aggregators import softmax_aggregate
from phc_gnn_torch.ops import segment_softmax as ss
from torch_parity import assert_close

REL = 1e-5


def _adversarial(seed: int, d: int = 16):
    """Receiver-sorted edges with: an isolated node, an all-masked segment
    that is not in the tail, one segment of 1,100 edges, masked edges among
    real ones, a padding tail of 40 edges on the last node, and messages with
    |beta * m| up to ~88 (beta = -2.75), so exp would overflow without the
    max shift."""
    rng = np.random.default_rng(seed)
    n = 40
    counts = rng.integers(1, 6, size=n)
    counts[3] = 0        # isolated node
    counts[7] = 1100     # longer than 1,024 edges
    recv = np.repeat(np.arange(n), counts)
    mask = rng.random(recv.shape[0]) > 0.25
    lo = counts[:11].sum()
    mask[lo:lo + counts[11]] = False  # all-masked segment inside the array
    # padding tail, all on the last node, as the batcher emits it
    recv = np.concatenate([recv, np.full(40, n - 1)]).astype(np.int32)
    mask = np.concatenate([mask, np.zeros(40, bool)])
    msgs = rng.uniform(-32.0, 32.0, size=(recv.shape[0], d)).astype(np.float32)
    return msgs, recv, mask, n, -2.75


def _synthetic(seed: int, d: int = 32):
    b = jax_synthetic_batch(8, 256, 512, seed=seed)
    recv = np.array(b.receivers)
    mask = np.array(b.edge_mask)
    rng = np.random.default_rng(100 + seed)
    msgs = rng.normal(size=(recv.shape[0], d)).astype(np.float32)
    return msgs, recv, mask, b.num_nodes, 1.3


CASES = {"synthetic0": lambda: _synthetic(0), "synthetic1": lambda: _synthetic(1),
         "adversarial0": lambda: _adversarial(0),
         "adversarial1": lambda: _adversarial(1)}


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_synthetic_batch_bit_identical(seed):
    ref = jax_synthetic_batch(8, 256, 512, seed=seed)
    got = synthetic_batch(8, 256, 512, seed=seed)
    for name in ("nodes", "edges", "senders", "receivers", "graph_ids",
                 "node_mask", "edge_mask", "graph_mask", "y"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)


@pytest.mark.parametrize("case", ["flagship", "small", "adversarial"])
def test_csr_rowptr_matches_scan_plan_last_edge(case):
    """rowptr[n+1] - 1 == last_edge[n] for every non-empty segment and
    last_edge == -1 for the rest; the trailing padding run is in no segment."""
    if case == "adversarial":
        _, recv, mask, n, _ = _adversarial(0)
    else:
        size = (128, 4096, 8192) if case == "flagship" else (8, 256, 512)
        b = jax_synthetic_batch(*size, seed=0)
        recv, mask, n = np.asarray(b.receivers), np.asarray(b.edge_mask), b.num_nodes
    _, _, last = build_scan_plan(recv, n, edge_mask=mask)
    rowptr = build_csr_rowptr(recv, n, mask)
    nonempty = rowptr[1:] > rowptr[:-1]
    np.testing.assert_array_equal(np.where(nonempty, rowptr[1:] - 1, -1), last)
    assert rowptr[-1] == np.nonzero(mask)[0][-1] + 1
    assert rowptr[0] == 0 and np.all(np.diff(rowptr) >= 0)
    if case == "flagship":
        # 6,374 real edges; 1,818 padding edges on node 4095 (graph/batch.py)
        assert rowptr[-1] == 6374 and len(recv) - rowptr[-1] == 1818


def test_attach_csr_plan_rejects_unsorted_edges():
    b = synthetic_batch(4, 128, 256, seed=0)
    shuffled = b.replace(receivers=b.receivers.flip(0))
    with pytest.raises(ValueError, match="receiver-sorted"):
        attach_csr_plan(shuffled)


@pytest.mark.parametrize("case", sorted(CASES))
def test_segment_softmax_matches_streamed_kernel(case):
    """Port (CSR plan, plain versions) vs JAX softmax_aggregate_streamed
    (scan plan, Pallas kernels A and B in interpret mode)."""
    msgs, recv, mask, n, beta = CASES[case]()
    flags, cont, last = build_scan_plan(recv, n, edge_mask=mask)
    want = softmax_aggregate_streamed(
        jnp.asarray(msgs), jnp.asarray(recv), jnp.asarray(flags),
        jnp.asarray(cont), jnp.asarray(last), n, beta,
        edge_mask=jnp.asarray(mask))
    rowptr = torch.from_numpy(build_csr_rowptr(recv, n, mask))
    got = ss.segment_softmax(torch.from_numpy(msgs), torch.from_numpy(mask),
                             torch.tensor(beta), rowptr)
    assert_close(got, np.asarray(want), REL)
    # and the port's plain composite agrees with JAX's
    comp = softmax_aggregate(torch.from_numpy(msgs),
                             torch.from_numpy(recv), n, beta,
                             torch.from_numpy(mask))
    want_comp = jax_softmax_aggregate(jnp.asarray(msgs), jnp.asarray(recv), n,
                                      beta, jnp.asarray(mask))
    assert_close(comp, np.asarray(want_comp), REL)


def test_segment_softmax_identities():
    """-2^100 is the max identity; isolated and all-masked nodes give 0; w is
    0 on masked and padding-tail edges and peaks at 1 in real segments."""
    msgs, recv, mask, n, beta = _adversarial(2)
    rowptr = torch.from_numpy(build_csr_rowptr(recv, n, mask))
    m, k, b = torch.from_numpy(msgs), torch.from_numpy(mask), torch.tensor(beta)
    segmax = ss.segment_logit_max(m, k, b, rowptr)
    assert ss.NEG == -(2.0 ** 100) and float(np.float32(ss.NEG)) == ss.NEG
    assert torch.all(segmax[3] == ss.NEG) and torch.all(segmax[11] == ss.NEG)
    out, w = ss.segment_softmax_aggregate(m, k, b, rowptr, segmax, emit_w=True)
    assert torch.isfinite(out).all()
    assert torch.all(out[3] == 0) and torch.all(out[11] == 0)
    assert torch.all(w[~k] == 0)
    # w = exp(logit - segmax) is 1 at each real segment's argmax, per lane
    seg = torch.repeat_interleave(torch.arange(n), rowptr.diff().long())
    e = seg.shape[0]
    real = torch.zeros(n, dtype=torch.bool)
    real[seg[k[:e]]] = True
    d = msgs.shape[1]
    wmax = torch.zeros(n, d).scatter_reduce(
        0, seg[:, None].expand(e, d), w[:e], "amax", include_self=False)
    assert torch.all(wmax[real] == 1.0)


def test_wrappers_never_fall_back_for_non_cpu_tensors():
    """Only CPU tensors take the plain version; any other device goes to the
    kernel path, which refuses what it cannot launch."""
    m = torch.empty(4, 8, device="meta")
    k = torch.empty(4, dtype=torch.bool, device="meta")
    b = torch.empty((), device="meta")
    rowptr = torch.empty(3, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ss.segment_logit_max(m, k, b, rowptr)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ss.segment_softmax_aggregate(m, k, b, rowptr, torch.empty(2, 8, device="meta"))
