"""The port's batch, CSR plan and segment softmax against the JAX reference.

The kernels' plain versions run here (CPU tensors); the CUDA kernels are held
to them on the card (test_torch_cuda.py, chip_smoke.py).  Tolerance: 1e-5
normwise relative (different summation order, same f32 arithmetic); the
backward's gradients 1e-5 per leaf, scaled by the gradient's own max; on
bf16 messages ``dm`` (bf16 on both sides) within one bf16 rounding step,
2^-8 of the leaf's max: f32 values ~1e-7 apart can round to neighbouring
bf16 values.  ``dbeta`` sums E x D signed terms that cancel, so its limit
is 1e-5 of the sum of the terms' magnitudes, against JAX and against a
float64 sum of the same terms.
"""

import jax
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
from torch_parity import assert_close, assert_leaf_close
from torch_threads import one_torch_thread  # noqa: F401

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


@pytest.mark.parametrize("case", sorted(CASES))
def test_segment_softmax_grad_matches_streamed_vjp(case):
    """Gradients in ``msgs`` and ``beta`` of the port's autograd Function
    (forward A, then B's training variant; closed-form backward) against
    ``jax.grad`` through ``softmax_aggregate_streamed`` (Pallas A and B in
    interpret mode, its custom VJP), on the same adversarial segments."""
    msgs, recv, mask, n, beta = CASES[case]()
    flags, cont, last = build_scan_plan(recv, n, edge_mask=mask)
    g = np.random.default_rng(5).normal(
        size=(n, msgs.shape[1])).astype(np.float32)

    def f(m, b):
        out = softmax_aggregate_streamed(
            m, jnp.asarray(recv), jnp.asarray(flags), jnp.asarray(cont),
            jnp.asarray(last), n, b, edge_mask=jnp.asarray(mask))
        return jnp.sum(out * g)

    dm_j, db_j = jax.grad(f, argnums=(0, 1))(jnp.asarray(msgs),
                                             jnp.float32(beta))
    m = torch.tensor(msgs, requires_grad=True)
    b = torch.tensor(beta, requires_grad=True)
    rowptr = torch.from_numpy(build_csr_rowptr(recv, n, mask))
    out = ss.segment_softmax(m, torch.from_numpy(mask), b, rowptr,
                             torch.from_numpy(recv))
    (out * torch.from_numpy(g)).sum().backward()
    assert_leaf_close(m.grad, np.asarray(dm_j), REL, "dmsgs")
    # dbeta sums E x D signed terms that cancel (|beta * m| up to 88 in the
    # adversarial cases): its f32 rounding scales with the sum of |terms|
    k, r = torch.from_numpy(mask), torch.from_numpy(recv).long()
    smax = ss.segment_logit_max_plain(m.detach(), k, b.detach(), rowptr)
    out, w, den = ss.segment_softmax_aggregate_plain(
        m.detach(), k, b.detach(), rowptr, smax, emit_w=True)
    md, gd = m.detach().double(), torch.from_numpy(g).double()[r]
    terms = (w.double() / den.double()[r]) * md * (md * gd
                                                   - out.double()[r] * gd)
    err = abs(float(b.grad) - float(db_j))
    assert err <= REL * float(terms.abs().sum()), (err, float(db_j))
    assert torch.all(m.grad[~torch.from_numpy(mask)] == 0)


def test_segment_softmax_grad_needs_receivers():
    msgs, recv, mask, n, beta = _synthetic(0)
    rowptr = torch.from_numpy(build_csr_rowptr(recv, n, mask))
    m = torch.tensor(msgs, requires_grad=True)
    with pytest.raises(ValueError, match="receivers"):
        ss.segment_softmax(m, torch.from_numpy(mask), torch.tensor(beta), rowptr)


def test_segment_softmax_identities():
    """-2^100 is the max identity; isolated and all-masked nodes give 0; w is
    0 on masked and padding-tail edges and peaks at 1 in real segments."""
    msgs, recv, mask, n, beta = _adversarial(2)
    rowptr = torch.from_numpy(build_csr_rowptr(recv, n, mask))
    m, k, b = torch.from_numpy(msgs), torch.from_numpy(mask), torch.tensor(beta)
    segmax = ss.segment_logit_max(m, k, b, rowptr)
    assert ss.NEG == -(2.0 ** 100) and float(np.float32(ss.NEG)) == ss.NEG
    assert torch.all(segmax[3] == ss.NEG) and torch.all(segmax[11] == ss.NEG)
    out, w, den = ss.segment_softmax_aggregate(m, k, b, rowptr, segmax,
                                               emit_w=True)
    assert torch.isfinite(out).all()
    assert torch.all(out[3] == 0) and torch.all(out[11] == 0)
    assert torch.all(w[~k] == 0)
    # den = max(sum w, 1e-16): the floor on empty and all-masked segments
    assert torch.all(den[3] == 1e-16) and torch.all(den[11] == 1e-16)
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


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_f32_cpu_path_is_the_plain_pair(case):
    """On float32 messages the fused wrapper's CPU path, in both variants,
    gives the bits of the plain A then B, and counts no launch."""
    msgs, recv, mask, n, beta = CASES[case]()
    m, k, b = torch.from_numpy(msgs), torch.from_numpy(mask), torch.tensor(beta)
    rowptr = torch.from_numpy(build_csr_rowptr(recv, n, mask))
    smax = ss.segment_logit_max_plain(m, k, b, rowptr)
    want = ss.segment_softmax_aggregate_plain(m, k, b, rowptr, smax, True)
    before = ss.segment_softmax_fused.launches
    got = ss.segment_softmax_fused(m, k, b, rowptr, emit_w=True)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert torch.equal(ss.segment_softmax_fused(m, k, b, rowptr), want[0])
    assert ss.segment_softmax_fused.launches == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_softmax_backward_plain_matches_streamed_vjp(case, dtype):
    """``segment_softmax_backward_plain``'s ``dm`` and ``dbeta``, fed the
    port's forward outputs, against ``jax.vjp`` of
    ``softmax_aggregate_streamed`` (Pallas A and B in interpret mode, its
    custom VJP) on the same messages and cotangent, in f32 and on bf16
    messages; ``dm`` is exactly 0 on the padding tail and on masked edges
    (the adversarial cases also hold an isolated node and an all-masked
    segment)."""
    msgs, recv, mask, n, beta = CASES[case]()
    flags, cont, last = build_scan_plan(recv, n, edge_mask=mask)
    g = np.random.default_rng(6).normal(
        size=(n, msgs.shape[1])).astype(np.float32)
    m_j = jnp.asarray(msgs).astype(dtype)
    _, vjp = jax.vjp(lambda m, b: softmax_aggregate_streamed(
        m, jnp.asarray(recv), jnp.asarray(flags), jnp.asarray(cont),
        jnp.asarray(last), n, b, edge_mask=jnp.asarray(mask)),
        m_j, jnp.float32(beta))
    dm_j, db_j = vjp(jnp.asarray(g))
    assert dm_j.dtype == m_j.dtype

    m = torch.from_numpy(msgs).to(getattr(torch, dtype))
    k, b = torch.from_numpy(mask), torch.tensor(beta)
    rowptr = torch.from_numpy(build_csr_rowptr(recv, n, mask))
    r = torch.from_numpy(recv)
    out, w, den = ss.segment_softmax_fused(m, k, b, rowptr, emit_w=True)
    dm, db = ss.segment_softmax_backward_plain(m, b, w, den, out,
                                               torch.from_numpy(g), r)
    assert dm.dtype == m.dtype and db.shape == b.shape
    rel = REL if dtype == "float32" else 2.0 ** -8
    assert_leaf_close(dm.float(), np.asarray(dm_j, np.float32), rel, "dmsgs")
    e = int(rowptr[-1])
    assert torch.all(dm[e:] == 0) and torch.all(dm[~k] == 0)
    # the terms of dbeta in float64, from the port's f32 forward outputs
    md, gd, rl = m.double(), torch.from_numpy(g).double()[r.long()], r.long()
    terms = (w.double() / den.double()[rl]) * md * (md * gd
                                                    - out.double()[rl] * gd)
    scale = float(terms.abs().sum())
    for name, want in (("jax", float(db_j)), ("float64", float(terms.sum()))):
        err = abs(float(db) - want)
        assert err <= REL * scale, (name, err, want, scale)


def test_backward_never_reaches_the_plain_version_off_the_cpu(monkeypatch):
    """The backward's op runs its plain version for CPU tensors alone: on
    the CPU the autograd Function's backward reaches it once through the
    op, which ``torch.library.opcheck`` holds (schema, fake shapes); a
    tensor on any other device goes to the kernel path, which refuses what
    it cannot launch, and never to the plain version."""
    msgs, recv, mask, n, beta = _synthetic(0, d=8)
    rowptr = torch.from_numpy(build_csr_rowptr(recv, n, mask))
    m = torch.tensor(msgs, requires_grad=True)
    k, b, r = torch.from_numpy(mask), torch.tensor(beta), torch.from_numpy(recv)
    out, w, den = ss.segment_softmax_fused(m.detach(), k, b, rowptr, True)
    g = torch.ones_like(out)
    torch.library.opcheck(torch.ops.phc_gnn.segment_softmax_backward.default,
                          (m.detach(), b, w, den, out, g, rowptr, r))
    calls = []
    plain = ss.segment_softmax_backward_plain

    def counted(*args):
        calls.append(args[0].device.type)
        return plain(*args)

    monkeypatch.setattr(ss, "segment_softmax_backward_plain", counted)
    ss.segment_softmax(m, k, b, rowptr, r).sum().backward()
    assert calls == ["cpu"] and m.grad.shape == m.shape
    meta = [torch.empty(t.shape, dtype=t.dtype, device="meta")
            for t in (m, b, w, den, out, g, rowptr, r)]
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ss.segment_softmax_backward(*meta)
    assert calls == ["cpu"]
