"""The fused softmax wrapper's CPU path
(``phc_gnn_torch.ops.segment_softmax.segment_softmax_fused``), on the CPU.

The fused kernel runs only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``), where it is held bit for bit to A bf16 then B bf16.
Here the wrapper's CPU path, and the softmax aggregation on bf16 messages
with and without a gradient, are held bit for bit to the plain A then B.
Needs no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_softmax_fused.py
"""

import numpy as np
import pytest
import torch

from phc_gnn_torch.graph import build_csr_rowptr
from phc_gnn_torch.ops import segment_softmax as ss


def _case(seed, d, n=48):
    """Receiver-sorted edges: an isolated node 3, a node of 1,100 edges
    (7), an all-masked node 11, masked edges among real ones, a 40-edge
    masked tail; bf16 messages with |beta * m| up to ~88."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, 6, size=n)
    counts[3], counts[7] = 0, 1100
    recv = np.repeat(np.arange(n), counts)
    mask = rng.random(recv.shape[0]) > 0.25
    lo = counts[:11].sum()
    mask[lo:lo + counts[11]] = False
    recv = np.concatenate([recv, np.full(40, n - 1)]).astype(np.int32)
    mask = np.concatenate([mask, np.zeros(40, bool)])
    msgs = torch.from_numpy(
        rng.uniform(-32, 32, size=(recv.shape[0], d)).astype(np.float32)
    ).to(torch.bfloat16)
    rowptr = build_csr_rowptr(recv, n, mask)
    return msgs, torch.from_numpy(mask), torch.tensor(-2.75), \
        torch.from_numpy(rowptr)


@pytest.mark.parametrize("d", [8, 37, 200, 512])
def test_fused_cpu_path_is_the_plain_pair(d):
    """On the CPU the fused wrapper and the bf16 softmax aggregation (with
    and without a gradient) give the bits of ``segment_logit_max_plain``
    then ``segment_softmax_aggregate_plain``, and count no launch."""
    msgs, mask, beta, rowptr = _case(9, d)
    smax = ss.segment_logit_max_plain(msgs, mask, beta, rowptr)
    want = ss.segment_softmax_aggregate_plain(msgs, mask, beta, rowptr, smax,
                                              True)
    before = ss.segment_softmax_fused.launches_bf16
    got = ss.segment_softmax_fused(msgs, mask, beta, rowptr, emit_w=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(ss.segment_softmax_fused(msgs, mask, beta, rowptr),
                       want[0])
    assert torch.equal(ss.segment_softmax(msgs, mask, beta, rowptr), want[0])
    recv = ss._segment_ids(rowptr).to(torch.int32)
    recv = torch.cat([recv, torch.full((msgs.shape[0] - recv.shape[0],),
                                       rowptr.shape[0] - 2)])
    m = msgs.clone().requires_grad_(True)
    out = ss.segment_softmax(m, mask, beta, rowptr, recv)
    assert torch.equal(out.detach(), want[0])
    assert ss.segment_softmax_fused.launches_bf16 == before
