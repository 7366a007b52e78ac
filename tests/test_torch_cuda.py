"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without a CUDA device (decided inside the
fixture, never at import).  Needs no JAX, so it runs on a machine with a
GPU and without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from phc_gnn_torch.data import synthetic_batch
from phc_gnn_torch.graph import attach_csr_plan, build_csr_rowptr
from phc_gnn_torch.ops import segment_softmax as ss

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc for sm_90a)")
    return torch.device("cuda", 0)


def _rel_err(got, want):
    """Normwise relative error over the entries where ``want`` is not the max
    identity -2^100 (empty and all-masked segments); those must hold the
    identity exactly in ``got``, or the error is inf."""
    got, want = got.double().cpu(), want.double().cpu()
    empty = want == ss.NEG
    if not bool((got[empty] == ss.NEG).all()):
        return float("inf")
    got, want = got[~empty], want[~empty]
    err = float((got - want).abs().max())
    return err / max(1.0, float(want.abs().max()))


def _flagship_case(dev, beta):
    b = attach_csr_plan(synthetic_batch(128, 4096, 8192, seed=0)).to(dev)
    gen = torch.Generator().manual_seed(0)
    msgs = torch.randn((b.num_edges, 200), generator=gen).to(dev)
    return msgs, b.edge_mask, torch.tensor(beta, device=dev), b.rowptr


def _adversarial_case(dev):
    rng = np.random.default_rng(3)
    counts = rng.integers(1, 6, size=48)
    counts[3], counts[7] = 0, 1100
    recv = np.repeat(np.arange(48), counts)
    mask = rng.random(recv.shape[0]) > 0.25
    lo = counts[:11].sum()
    mask[lo:lo + counts[11]] = False
    recv = np.concatenate([recv, np.full(40, 47)]).astype(np.int32)
    mask = np.concatenate([mask, np.zeros(40, bool)])
    msgs = rng.uniform(-32, 32, size=(recv.shape[0], 200)).astype(np.float32)
    rowptr = build_csr_rowptr(recv, 48, mask)
    return (torch.from_numpy(msgs).to(dev), torch.from_numpy(mask).to(dev),
            torch.tensor(-2.75, device=dev), torch.from_numpy(rowptr).to(dev))


@pytest.mark.parametrize("case", ["flagship", "adversarial"])
def test_kernels_match_plain_versions(dev, case):
    m, k, b, rp = (_flagship_case(dev, 1.37) if case == "flagship"
                   else _adversarial_case(dev))
    n0, a0 = ss.segment_logit_max.launches, ss.segment_softmax_aggregate.launches
    smax = ss.segment_logit_max(m, k, b, rp)
    out, w = ss.segment_softmax_aggregate(m, k, b, rp, smax, emit_w=True)
    torch.cuda.synchronize()
    assert ss.segment_logit_max.launches == n0 + 1
    assert ss.segment_softmax_aggregate.launches == a0 + 1
    smax_ref = ss.segment_logit_max_plain(m, k, b, rp)
    out_ref, w_ref = ss.segment_softmax_aggregate_plain(m, k, b, rp, smax_ref,
                                                        emit_w=True)
    assert _rel_err(smax, smax_ref) <= 1e-6
    assert _rel_err(out, out_ref) <= 1e-5
    assert _rel_err(w, w_ref) <= 1e-5
    assert torch.isfinite(out).all()


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    m, k, b, rp = _flagship_case(dev, 1.0)
    with pytest.raises(TypeError, match="float32"):
        ss.segment_logit_max(m.half(), k, b, rp)
    with pytest.raises(TypeError, match="int32"):
        ss.segment_logit_max(m, k, b, rp.long())
    with pytest.raises(ValueError, match="contiguous"):
        ss.segment_logit_max(m.t().contiguous().t(), k, b, rp)
    with pytest.raises(ValueError, match="msgs on"):
        ss.segment_logit_max(m, k, b.cpu(), rp)
