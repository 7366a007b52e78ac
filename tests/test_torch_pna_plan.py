"""PNA's fixed aggregations over the CSR plan against JAX's streamed ones:
mean (kernel C's forward role), min and max (kernel H), var and std (kernel
I), through the kernels' plain versions on the CPU, held to
``STREAMED_AGGREGATORS`` with JAX's scan plan (``build_scan_plan(..., 128)``;
the Pallas kernels in interpret mode), forward and VJP, on E = 300 random
receivers over N = 64 and on adversarial receivers (an isolated node, a
1,100-edge segment, masked edges inside segments, an all-masked segment, the
padding tail).  On exact ties the plan route gives every tied edge the whole
cotangent, as JAX's streamed VJP does.  The composites without a plan, the
scalers and the std's kink: tests/test_torch_pna_composite.py; the PNA conv
and model: tests/test_torch_pna.py.

Tolerances, each with its reason:
- ``REL_AGG`` 1e-5 per leaf: segment sums of the same f32 rows in other
  orders (JAX's prefix scan carries across 128-edge blocks); a max or min
  is exact;
- ``REL_EXTREME_GRAD`` 1e-6: the min/max backward is a gather, exact;
- ``REL_GRAD`` 1e-5 per leaf for the mean, var and std backwards (their
  means and counts in other orders), on inputs whose var stays away from 0.
"""

import numpy as np
import pytest
import torch

from torch_parity import (adversarial_receivers, assert_leaf_close,
                          jax_plan_aggregate, pna_messages,
                          port_plan_aggregate, small_receivers)
from torch_threads import one_torch_thread  # noqa: F401

REL_AGG = 1e-5
REL_EXTREME_GRAD = 1e-6
REL_GRAD = 1e-5
AGGRS = ["mean", "min", "max", "var", "std"]
CASES = {"adversarial": lambda: adversarial_receivers(0),
         "small": lambda: small_receivers(1)}


@pytest.mark.parametrize("name", AGGRS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_plan_aggregators_match_streamed(name, case):
    """Each aggregation over the CSR plan (kernels C, H, I through their
    plain versions) against JAX's streamed one: forward and VJP."""
    recv, mask, n = CASES[case]()
    msgs = pna_messages("normal", recv.shape[0], 24, 5)
    g = np.random.default_rng(6).normal(size=(n, 24)).astype(np.float32)
    out_j, dm_j = jax_plan_aggregate(name, recv, mask, n, msgs, g)
    out, dm = port_plan_aggregate(name, recv, mask, n, msgs, g)
    assert_leaf_close(out, out_j, REL_AGG, "out")
    tol = REL_EXTREME_GRAD if name in ("min", "max") else REL_GRAD
    assert_leaf_close(dm, dm_j, tol, "dmsgs")
    assert torch.all(dm[~torch.from_numpy(mask)] == 0)
    if case == "adversarial" and name != "std":
        assert torch.all(out[3] == 0) and torch.all(out[11] == 0)


@pytest.mark.parametrize("name", ["min", "max"])
def test_plan_extremes_give_every_tie_the_whole_cotangent(name):
    """On inputs with exact ties, the plan route follows JAX's streamed VJP:
    every edge that attains its segment's min or max gets the whole g."""
    recv, mask, n = small_receivers(2)
    msgs = pna_messages("ties", recv.shape[0], 24, 7)
    g = np.random.default_rng(8).normal(size=(n, 24)).astype(np.float32)
    out_j, dm_j = jax_plan_aggregate(name, recv, mask, n, msgs, g)
    out, dm = port_plan_aggregate(name, recv, mask, n, msgs, g)
    assert_leaf_close(out, out_j, REL_AGG, "out")
    assert_leaf_close(dm, dm_j, REL_EXTREME_GRAD, "dmsgs")
    hit = (torch.from_numpy(msgs) == out[torch.from_numpy(recv).long()]) \
        & torch.from_numpy(mask)[:, None]
    per_segment = torch.zeros(n, 24).index_add_(
        0, torch.from_numpy(recv).long(), hit.float())
    assert float(per_segment.max()) > 1  # the input does tie
    np.testing.assert_array_equal(
        dm.numpy(), np.where(hit.numpy(), g[recv], 0.0))
