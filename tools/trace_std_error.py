#!/usr/bin/env python3
"""Trace the f32 error of the PNA train step's gradients under the std
aggregation, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/trace_std_error.py

Runs the setting of ``tests/test_torch_pna.py::test_pna_train_step_matches_jax``
(the ZINC PNA recipe at width 32, 2 layers, JAX's var > 0 pattern replayed):
the port's gradients in f32 and in float64, and JAX's, each leaf's error
taken against the float64 port over the leaf's max.  Then the port again
with its plain moments (``ops/segment_reduce.py::segment_moments_plain``, the
plan route on the CPU) computed four ways: as they are (sequential
``index_add`` sums of the real rows and squares); with the sums rounded
once from float64, what the best order of summation gives; with the final
``E[m^2] - E[m]^2`` rounded once (an FMA); and with mean and var rounded
once from float64, not JAX's formula.  Prints the worst leaf of each.
"""

from __future__ import annotations

import copy
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tests"))
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import test_torch_pna as T  # noqa: E402
from phc_gnn_torch.ops import segment_reduce as sr  # noqa: E402
from phc_gnn_torch.train import make_loss_and_grads  # noqa: E402
from torch_parity import port_flat  # noqa: E402

ORIGINAL = sr.segment_moments_plain


def _sums(msgs, mask, rowptr, dtype):
    seg, rows = sr._real_rows(msgs, mask, rowptr)
    n = rowptr.shape[0] - 1
    zeros = torch.zeros((n, msgs.shape[1]), dtype=dtype)
    rows = rows.to(dtype)
    cnt = torch.zeros(n).index_add_(
        0, seg, torch.ones_like(seg, dtype=torch.float32)).clamp_min(1.0)
    return (zeros.index_add(0, seg, rows), zeros.index_add(0, seg, rows * rows),
            cnt[:, None])


def sums_rounded_once(msgs, mask, rowptr):
    if msgs.dtype != torch.float32:
        return ORIGINAL(msgs, mask, rowptr)
    s, s2, cnt = _sums(msgs.double(), mask, rowptr, torch.float64)
    s, s2 = s.float(), s2.float()
    mean = s / cnt
    return mean, s2 / cnt - mean * mean


def fused_final(msgs, mask, rowptr):
    if msgs.dtype != torch.float32:
        return ORIGINAL(msgs, mask, rowptr)
    s, s2, cnt = _sums(msgs, mask, rowptr, torch.float32)
    mean = s / cnt
    msq = s2 / cnt
    return mean, (msq.double() - mean.double() * mean.double()).float()


def exact_moments(msgs, mask, rowptr):
    if msgs.dtype != torch.float32:
        return ORIGINAL(msgs, mask, rowptr)
    mean, var = ORIGINAL(msgs.double(), mask, rowptr)
    return mean.float(), var.float()


def main() -> None:
    run = T.jax_run.__wrapped__()
    want = port_flat(run["grads"][0])

    def grads_of(model, double=False):
        batch = T._port_batch()
        if double:
            batch = batch.replace(y=batch.y.double())
        with T._replayed_std(run["var_positive"]):
            return make_loss_and_grads(model, T._loss_fn)(batch, T.LR)[2]

    for label, moments in (("as they are", ORIGINAL),
                           ("sums rounded once", sums_rounded_once),
                           ("E[m^2] - E[m]^2 rounded once", fused_final),
                           ("mean and var rounded once", exact_moments)):
        sr.segment_moments_plain = moments
        model = T._port_model(run, run["variables"])
        exact = copy.deepcopy(model).double()
        g32, g64 = grads_of(model), grads_of(exact, double=True)
        port, jax_ = [], []
        for key, e in g64.items():
            if T._shift_invariant(key):
                continue
            top = float(e.abs().max())
            port.append((float((g32[key].double() - e).abs().max()) / top, key))
            jax_.append((float((torch.from_numpy(np.asarray(want[key])).double()
                                - e).abs().max()) / top, key))
        p, j = max(port), max(jax_)
        print(f"moments {label}: port f32 worst {p[0]:.3e} ({p[1]}); JAX f32 "
              f"worst {j[0]:.3e} ({j[1]}), both against the float64 port",
              flush=True)
    sr.segment_moments_plain = ORIGINAL


if __name__ == "__main__":
    main()
