#!/usr/bin/env python3
"""Time the flagship train step's kernels on one NVIDIA GPU at each bucket
of the scaling sweep (``phc_gnn_torch.cli.scaling.BUCKETS``: 4,096 to
32,768 nodes, 8,192 to 65,536 edges).

    python3 tools/time_buckets.py [--step]

Per bucket, on ``synthetic_batch(graphs, nodes, edges, seed=0)`` with its
CSR plans and inputs drawn from seed 7 at width 200, what one conv of the
step launches:

- ``segment_softmax_fused``, its training variant (``out``, ``w``, ``den``)
  on [E, 200] messages over the receiver CSR;
- ``segment_softmax_backward`` fed its outputs and a cotangent [N, 200];
- ``segment_sum_perm``, C's gather backward, over the sender plan;
- the conv norms at [N, 200], forward and backward: D and E
  (``bn_forward``, ``bn_backward``) under ``FUSED_BN_VMEM_LIMIT``, F and G
  (``bn_forward_blocked``, ``bn_backward_blocked``) past it, with
  ``bn_plan``'s grid.

Each is device us per call from one CUDA graph of 100 calls (median of 5
replays; ``chip_smoke.py``'s timer), beside its bound: the bytes it must
move (``chip_smoke.py``'s counts: inputs read once over the edges in
segments, outputs written once) at 3.35 TB/s.  Prints the card's name and
power limit, then one JSON line a bucket.

With ``--step`` each bucket's line also carries the flagship's graphed
train step there (``make_scan_train_steps``, dropout on, 8 steps a call
on the one batch): ms a step (CUDA events, ``chip_smoke.time_scan``), and
from ``torch.profiler`` over 2 calls the kernels a step, the device's busy
ms (kernel durations summed) and idle share, and the busy ms by class:
the port's kernels (``chip_smoke.KERNEL_NAMES``), GEMMs (cuBLAS and
CUTLASS names), and the rest (elementwise passes, reductions, copies).
Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
DIM = 200
STEPS = 8                    # graphed steps a call
GEMM_NAMES = ("gemm", "xmma", "cutlass")  # in kernel names, lower case


def step_profile(torch, batch) -> dict:
    """The flagship's graphed train step on ``batch`` (on the card): ms a
    step, kernels a step, busy ms and idle share, busy ms by class."""
    import chip_smoke as cs
    from phc_gnn_torch import bench
    from phc_gnn_torch.models import PHCGNN
    from phc_gnn_torch.train import make_optimizer, make_scan_train_steps

    dev = batch.senders.device
    model = PHCGNN(**bench.flagship_kwargs(DIM, 4), seed=0, device=dev)
    opt = make_optimizer(dict(model.named_parameters()),
                         grad_clip=bench.GRAD_CLIP)
    steps = make_scan_train_steps(model, opt, bench._l1,
                                  weight_decay=bench.WEIGHT_DECAY, seed=0,
                                  device=dev)

    def call():
        steps([batch] * STEPS, bench.LR)

    ms, host_ms = cs.time_scan(torch, call, STEPS)
    calls = 2
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    us = {"port": 0.0, "gemm": 0.0, "other": 0.0}
    kernels = 0
    for e in prof.events():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or e.is_user_annotation):
            continue
        kernels += 1
        name = e.name
        cls = ("port" if any(cs.kernel_of(w, name) for w in cs.KERNEL_NAMES)
               else "gemm" if any(g in name.lower() for g in GEMM_NAMES)
               else "other")
        us[cls] += e.time_range.elapsed_us()
    per = calls * STEPS
    busy = sum(us.values()) / 1e3 / per
    return {"step_ms": ms, "step_host_ms": host_ms,
            "kernels_per_step": kernels / per, "busy_ms": busy,
            "idle_share": 1.0 - busy / ms,
            "busy_ms_by_class": {k: v / 1e3 / per for k, v in us.items()}}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--step", action="store_true",
                    help="also time and profile the graphed flagship step "
                         "at each bucket")
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    import torch

    if not torch.cuda.is_available():
        print("time_buckets: no CUDA device", file=sys.stderr)
        sys.exit(1)
    from chip_smoke import (HBM_BYTES_PER_S, bn_backward_bytes,
                            bn_forward_bytes, time_graph)
    from phc_gnn_torch.cli.scaling import BUCKETS
    from phc_gnn_torch.data import synthetic_batch
    from phc_gnn_torch.graph import attach_csr_plan
    from phc_gnn_torch.ops import fused_bn
    from phc_gnn_torch.ops import segment_softmax as ss
    from phc_gnn_torch.ops import segment_sum as ssum

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(7)
    d = DIM
    for size, nodes, edges, _ in BUCKETS:
        b = attach_csr_plan(synthetic_batch(size, nodes, edges,
                                            seed=0)).to(dev)
        n, e = b.num_nodes, b.num_edges
        e_seg = int(b.rowptr[-1])          # edges inside segments
        e_real = int(b.snd_rowptr[-1])     # real edges in the sender plan
        m = torch.randn((e, d), generator=gen).to(dev)
        beta = torch.tensor(1.37, device=dev)
        k, rp = b.edge_mask, b.rowptr
        g = torch.randn((n, d), generator=gen).to(dev)
        gv = torch.randn((e, d), generator=gen).to(dev)
        x = (torch.randn((n, d), generator=gen) * 2 + 3).to(dev)
        gx = torch.randn((n, d), generator=gen).to(dev)
        scale = torch.randn(d, generator=gen).to(dev)
        bias = torch.randn(d, generator=gen).to(dev)
        out, w, den = ss.segment_softmax_fused(m, k, beta, rp, emit_w=True)
        blocked = n * d * 4 > fused_bn.FUSED_BN_VMEM_LIMIT
        fwd, bwd = (
            (fused_bn.bn_forward_blocked, fused_bn.bn_backward_blocked)
            if blocked else (fused_bn.bn_forward, fused_bn.bn_backward))
        _, mean, var = fwd(x, b.node_mask, scale, bias, 1e-5)
        softmax_in = e_seg * d * 4 + e_seg + (n + 1) * 4 + 4
        calls = {
            "segment_softmax_fused_train": (
                lambda: ss.segment_softmax_fused(m, k, beta, rp, emit_w=True),
                softmax_in + 2 * n * d * 4 + e * d * 4),
            "segment_softmax_backward": (
                lambda: ss.segment_softmax_backward(m, beta, w, den, out, g,
                                                    rp, b.receivers),
                e_seg * d * 8 + 3 * n * d * 4 + (n + 1) * 4 + 4 + e * d * 4
                + 4),
            "segment_sum_perm": (
                lambda: ssum.segment_sum_perm(gv, b.snd_perm, b.snd_rowptr),
                e_real * d * 4 + e_real * 4 + (n + 1) * 4 + n * d * 4),
            fwd.__name__: (lambda: fwd(x, b.node_mask, scale, bias, 1e-5),
                           bn_forward_bytes(n, d)),
            bwd.__name__: (lambda: bwd(x, b.node_mask, scale, mean, var, 1e-5,
                                       gx), bn_backward_bytes(n, d)),
        }
        line = {"graphs": size, "nodes": n, "edges": e,
                "edges_in_segments": e_seg,
                "bn_plan": [fused_bn.bn_plan(n, d, t)._asdict()
                            for t in (1, 2)], "kernels": {}}
        for name, (fn, nbytes) in calls.items():
            us = time_graph(torch, fn) * 1e3
            bound = nbytes / HBM_BYTES_PER_S * 1e6
            line["kernels"][name] = {"us": us, "bound_us": bound,
                                     "bytes": nbytes,
                                     "fraction": bound / us}
        if args.step:
            line["step"] = step_profile(torch, b)
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
