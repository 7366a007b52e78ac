#!/usr/bin/env python3
"""Time the softmax aggregation's kernels A and B on one NVIDIA GPU at the
flagship's shape, in each instance the wrappers can launch.

    python3 tools/time_softmax.py

Messages [E, 200] over the receiver CSR of ``attach_csr_plan`` on
``synthetic_batch(128, 4096, 8192)`` (``chip_smoke.py``'s flagship batch).
Per instance: ``segment_logit_max`` (A), ``segment_softmax_aggregate`` in
its eval variant (B) and in its training variant (B, writing ``w`` and
``den``), each as device us per call from one CUDA graph of 100 calls
(median of 5 replays, ``chip_smoke.py``'s timer).  The instances:

- ``f32``: float32 messages;
- ``bf16 pairs``: bfloat16 messages, rows 4-byte aligned, so a thread takes
  a pair of lanes (``__nv_bfloat162`` loads);
- ``bf16 scalar``: the same bfloat16 messages one element past a 4-byte
  boundary, so the wrapper's entry point takes the one-lane instance.

Both bf16 instances' outputs are held bit-equal to the f32 instance fed the
upcast messages (the conversion is exact).  Prints the card's name and
power limit, then one JSON line per instance; exits non-zero without a
CUDA device or if an output differs.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
D = 200


def main() -> None:
    sys.path.insert(0, str(REPO))
    import torch

    if not torch.cuda.is_available():
        print("time_softmax: no CUDA device", file=sys.stderr)
        sys.exit(1)
    from chip_smoke import FLAGSHIP, time_graph
    from phc_gnn_torch.data import synthetic_batch
    from phc_gnn_torch.graph import attach_csr_plan
    from phc_gnn_torch.ops import segment_softmax as ss

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    b = attach_csr_plan(synthetic_batch(seed=0, **FLAGSHIP)).to(dev)
    gen = torch.Generator().manual_seed(7)
    m16 = torch.randn((b.num_edges, D), generator=gen).to(dev).to(
        torch.bfloat16)
    off = torch.empty(m16.numel() + 1, dtype=torch.bfloat16,
                      device=dev)[1:].view(m16.shape)
    off.copy_(m16)
    mask, rowptr = b.edge_mask, b.rowptr
    beta = torch.tensor(1.37, device=dev)
    instances = {"f32": m16.float(), "bf16 pairs": m16, "bf16 scalar": off}
    want = None
    ok = True
    for name, m in instances.items():
        smax = ss.segment_logit_max(m, mask, beta, rowptr)
        got = (smax, *ss.segment_softmax_aggregate(m, mask, beta, rowptr,
                                                   smax, emit_w=True),
               ss.segment_softmax_aggregate(m, mask, beta, rowptr, smax))
        torch.cuda.synchronize()
        if want is None:
            want = got
        same = all(torch.equal(x, y) for x, y in zip(got, want))
        ok &= same
        line = {"instance": name, "edges": b.num_edges,
                "nodes": b.num_nodes, "d": D,
                "A_us": time_graph(torch, lambda: ss.segment_logit_max(
                    m, mask, beta, rowptr)) * 1e3,
                "B_eval_us": time_graph(
                    torch, lambda: ss.segment_softmax_aggregate(
                        m, mask, beta, rowptr, smax)) * 1e3,
                "B_train_us": time_graph(
                    torch, lambda: ss.segment_softmax_aggregate(
                        m, mask, beta, rowptr, smax, emit_w=True)) * 1e3,
                "bit_equal_to_f32": same}
        print(json.dumps(line), flush=True)
    if not ok:
        sys.exit("time_softmax: an instance's output differs from f32's")


if __name__ == "__main__":
    main()
