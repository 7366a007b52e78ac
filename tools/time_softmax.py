#!/usr/bin/env python3
"""Time the softmax aggregation's kernels on one NVIDIA GPU at the
flagship's shape: A and B in each instance the wrappers can launch, and
the bf16 path the model runs (A then B, or the fused kernel).

    python3 tools/time_softmax.py [--root DIR] [--label NAME]

Messages [E, 200] over the receiver CSR of ``attach_csr_plan`` on
``synthetic_batch(128, 4096, 8192)`` (``chip_smoke.py``'s flagship batch).
Every time is device us per call from one CUDA graph of 100 calls (median
of 5 replays, ``chip_smoke.py``'s timer).

``--root`` names the checkout whose ``phc_gnn_torch`` is timed (default:
this one), so that two versions can be timed in turns on one card, one
process each: parent, change, change, parent.  Lines:

- one per instance of A and B: ``segment_logit_max`` (A),
  ``segment_softmax_aggregate`` in its eval variant (B) and in its
  training variant (B, writing ``w`` and ``den``); the instances are
  ``f32`` (float32 messages), ``bf16 pairs`` (bfloat16 messages, rows
  4-byte aligned, a thread a pair of lanes) and ``bf16 scalar`` (the same
  messages one element past a 4-byte boundary, one lane a thread); both
  bf16 instances held bit-equal to f32 fed the upcast messages;
- ``bf16 path``: what the checkout's model runs on bf16 messages, its eval
  forward (``segment_softmax`` without a gradient) and its training
  forward (``out``, ``w`` and ``den``: ``segment_softmax_fused`` where the
  checkout has it, else A then B's training variant), each timed as one
  call, with a SHA-256 of its outputs, so that two checkouts can be shown
  bit-equal; beside it A then B timed as a pair of calls in the same
  graph.

Prints the card's name and power limit first; exits non-zero without a
CUDA device or if an output differs.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
D = 200


def digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(REPO))
    ap.add_argument("--label", default="this checkout")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    sys.path.insert(1, str(REPO))
    import torch

    if not torch.cuda.is_available():
        print("time_softmax: no CUDA device", file=sys.stderr)
        sys.exit(1)
    from chip_smoke import FLAGSHIP, time_graph
    from phc_gnn_torch.data import synthetic_batch
    from phc_gnn_torch.graph import attach_csr_plan
    from phc_gnn_torch.ops import segment_softmax as ss

    if not Path(ss.__file__).resolve().is_relative_to(
            Path(args.root).resolve()):
        sys.exit(f"time_softmax: imported {ss.__file__}, not from "
                 f"{args.root}")
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
        line = {"label": args.label, "instance": name, "edges": b.num_edges,
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

    m = m16
    fused = getattr(ss, "segment_softmax_fused", None)

    def pair(emit_w):
        smax = ss.segment_logit_max(m, mask, beta, rowptr)
        return ss.segment_softmax_aggregate(m, mask, beta, rowptr, smax,
                                            emit_w)

    def path_train():
        return (fused(m, mask, beta, rowptr, emit_w=True) if fused
                else pair(True))

    def path_eval():
        return ss.segment_softmax(m, mask, beta, rowptr)

    got = (*path_train(), path_eval())
    ref = (*pair(True), pair(False))
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(got, ref))
    ok &= same
    print(json.dumps({
        "label": args.label, "instance": "bf16 path",
        "runs": "fused" if fused else "A then B",
        "eval_us": time_graph(torch, path_eval) * 1e3,
        "train_us": time_graph(torch, path_train) * 1e3,
        "pair_eval_us": time_graph(torch, lambda: pair(False)) * 1e3,
        "pair_train_us": time_graph(torch, lambda: pair(True)) * 1e3,
        "sha256": digest(got), "bit_equal_to_pair": same}), flush=True)

    if not ok:
        sys.exit("time_softmax: an output differs")


if __name__ == "__main__":
    main()
