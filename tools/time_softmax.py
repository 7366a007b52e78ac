#!/usr/bin/env python3
"""Time the softmax aggregation's kernels on one NVIDIA GPU at the
flagship's shape: A and B in each instance the wrappers can launch, the
f32 and bf16 paths the model runs (A then B, or the fused kernel), and
the backward (the kernel against the plain backward's sequence).

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
- ``f32 path`` and ``bf16 path``: what the checkout's model runs on
  float32 and bf16 messages, its eval forward (``segment_softmax`` without
  a gradient) and its training forward (``out``, ``w`` and ``den``:
  ``segment_softmax_fused`` where the checkout has it for the dtype, else
  A then B's training variant), each timed as one call, with a SHA-256 of
  its outputs, so that two checkouts can be shown bit-equal; beside it A
  then B timed as a pair of calls in the same graph, in turns (pair,
  path, path, pair);
- ``f32 lanes`` (a checkout with the fused kernel on float32 rows): its
  eval and training variants on rows 16-byte aligned (four lanes a
  thread), 8 bytes off (two) and 4 bytes off (one), in turns, bit-equal;
- ``backward f32`` and ``backward bf16`` (a checkout with the backward
  kernel): ``segment_softmax_backward`` against
  ``segment_softmax_backward_plain`` on the card (the port's backward
  before the kernel), in turns (kernel, plain, plain, kernel), the plain
  sequence's CUDA kernels a call, ``dm`` bit-equal, and a SHA-256 of
  ``dm``.

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
    import torch

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().view(torch.uint8).numpy()
                 .tobytes())
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

    for name, m in (("f32 path", instances["f32"]), ("bf16 path", m16)):
        ok &= time_path(torch, ss, time_graph, digest, args.label, name, m,
                        mask, beta, rowptr)
    if fused_takes(torch, ss, instances["f32"], mask, beta, rowptr):
        ok &= time_lanes(torch, ss, time_graph, args.label,
                         instances["f32"], mask, beta, rowptr)
    if hasattr(ss, "segment_softmax_backward"):
        from chip_smoke import device_profile
        g = torch.randn((b.num_nodes, D), generator=gen).to(dev)
        for name, m in (("backward f32", instances["f32"]),
                        ("backward bf16", m16)):
            ok &= time_backward(torch, ss, time_graph, device_profile, digest,
                                args.label, name, m, mask, beta, rowptr,
                                b.receivers, g)

    if not ok:
        sys.exit("time_softmax: an output differs")


def fused_takes(torch, ss, m, mask, beta, rowptr) -> bool:
    """Whether the checkout's fused kernel takes ``m``'s dtype (an older
    one takes bf16 rows alone and raises on float32)."""
    if not hasattr(ss, "segment_softmax_fused"):
        return False
    try:
        ss.segment_softmax_fused(m, mask, beta, rowptr)
    except (TypeError, RuntimeError) as exc:
        if "bfloat16" not in str(exc):
            raise
        return False
    return True


def time_path(torch, ss, time_graph, digest, label, name, m, mask, beta,
              rowptr) -> bool:
    """The ``f32 path`` or ``bf16 path`` line; whether the path's outputs
    are bit-equal to A then B."""
    fused = fused_takes(torch, ss, m, mask, beta, rowptr)

    def pair(emit_w):
        smax = ss.segment_logit_max(m, mask, beta, rowptr)
        return ss.segment_softmax_aggregate(m, mask, beta, rowptr, smax,
                                            emit_w)

    def path_train():
        return (ss.segment_softmax_fused(m, mask, beta, rowptr, emit_w=True)
                if fused else pair(True))

    def path_eval():
        return ss.segment_softmax(m, mask, beta, rowptr)

    got = (*path_train(), path_eval())
    ref = (*pair(True), pair(False))
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(got, ref))
    times = {k: [] for k in ("eval_us", "train_us", "pair_eval_us",
                             "pair_train_us")}
    for fns in ((("pair_eval_us", lambda: pair(False)),
                 ("pair_train_us", lambda: pair(True))),
                (("eval_us", path_eval), ("train_us", path_train)),
                (("eval_us", path_eval), ("train_us", path_train)),
                (("pair_eval_us", lambda: pair(False)),
                 ("pair_train_us", lambda: pair(True)))):
        for key, fn in fns:
            times[key].append(time_graph(torch, fn) * 1e3)
    print(json.dumps({"label": label, "instance": name,
                      "runs": "fused" if fused else "A then B", **times,
                      "sha256": digest(got), "bit_equal_to_pair": same}),
          flush=True)
    return same


def time_lanes(torch, ss, time_graph, label, m, mask, beta, rowptr) -> bool:
    """The ``f32 lanes`` line; whether the three instances are bit-equal."""
    rows = {}
    for lanes, k in ((4, 0), (2, 2), (1, 1)):
        buf = torch.empty(m.numel() + k, dtype=m.dtype, device=m.device)
        rows[lanes] = buf[k:].view(m.shape)
        rows[lanes].copy_(m)
    outs = {lanes: ss.segment_softmax_fused(r, mask, beta, rowptr, True)
            for lanes, r in rows.items()}
    torch.cuda.synchronize()
    same = all(all(torch.equal(x, y) for x, y in zip(o, outs[4]))
               for o in outs.values())
    times = {f"{lanes}_lanes_{v}_us": [] for lanes in rows
             for v in ("eval", "train")}
    for order in (list(rows), list(rows)[::-1]):
        for lanes in order:
            for v, emit in (("eval", False), ("train", True)):
                times[f"{lanes}_lanes_{v}_us"].append(time_graph(
                    torch, lambda: ss.segment_softmax_fused(
                        rows[lanes], mask, beta, rowptr, emit)) * 1e3)
    print(json.dumps({"label": label, "instance": "f32 lanes", **times,
                      "bit_equal": same}), flush=True)
    return same


def time_backward(torch, ss, time_graph, device_profile, digest, label,
                  name, m, mask, beta, rowptr, recv, g) -> bool:
    """A ``backward`` line; whether ``dm`` is bit-equal to the plain
    backward's."""
    out, w, den = ss.segment_softmax_fused(m, mask, beta, rowptr, True)
    args = (m, beta, w, den, out, g)

    def kernel():
        return ss.segment_softmax_backward(*args, rowptr, recv)

    def plain():
        return ss.segment_softmax_backward_plain(*args, recv)

    dm, db = kernel()
    pdm, pdb = plain()
    torch.cuda.synchronize()
    same = torch.equal(dm, pdm)
    times = {"kernel_us": [], "plain_us": []}
    for key in ("kernel_us", "plain_us", "plain_us", "kernel_us"):
        times[key].append(time_graph(
            torch, kernel if key == "kernel_us" else plain) * 1e3)
    print(json.dumps({
        "label": label, "instance": name, **times,
        "plain_kernels_a_call": device_profile(
            torch, plain, 1.0, iters=20)["kernels_per_call"],
        "dbeta": float(db), "plain_dbeta": float(pdb),
        "sha256": digest([dm]), "dm_bit_equal_to_plain": same}), flush=True)
    return same


if __name__ == "__main__":
    main()
