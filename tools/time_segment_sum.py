#!/usr/bin/env python3
"""Time the segment sum C in both its roles on one NVIDIA GPU at the shapes
where the main paths launch it.

    python3 tools/time_segment_sum.py [--root DIR] [--label NAME] [--pcba]
                                      [--dtype f32|bf16]

Shapes (messages [E, D] into N segments over the CSRs of ``attach_csr_plan``;
pcba's batches carry 9 atom and 3 bond features):

- ``segment_sum_masked`` at pcba's eval, ``synthetic_batch(512, 16384,
  32768)`` at D = 512, and at its train batch, ``synthetic_batch(128, 4096,
  8192)`` at D = 512 (the receiver CSR);
- ``segment_sum_perm`` at the flagship's batch at D = 200, at pcba's
  train batch at D = 512 and at pcba's 16,384-node batch at D = 512 (the
  gather backward of a train step on pcba's eval-sized bucket; the sender
  CSR);
- ``halo_gather_split_bwd`` (C's halo role, the perm role over a node
  shard's augmented rows) on shard 0 of the flagship's batch cut in 2 and
  in 4 (``partition_nodes``) at D = 200.

``--dtype bf16`` gives the rows in bfloat16 (the model's
``compute_dtype``; default float32).  Where the checkout has
``segment_sum_instance``, a bf16 line also times C's two instances on its
inputs, the bulk one (rows staged by the TMA's bulk copy) and the one
without it (``bulk_graph_us``, ``nobulk_graph_us``), each held bit-equal
to the wrapper's output.

``--root`` names the checkout whose ``phc_gnn_torch`` is timed (default:
this one), so that two versions of the kernel can be timed in turns on one
card, one process each: parent, change, change, parent.  Per shape: device
us per call from one CUDA graph of 100 calls (median of 5 replays;
``chip_smoke.py``'s timer), us per eager call (200 calls between two CUDA
events), the host us of the wrapper's call (``host_us``) and, where the
checkout has a plan, of its lookup, the CUDA kernels one call launches (``torch.profiler`` over 20 calls), the bound (each live row read
once in its own dtype, the CSR, the mask or perm of the edges in segments,
each output row written once, at 3.35 TB/s), one ``index_add_`` of the
live rows (upcast to float32 beforehand: a bf16 ``index_add_`` would sum
in bf16) as the library call (device us), a second launch bit-equal to the
first, and a SHA-256 of the output, so that two checkouts can be shown
bit-equal.
Where the checkout has ``segment_sum_plan``, the line carries the plan.
``--pcba
also times and profiles the pcba eval forward on its 512-graph batch
(``chip_smoke.py``'s model, weights and running stats): ms, ms from a CUDA
graph, kernels per forward, device busy.

Prints the card's name and power limit, then one JSON line per shape, and
one with the host us of the stream lookup that every wrapper makes
(``torch.cuda.current_stream`` and the checkout's ``_build.stream``).
Exits non-zero without a CUDA device or if a relaunch differs.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
HBM_BYTES_PER_S = 3.35e12
PCBA_FEATS = dict(target_dim=128, num_node_feats=9, num_edge_feats=3)
# (name, role, batch shape, width)
SHAPES = (
    ("masked, pcba eval", "masked", dict(batch_size=512, num_nodes=16384,
                                         num_edges=32768, **PCBA_FEATS), 512),
    ("masked, pcba train", "masked", dict(batch_size=128, num_nodes=4096,
                                          num_edges=8192, **PCBA_FEATS), 512),
    ("perm, flagship", "perm", dict(batch_size=128, num_nodes=4096,
                                    num_edges=8192), 200),
    ("perm, pcba train", "perm", dict(batch_size=128, num_nodes=4096,
                                      num_edges=8192, **PCBA_FEATS), 512),
    ("perm, pcba 16k", "perm", dict(batch_size=512, num_nodes=16384,
                                    num_edges=32768, **PCBA_FEATS), 512),
    ("halo, 2 shards", "halo", dict(batch_size=128, num_nodes=4096,
                                    num_edges=8192, shards=2), 200),
    ("halo, 4 shards", "halo", dict(batch_size=128, num_nodes=4096,
                                    num_edges=8192, shards=4), 200))


def digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def kernels_of(torch, fn, iters: int = 20) -> dict:
    """The CUDA kernels a call of ``fn`` launches, with each one's device
    us per call, over ``iters`` calls."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    count = 0
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not e.is_user_annotation):
            count += 1
            found = re.search(r"segment_sum\w*", e.name)
            name = found.group(0) if found else e.name[:60]
            by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us()
    return {"kernels_per_call": count / iters,
            "us": {k: v / iters for k, v in by_name.items()}}


def case(torch, dev, role, shape, d, dtype):
    """(kernel call, library call, inputs, bytes, the role's entry point
    name for ``segment_sum_instance``) of one shape."""
    from phc_gnn_torch.data import synthetic_batch
    from phc_gnn_torch.graph import attach_csr_plan
    from phc_gnn_torch.ops import segment_sum as ssum

    shape = dict(shape)
    shards = shape.pop("shards", 0)
    if shards:
        from phc_gnn_torch.parallel import partition_nodes
        b = partition_nodes(synthetic_batch(seed=0, **shape), shards)[0]
        b = b.to(dev)
    else:
        b = attach_csr_plan(synthetic_batch(seed=0, **shape)).to(dev)
    gen = torch.Generator().manual_seed(d + b.num_nodes)
    values = torch.randn((b.num_edges, d), generator=gen).to(dev).to(dtype)
    if role == "masked":
        index, rowptr = b.edge_mask, b.rowptr
        seg = ssum.segment_ids(rowptr)
        real = index[:seg.shape[0]].nonzero()[:, 0]
        rows, where = values[real], seg[real]
        fn = ssum.segment_sum_masked
        entry_bytes = int(rowptr[-1])
    else:
        index, rowptr = b.snd_perm, b.snd_rowptr
        e_real = int(rowptr[-1])
        real = index[:e_real].long()
        rows, where = values[real], b.senders[real].long()
        fn = ssum.segment_sum_perm
        if role == "halo":
            fn = lambda v, i, r: ssum.halo_gather_split_bwd(  # noqa: E731
                v, i, r, b.num_nodes)
        entry_bytes = 4 * e_real
    n = rowptr.shape[0] - 1
    zeros = torch.zeros((n, d), device=dev)
    rows = rows.float()
    nbytes = (rows.shape[0] * d * values.element_size() + entry_bytes
              + 4 * (n + 1) + n * d * 4)
    return ((lambda: fn(values, index, rowptr)),
            (lambda: zeros.clone().index_add_(0, where, rows)),
            (values, index, rowptr), nbytes,
            "masked" if role == "masked" else "perm")


def host_us(torch, fn, calls: int = 50, reps: int = 21) -> float:
    """Host us per call of ``fn``: the host clock around ``calls`` calls
    without a sync between them (too few to fill the launch queue), the
    median of ``reps`` such loops, each after the device has drained."""
    for _ in range(3):
        fn()
    per_call = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        per_call.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return statistics.median(per_call)


def pcba_eval(torch, dev) -> dict:
    """The pcba eval forward of the checkout's ``chip_smoke.py``, timed and
    profiled as its pcba eval phase does."""
    import chip_smoke as cs
    from phc_gnn_torch.train import make_eval_step

    model, _, _ = cs.pcba_model(torch, dev)
    cs.randomize_eval_state(torch, model)
    batch = cs.pcba_batch(torch, 0, cs.PCBA_EVAL).to(dev)
    step = make_eval_step(model, device=dev)
    eval_ms, host_ms = cs.time_steps(torch, lambda: step(batch))
    graph_ms = cs.time_graph(torch, lambda: step(batch), iters=10)
    prof = cs.device_profile(torch, lambda: step(batch), eval_ms, iters=10)
    return {"pcba_eval_ms": eval_ms, "pcba_eval_host_ms": host_ms,
            "pcba_eval_graph_ms": graph_ms,
            "pcba_eval_kernels_per_forward": prof["kernels_per_call"],
            "pcba_eval_device_busy_ms": prof["busy_ms"]}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(REPO))
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--pcba", action="store_true",
                    help="also time and profile the pcba eval forward")
    ap.add_argument("--dtype", choices=("f32", "bf16"), default="f32",
                    help="the rows' dtype")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    sys.path.insert(1, str(REPO))
    import torch

    if not torch.cuda.is_available():
        print("time_segment_sum: no CUDA device", file=sys.stderr)
        sys.exit(1)
    from chip_smoke import time_eager, time_graph
    from phc_gnn_torch.ops import segment_sum as ssum

    if not Path(ssum.__file__).resolve().is_relative_to(
            Path(args.root).resolve()):
        sys.exit(f"time_segment_sum: imported {ssum.__file__}, not from "
                 f"{args.root}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False  # as chip_smoke.py
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    same = True

    def flat(out):
        return torch.cat(out) if isinstance(out, tuple) else out

    for name, role, shape, d in SHAPES:
        fn, library, (values, index, rowptr), nbytes, entry = case(
            torch, dev, role, shape, d, dtype)
        first, again = flat(fn()), flat(fn())
        torch.cuda.synchronize()
        same &= torch.equal(first, again)
        line = {"label": args.label, "case": name, "role": role,
                "dtype": args.dtype,
                "segments": rowptr.shape[0] - 1, "edges": values.shape[0],
                "d": d, "bit_equal_on_relaunch": torch.equal(first, again),
                "sha256": digest([first]),
                "graph_us": time_graph(torch, fn) * 1e3,
                "eager_us": time_eager(torch, fn) * 1e3,
                "host_us": host_us(torch, fn),
                "bound_us": nbytes / HBM_BYTES_PER_S * 1e6, "bytes": nbytes,
                "library_graph_us": time_graph(torch, library) * 1e3,
                "cuda_kernels": kernels_of(torch, fn)}
        if hasattr(ssum, "segment_sum_plan"):
            plan_args = (rowptr.shape[0] - 1, values.shape[0], d,
                         entry == "perm", values.data_ptr() % 16 == 0,
                         values.element_size())
            line["plan"] = ssum.segment_sum_plan(*plan_args)._asdict()
            line["plan_lookup_host_us"] = host_us(
                torch, lambda: ssum.segment_sum_plan(*plan_args), calls=1000)
        if dtype == torch.bfloat16 and hasattr(ssum, "segment_sum_instance"):
            for key, bulk in (("bulk", True), ("nobulk", False)):
                def inst(bulk=bulk):
                    return ssum.segment_sum_instance(entry, values, index,
                                                     rowptr, bulk)
                out = inst()
                torch.cuda.synchronize()
                equal = torch.equal(out, first)
                same &= equal
                line[f"{key}_graph_us"] = time_graph(torch, inst) * 1e3
                line[f"{key}_bit_equal"] = equal
        print(json.dumps(line), flush=True)
    # the stream lookup every wrapper makes: PyTorch's public call, and the
    # checkout's helper
    from phc_gnn_torch.ops import _build
    print(json.dumps({
        "label": args.label,
        "current_stream_host_us": host_us(
            torch, lambda: torch.cuda.current_stream(dev).cuda_stream,
            calls=1000),
        "build_stream_host_us": host_us(torch, lambda: _build.stream(dev),
                                        calls=1000)}), flush=True)
    if args.pcba:
        print(json.dumps({"label": args.label, **pcba_eval(torch, dev)}),
              flush=True)
    if not same:
        sys.exit("time_segment_sum: a second launch or an instance differs")


if __name__ == "__main__":
    main()
