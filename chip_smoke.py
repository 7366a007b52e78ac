#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (phc_gnn_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. card: the name and power limit that nvidia-smi reports;
2. build: every CUDA source of the port (phc_gnn_torch/csrc/*.cu) with nvcc;
3. kernels: each kernel against its plain PyTorch version on the card, at the
   main path's shapes (the CSR of synthetic_batch(128, 4096, 8192, seed=0),
   D = 200) and on adversarial segments (an isolated node, an all-masked
   segment inside the edge array, a segment of 1,100 edges, |beta * m| up to
   ~88 with beta = -2.75); timed with CUDA events.  Where the plain segment
   max is the identity -2^100 (empty and all-masked segments) the kernel
   must give it exactly; the other entries are held to the tolerance;
4. slice: the flagship model (bench.py's config: PHCGNN phm_dim=4, width 200,
   4 x PHMGINEConvSoftmax, soft-attention pooling, (200, 100) -> 1 head) at
   random weights from a seed, with random running stats and betas, served
   through ``train.make_eval_step`` on 3 batches.  The launch counters are
   zeroed just before and read just after; every kernel must have run.  The
   outputs are held to the same model and batches on the CPU, where the
   kernels' plain versions run.  A CUDA batch without its CSR plan must
   raise.  Last, the forward is timed from a CUDA graph and profiled
   (kernels per forward, device busy time and idle share).

It prints a ``{"kernels": [...]}`` line, then, as its last line,
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits non-zero
and prints no result.  It imports nothing of JAX.
"""

from __future__ import annotations

import copy
import json
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA's data sheet
FP32_FLOP_PER_S = 67e12     # H100 SXM, f32 outside the tensor cores
TOL_MAX = 1e-6              # segment max: order-free, the same f32 products
TOL_AGG = 1e-5              # softmax aggregate: exp ulps, summation order
TOL_MODEL = 1e-4            # whole model, GPU vs CPU: 4 layers of f32 GEMMs
N_BATCHES = 3
FLAGSHIP = dict(batch_size=128, num_nodes=4096, num_edges=8192)
DIM = 200


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def normwise(got, want, identity=None):
    """(max abs err, max abs err / max(1, max |want|)) over the entries where
    ``want`` is not ``identity`` (the max identity of an empty segment).
    Those must hold ``identity`` exactly in ``got``, or both errors are inf."""
    got, want = got.double(), want.double()
    if identity is not None:
        empty = want == identity
        if not bool((got[empty] == identity).all()):
            return float("inf"), float("inf")
        got, want = got[~empty], want[~empty]
    if want.numel() == 0:
        return 0.0, 0.0
    err = float((got - want).abs().max())
    return err, err / max(1.0, float(want.abs().max()))


def time_eager(torch, fn, iters: int = 200, warmup: int = 10) -> float:
    """ms per call of ``fn`` as the caller pays it: host launch included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_graph(torch, fn, iters: int = 100, reps: int = 5) -> float:
    """Device ms per call of ``fn``: ``iters`` calls captured in one CUDA graph,
    replayed; the median of ``reps`` replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def adversarial_case(torch, dev, d: int):
    """Receiver-sorted CSR segments that stress the identities (see the
    module docstring); 64 nodes, a 40-edge padding tail on the last node."""
    import numpy as np
    from phc_gnn_torch.graph.batch import build_csr_rowptr

    rng = np.random.default_rng(11)
    n = 64
    counts = rng.integers(1, 6, size=n)
    counts[3] = 0
    counts[7] = 1100
    recv = np.repeat(np.arange(n), counts)
    mask = rng.random(recv.shape[0]) > 0.25
    lo = counts[:11].sum()
    mask[lo:lo + counts[11]] = False
    recv = np.concatenate([recv, np.full(40, n - 1)]).astype(np.int32)
    mask = np.concatenate([mask, np.zeros(40, bool)])
    msgs = rng.uniform(-32.0, 32.0, size=(recv.shape[0], d)).astype(np.float32)
    rowptr = build_csr_rowptr(recv, n, mask)
    return (torch.from_numpy(msgs).to(dev), torch.from_numpy(mask).to(dev),
            torch.tensor(-2.75, device=dev), torch.from_numpy(rowptr).to(dev))


def kernel_phase(torch, dev):
    """Kernels vs plain versions at the main-path and adversarial shapes;
    returns the per-kernel records (launches filled in later)."""
    from phc_gnn_torch.data import synthetic_batch
    from phc_gnn_torch.graph import attach_csr_plan
    from phc_gnn_torch.ops import segment_softmax as ss

    batch = attach_csr_plan(synthetic_batch(seed=0, **FLAGSHIP)).to(dev)
    gen = torch.Generator().manual_seed(0)
    msgs = torch.randn((batch.num_edges, DIM), generator=gen).to(dev)
    main = (msgs, batch.edge_mask, torch.tensor(1.37, device=dev), batch.rowptr)
    cases = {"main": main, "adversarial": adversarial_case(torch, dev, DIM)}

    errs = {"segment_logit_max": [], "segment_softmax_aggregate": []}
    for name, (m, k, b, rp) in cases.items():
        before = (ss.segment_logit_max.launches,
                  ss.segment_softmax_aggregate.launches)
        smax = ss.segment_logit_max(m, k, b, rp)
        out, w = ss.segment_softmax_aggregate(m, k, b, rp, smax, emit_w=True)
        out_nw = ss.segment_softmax_aggregate(m, k, b, rp, smax)
        torch.cuda.synchronize()
        if (ss.segment_logit_max.launches != before[0] + 1
                or ss.segment_softmax_aggregate.launches != before[1] + 2):
            fail(f"{name}: the launch counters did not move")
        smax_ref = ss.segment_logit_max_plain(m, k, b, rp)
        out_ref, w_ref = ss.segment_softmax_aggregate_plain(
            m, k, b, rp, smax_ref, emit_w=True)
        for tensor in (smax, out, w, out_nw):
            if not torch.isfinite(tensor).all():
                fail(f"{name}: non-finite kernel output")
        n_empty = int((smax_ref == ss.NEG).all(dim=1).sum())
        checks = (("segment_logit_max", smax, smax_ref, TOL_MAX),
                  ("segment_softmax_aggregate", out, out_ref, TOL_AGG),
                  ("segment_softmax_aggregate", out_nw, out_ref, TOL_AGG),
                  ("segment_softmax_aggregate", w, w_ref, TOL_AGG))
        for kname, got, want, tol in checks:
            abs_err, rel_err = normwise(got, want, identity=ss.NEG)
            errs[kname].append((abs_err, rel_err))
            print(f"kernel {kname} [{name}]: max abs err {abs_err:.3e}, "
                  f"normwise rel err {rel_err:.3e} (tolerance {tol:g}; "
                  f"{n_empty} empty or all-masked segments must hold -2^100 "
                  f"exactly in the segment max)", flush=True)
            if not rel_err <= tol:
                fail(f"{kname} disagrees with its plain version on {name}")
        if name == "adversarial":
            if not (bool((out[3] == 0).all()) and bool((out[11] == 0).all())):
                fail("isolated or all-masked segment did not give 0")

    # timing at the main path's shapes
    m, k, b, rp = main
    smax = ss.segment_logit_max(m, k, b, rp)
    n, d = rp.shape[0] - 1, m.shape[1]
    e_seg = int(rp[-1])  # edges inside segments: what these inputs need
    seg = torch.repeat_interleave(torch.arange(n, device=dev),
                                  (rp[1:] - rp[:-1]).long())
    logits = torch.where(k[:e_seg, None], b * m[:e_seg], ss.NEG)
    index = seg[:, None].expand(e_seg, d).contiguous()
    init = torch.full((n, d), ss.NEG, device=dev)

    def library_amax():
        return init.scatter_reduce(0, index, logits, "amax")

    in_bytes = e_seg * d * 4 + e_seg + (n + 1) * 4 + 4
    nd_bytes = n * d * 4
    specs = [
        ("segment_logit_max", "phc_gnn_tpu/ops/stream_scan.py:415",
         lambda: ss.segment_logit_max(m, k, b, rp),
         lambda: ss.segment_logit_max_plain(m, k, b, rp),
         library_amax, in_bytes + nd_bytes, 2 * e_seg * d),
        ("segment_softmax_aggregate", "phc_gnn_tpu/ops/stream_scan.py:521",
         lambda: ss.segment_softmax_aggregate(m, k, b, rp, smax),
         lambda: ss.segment_softmax_aggregate_plain(m, k, b, rp, smax),
         None, in_bytes + 2 * nd_bytes, 6 * e_seg * d + n * d),
    ]
    records = []
    for name, replaces, fn, plain, library, nbytes, flops in specs:
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / FP32_FLOP_PER_S * 1e3
        rec = {
            "name": name, "route": "cuda",
            "source": "phc_gnn_torch/csrc/segment_softmax.cu",
            "replaces": replaces, "launches": None,
            "max_abs_err": max(a for a, _ in errs[name]),
            "max_rel_err": max(r for _, r in errs[name]),
            "ms": time_eager(torch, fn),
            "graph_ms": time_graph(torch, fn),
            "plain_ms": time_eager(torch, plain),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes,
            "library_ms": time_eager(torch, library) if library else None,
            "library_graph_ms": time_graph(torch, library) if library else None,
        }
        for key in ("ms", "graph_ms", "plain_ms", "bound_ms", "library_ms"):
            us = key[:-2] + "us"
            rec[us] = rec[key] * 1e3 if rec[key] is not None else None
        print(f"kernel {name}: {rec['ms'] * 1e3:.2f} us per call, "
              f"{rec['graph_ms'] * 1e3:.2f} us device (CUDA graph), plain "
              f"{rec['plain_ms'] * 1e3:.2f} us, bound {rec['bound_ms'] * 1e3:.2f} us "
              f"({nbytes / 1e6:.2f} MB)", flush=True)
        records.append(rec)
    return records


def randomize_eval_state(torch, model, seed: int = 1):
    """Random BN running stats (mean ~ N(0, 0.3), var ~ U(0.5, 2)) and betas
    (~ U(0.5, 2.5)), drawn on the CPU from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith(".mean"):
                buf.copy_(torch.randn(buf.shape, generator=gen) * 0.3)
            elif name.endswith(".var"):
                buf.copy_(torch.rand(buf.shape, generator=gen) * 1.5 + 0.5)
        for name, p in model.named_parameters():
            if name.endswith(".beta"):
                p.copy_(torch.rand((), generator=gen) * 2.0 + 0.5)


def slice_phase(torch, dev):
    """The flagship eval forward through the kernels; returns the launch
    counts of the main-path run."""
    from phc_gnn_torch.data import ZINC_ATOM_DIMS, ZINC_BOND_DIMS, synthetic_batch
    from phc_gnn_torch.graph import attach_csr_plan
    from phc_gnn_torch.models import PHCGNN
    from phc_gnn_torch.ops import segment_softmax as ss
    from phc_gnn_torch.train import make_eval_step

    cfg = dict(phm_dim=4, atom_input_dims=ZINC_ATOM_DIMS,
               bond_input_dims=ZINC_BOND_DIMS, atom_encoded_dim=DIM,
               mp_layers=(DIM,) * 4, dropout_mpnn=(0.1,) * 4,
               downstream_layers=(200, 100), target_dim=1,
               dropout_dn=(0.2, 0.1), msg_aggr="softmax", mlp_mp=True,
               sc_type="last")
    model = PHCGNN(**cfg, seed=0, device=dev)
    randomize_eval_state(torch, model)
    host_batches = [attach_csr_plan(synthetic_batch(seed=s, **FLAGSHIP))
                    for s in range(N_BATCHES)]
    batches = [b.to(dev) for b in host_batches]
    step = make_eval_step(model, device=dev)
    try:
        step(batches[0].replace(rowptr=None))
    except ValueError as exc:
        print(f"slice: a CUDA batch without its CSR plan raises: {exc}",
              flush=True)
    else:
        fail("a CUDA batch without a CSR plan was served without the kernels")

    ss.segment_logit_max.launches = 0
    ss.segment_softmax_aggregate.launches = 0
    outs = [step(b) for b in batches]
    torch.cuda.synchronize()
    launches = {"segment_logit_max": ss.segment_logit_max.launches,
                "segment_softmax_aggregate": ss.segment_softmax_aggregate.launches}
    want = 4 * N_BATCHES
    print(f"slice: launches on the main path {launches} "
          f"(expected {want} each: 4 layers x {N_BATCHES} batches)", flush=True)
    for name, count in launches.items():
        if count != want:
            fail(f"{name} ran {count} times on the main path, not {want}")

    cpu_step = make_eval_step(copy.deepcopy(model).to("cpu"), device="cpu")
    for i, (out, hb) in enumerate(zip(outs, host_batches)):
        if out.shape != (FLAGSHIP["batch_size"] + 1, 1):
            fail(f"batch {i}: output shape {tuple(out.shape)}")
        if not torch.isfinite(out).all():
            fail(f"batch {i}: non-finite output")
        ref = cpu_step(hb)
        abs_err, rel_err = normwise(out.cpu(), ref)
        print(f"slice: batch {i} vs CPU plain path: max abs err {abs_err:.3e}, "
              f"normwise rel err {rel_err:.3e} (tolerance {TOL_MODEL:g}), "
              f"max |out| {float(ref.abs().max()):.3f}", flush=True)
        if not rel_err <= TOL_MODEL:
            fail(f"batch {i}: GPU output disagrees with the CPU path")

    real_edges = host_batches[0].count_edges()
    b0 = batches[0]
    for _ in range(5):
        step(b0)
    torch.cuda.synchronize()
    dev_ms, host_ms = [], []
    for _ in range(30):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        step(b0)
        end.record()
        end.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        dev_ms.append(start.elapsed_time(end))
    eval_ms = statistics.median(dev_ms)
    print(f"slice: eval {eval_ms:.3f} ms per batch (CUDA events, median of 30; "
          f"host clock {statistics.median(host_ms):.3f} ms), "
          f"{real_edges / (eval_ms / 1e3):.4g} real edges/s "
          f"({real_edges} real edges)", flush=True)
    print(json.dumps({"slice": {"eval_ms": eval_ms,
                                "eval_host_ms": statistics.median(host_ms),
                                "real_edges": real_edges,
                                "real_edges_per_s": real_edges / (eval_ms / 1e3),
                                "batches": N_BATCHES}}), flush=True)
    profile_phase(torch, lambda: step(b0), eval_ms)
    return launches


def profile_phase(torch, forward, eval_ms: float, iters: int = 20) -> None:
    """Where the eval forward's time goes: the forward replayed from a CUDA
    graph (the host's launch cost taken away), and from torch.profiler the
    kernels per forward, the device's busy time (sum of kernel durations),
    its idle share of the eager forward (1 - busy / eval_ms) and the kernels
    that take the most device time.  Prints one ``{"profile": ...}`` line."""
    graph_eval_ms = time_graph(torch, forward, iters=iters)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            forward()
        torch.cuda.synchronize()
    by_name: dict = {}
    n_kernels = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n_kernels += 1
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    if not n_kernels:
        fail("the profiler recorded no device kernels")
    busy_ms = sum(by_name.values()) / 1e3 / iters
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    print(f"profile: {n_kernels / iters:g} kernels per forward, device busy "
          f"{busy_ms:.3f} ms of {eval_ms:.3f} ms eager (idle "
          f"{100 * (1 - busy_ms / eval_ms):.1f} %), {graph_eval_ms:.3f} ms "
          f"from one CUDA graph", flush=True)
    print(json.dumps({"profile": {
        "graph_eval_ms": graph_eval_ms,
        "kernels_per_forward": n_kernels / iters,
        "device_busy_ms_per_forward": busy_ms,
        "device_idle_share_eager": 1.0 - busy_ms / eval_ms,
        "top_kernels_us_per_forward": [[name[:90], us / iters]
                                       for name, us in top]}}), flush=True)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs the port on a GPU")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)

    from phc_gnn_torch.ops import _build

    t0 = time.perf_counter()
    names = _build.source_names()
    for name in names:
        _build.load(name)
    print(f"build: {time.perf_counter() - t0:.1f} s for {names} "
          f"(nvcc {' '.join(_build.NVCC_FLAGS)})", flush=True)

    records = kernel_phase(torch, dev)
    launches = slice_phase(torch, dev)
    for rec in records:
        rec["launches"] = launches[rec["name"]]
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
