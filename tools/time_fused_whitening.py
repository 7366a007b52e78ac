#!/usr/bin/env python3
"""Time the whitening kernels J (``wbn_stats``), K (``wbn_transform``, and
the eval route that factors the running covariance in it), L
(``wbn_bwd_sums``, with its frozen variant, and the frozen one that writes
dx) and M's frozen variant alone (``wbn_dx(..., frozen=True)``) on one
NVIDIA GPU at the quaternion path's [4096, 200] (d = 50), with the flagship
batch's node mask.

    python3 tools/time_fused_whitening.py [--root DIR] [--label NAME] [--quat]

``--root`` names the checkout whose ``phc_gnn_torch`` is timed (default:
this one), so that two versions of the kernels can be timed in turns on one
card, one process each: parent, change, change, parent.  Where the
checkout has ``wbn_plan``, the line carries its plans at [4096, 200] and
the clusters of 1, 2, 4, 8 and 16 CTAs that the card holds at once for each
of J, L and L frozen (``_max_active_clusters``).

Per wrapper: device us per call from one CUDA graph of 100 calls (median of
5 replays; ``chip_smoke.py``'s timer), us per eager call (200 calls between
two CUDA events), the host us of the wrapper's call (``host_us`` of
``tools/time_segment_sum.py``), and the CUDA
kernels one call launches with each one's device us (``torch.profiler``
over 20 calls).  A second launch of J, K, the eval route, L and L frozen
must be bit-equal to the first.  The eval route is the checkout's
``wbn_transform_eval``, or, where it has none, its eval Cholesky
(``wbn_cholesky``) then K: ``(y, L)`` either way.  The eval backward's
frozen L with dx is the checkout's ``wbn_bwd_sums(..., frozen=True,
with_dx=True)``, or, where it has none, the frozen L then M's frozen
variant: ``(dGamma, dbeta, dx)`` either way; beside it the frozen L then
M's frozen variant alone, two launches in any checkout.  The line carries
SHA-256 digests of each call's outputs, one an output (K and the eval
route on the plain versions' statistics from the CPU, the route from their
covariance; the rest on J's), and ``m_sha256`` those of M (training),
M's frozen variant alone and the frozen L with dx on the plain versions'
statistics, so that two checkouts can be shown bit-equal there.

With ``--quat``, it also times and profiles ``chip_smoke.py``'s quaternion
add preset: the train step (ms, kernels per step, device busy and idle
share), the eval forward (ms from a CUDA graph, kernels per batch, device
busy) and the eval gradient (ms, kernels per call, device busy); then,
apart, the host us a train step spends inside the calls of ``wbn_stats``
and ``wbn_bwd_sums`` (the host clock around each call, 30 steps).  Last,
it compiles the checkout's ``csrc/fused_whitening.cu`` once more with
``-Xptxas -v`` (into the checkout's build directory) and carries each
kernel's registers, stack frame and spill bytes.

Prints the card's name and power limit, then one JSON line.  Exits non-zero
without a CUDA device.
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import inspect
import json
import re
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
N, D = 4096, 50


def digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def digests(tensors) -> list:
    """``digest`` of each output alone, so that one output of a call can be
    matched with another call's."""
    return [digest((t,)) for t in tensors]


def ptxas_report(build) -> dict:
    """{kernel: registers, stack frame and spill bytes} from ``nvcc -Xptxas
    -v`` of the checkout's ``csrc/fused_whitening.cu`` (``build`` is its
    ``phc_gnn_torch.ops._build``); the library goes to its build directory
    and is not loaded."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = build.BUILD_DIR / "ptxas_report.so"
    proc = subprocess.run(
        [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out),
         str(build.CSRC_DIR / "fused_whitening.cu")],
        capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        sys.exit(f"time_fused_whitening: nvcc -Xptxas -v failed:\n"
                 f"{proc.stderr}")
    report, name = {}, None
    for row in (proc.stdout + proc.stderr).splitlines():
        found = re.search(r"Compiling entry function '(\w+)'", row)
        if found:
            kernel = re.search(r"(wbn_\w+?_kernel)(I((?:Lb[01]E)+)E)?",
                               found.group(1))
            name = found.group(1)
            if kernel:
                flags = re.findall(r"Lb([01])E", kernel.group(3) or "")
                name = kernel.group(1) + (
                    f"<{', '.join('true' if f == '1' else 'false' for f in flags)}>"
                    if flags else "")
            report[name] = {}
        elif name and "spill stores" in row:
            stack, stores, loads = map(int, re.findall(r"(\d+) bytes", row))
            report[name].update(stack_bytes=stack, spill_store_bytes=stores,
                                spill_load_bytes=loads)
        elif name and "registers" in row:
            report[name]["registers"] = int(
                re.search(r"Used (\d+) registers", row).group(1))
    return report


def kernels_of(torch, fn, iters: int = 20) -> dict:
    """{CUDA kernel name: device us per call of ``fn``} over ``iters``
    calls, and the kernels a call launches."""
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
            found = re.search(r"wbn_\w+_kernel(<\w+>)?", e.name)
            name = found.group(0) if found else e.name[:60]
            by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us()
    return {"kernels_per_call": count / iters,
            "us": {k: v / iters for k, v in by_name.items()}}


def quat(torch, dev, fw) -> dict:
    """The quaternion add preset's train step and eval gradient, as
    ``chip_smoke.py`` builds, times and profiles them."""
    import chip_smoke as cs
    from phc_gnn_torch.data import synthetic_batch
    from phc_gnn_torch.graph import attach_csr_plan
    from phc_gnn_torch.train import make_optimizer, make_train_step, masked_l1

    batch = attach_csr_plan(synthetic_batch(seed=0, **cs.FLAGSHIP)).to(dev)
    model = cs.quat_model(torch, dev)
    opt = make_optimizer(dict(model.named_parameters()), grad_clip=cs.GRAD_CLIP)
    step = make_train_step(model, opt, lambda out, b: masked_l1(out, b.y),
                           weight_decay=cs.WEIGHT_DECAY, seed=0, device=dev)
    step_ms, host_ms = cs.time_steps(torch, lambda: step(batch, cs.LR))
    prof = cs.device_profile(torch, lambda: step(batch, cs.LR), step_ms)
    frozen = cs.quat_model(torch, dev, dropout=False).eval()
    cs.randomize_eval_state(torch, frozen)
    params = [p for p in frozen.parameters() if p.requires_grad]

    def eval_grad():
        loss = masked_l1(frozen(batch, training=False), batch.y)
        return torch.autograd.grad(loss, params)

    grad_ms, _ = cs.time_steps(torch, eval_grad)
    g_prof = cs.device_profile(torch, eval_grad, grad_ms)

    def eval_forward():
        with torch.no_grad():
            return frozen(batch, training=False)

    fwd_ms, _ = cs.time_steps(torch, eval_forward)
    fwd_graph_ms = cs.time_graph(torch, eval_forward, iters=10)
    f_prof = cs.device_profile(torch, eval_forward, fwd_ms)
    # the host time of J's and L's wrappers inside the step, timed apart so
    # that the shims do not touch the numbers above
    spent = {"wbn_stats": 0.0, "wbn_bwd_sums": 0.0}
    originals = {k: getattr(fw, k) for k in spent}

    def shim(name):
        # wraps copies the counter the wrapper's own body increments
        @functools.wraps(originals[name])
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            out = originals[name](*args, **kwargs)
            spent[name] += time.perf_counter() - t0
            return out
        return timed

    for k in spent:
        setattr(fw, k, shim(k))
    try:
        cs.time_steps(torch, lambda: step(batch, cs.LR), warmup=0)
    finally:
        for k, fn in originals.items():
            setattr(fw, k, fn)
    return {"quat_step_ms": step_ms, "quat_step_host_ms": host_ms,
            "quat_kernels_per_step": prof["kernels_per_call"],
            "quat_device_busy_ms": prof["busy_ms"],
            "quat_device_idle_share": prof["idle_share"],
            "quat_eval_ms": fwd_ms, "quat_eval_graph_ms": fwd_graph_ms,
            "quat_eval_kernels": f_prof["kernels_per_call"],
            "quat_eval_device_busy_ms": f_prof["busy_ms"],
            "quat_eval_grad_ms": grad_ms,
            "quat_eval_grad_kernels": g_prof["kernels_per_call"],
            "quat_eval_grad_device_busy_ms": g_prof["busy_ms"],
            "quat_step_host_us_in_wrappers": {
                k: v / 30 * 1e6 for k, v in spent.items()}}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(REPO))
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--quat", action="store_true",
                    help="also time and profile the quaternion train step "
                         "and eval gradient")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    sys.path.insert(1, str(REPO))
    import torch

    if not torch.cuda.is_available():
        print("time_fused_whitening: no CUDA device", file=sys.stderr)
        sys.exit(1)
    from chip_smoke import time_eager, time_graph
    from time_segment_sum import host_us
    from phc_gnn_torch.data import synthetic_batch
    from phc_gnn_torch.ops import fused_whitening as fw

    if not Path(fw.__file__).resolve().is_relative_to(
            Path(args.root).resolve()):
        sys.exit(f"time_fused_whitening: imported {fw.__file__}, not from "
                 f"{args.root}")
    line = {"label": args.label, "shape": [N, 4 * D]}
    if hasattr(fw, "wbn_plan"):
        line["plans"] = {str(s): fw.wbn_plan(N, D, s)._asdict()
                         for s in (fw.WBN_STATS_SUMS, fw.WBN_SUMS)}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False  # as chip_smoke.py
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    if hasattr(fw, "wbn_plan"):
        line["clusters_held"] = {
            kernel: {c: fw._max_active_clusters(fw.WbnPlan(
                fw.WBN_SLAB, c, 0, fw.wbn_smem_bytes(
                    fw.WBN_SLAB, c, fw.WBN_STATS_SUMS if kernel == "wbn_stats"
                    else fw.WBN_SUMS), 0), kernel) for c in (1, 2, 4, 8, 16)}
            for kernel in fw.WBN_KERNELS}
    gen = torch.Generator().manual_seed(6)
    x = torch.randn((N, 4 * D), generator=gen) * 1.5 + 0.5
    g = torch.randn((N, 4 * D), generator=gen)
    gamma = torch.randn((4, 4, D), generator=gen) * 0.2 + 0.5 * torch.eye(4)[
        ..., None]
    beta = torch.randn((4, D), generator=gen) * 0.3
    mask = synthetic_batch(128, 4096, 8192, seed=0).node_mask
    # K, the eval route and M on statistics made without J and L
    p_mean, p_cov, p_l, p_cnt = fw.wbn_stats_plain(x, mask, 1e-5)
    p_sums = fw.wbn_bwd_sums_plain(x, g, gamma, p_mean, p_l)
    x, g, gamma, beta, mask, p_mean, p_cov, p_l, p_cnt = (
        t.to(dev).contiguous() for t in (x, g, gamma, beta, mask, p_mean,
                                         p_cov, p_l, p_cnt))
    p_mmat, p_sw = (t.to(dev).contiguous() for t in p_sums[2:])

    def transform():
        return (fw.wbn_transform(x, p_mean, p_l, gamma, beta),)

    def eval_route():
        if hasattr(fw, "wbn_transform_eval"):
            return fw.wbn_transform_eval(x, p_mean, p_cov, gamma, beta, 1e-5)
        l = fw.wbn_cholesky(p_cov, 1e-5)
        return fw.wbn_transform(x, p_mean, l, gamma, beta), l

    def frozen_dx(l_of):
        return (fw.wbn_dx(x, g, None, gamma, p_mean, l_of, None, None, None,
                          frozen=True),)

    def frozen_pair(mean_of, l_of):
        return fw.wbn_bwd_sums(x, g, gamma, mean_of, l_of,
                               frozen=True) + frozen_dx(l_of)

    def frozen_with_dx(mean_of, l_of):
        if "with_dx" in inspect.signature(fw.wbn_bwd_sums).parameters:
            return fw.wbn_bwd_sums(x, g, gamma, mean_of, l_of, frozen=True,
                                   with_dx=True)
        return frozen_pair(mean_of, l_of)

    line["m_sha256"] = {
        "dx": digest((fw.wbn_dx(x, g, mask, gamma, p_mean, p_l, p_mmat, p_sw,
                                p_cnt),)),
        "frozen dx": digest(frozen_dx(p_l)),
        "frozen L with dx": digests(frozen_with_dx(p_mean, p_l))}

    mean, cov, l, cnt = fw.wbn_stats(x, mask, 1e-5)
    calls = {
        "wbn_transform": transform, "wbn_eval_route": eval_route,
        "wbn_stats": lambda: fw.wbn_stats(x, mask, 1e-5),
        "wbn_bwd_sums": lambda: fw.wbn_bwd_sums(x, g, gamma, mean, l),
        "wbn_bwd_sums_frozen": lambda: fw.wbn_bwd_sums(x, g, gamma, mean, l,
                                                       frozen=True),
        "wbn_dx_frozen": lambda: frozen_dx(l),
        "wbn_bwd_sums_frozen_dx": lambda: frozen_with_dx(mean, l),
        "wbn_frozen_pair": lambda: frozen_pair(mean, l)}
    for name, fn in calls.items():
        first, again = fn(), fn()
        torch.cuda.synchronize()
        line[f"{name}_bit_equal_on_relaunch"] = all(
            torch.equal(a, b) for a, b in zip(first, again))
        line[f"{name}_sha256"] = digests(first)
        line[f"{name}_graph_us"] = time_graph(torch, fn) * 1e3
        line[f"{name}_eager_us"] = time_eager(torch, fn) * 1e3
        line[f"{name}_host_us"] = host_us(torch, fn)
        line[f"{name}_cuda_kernels"] = kernels_of(torch, fn)
    if args.quat:
        line.update(quat(torch, dev, fw))
    from phc_gnn_torch.ops import _build
    line["ptxas"] = ptxas_report(_build)
    print(json.dumps(line), flush=True)
    if not all(line[f"{k}_bit_equal_on_relaunch"] for k in calls):
        sys.exit("time_fused_whitening: a second launch differs")


if __name__ == "__main__":
    main()
