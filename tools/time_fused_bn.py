#!/usr/bin/env python3
"""Time the masked batch norms on one NVIDIA GPU at the shapes where the
train steps launch them: the cluster pair D and E (``bn_forward``,
``bn_backward``) and the row-blocked route past the size gate, F and G.

    python3 tools/time_fused_bn.py [--root DIR] [--label NAME] [--pcba]

``--root`` names the checkout whose ``phc_gnn_torch`` is timed (default:
this one), so that two versions of the kernels can be timed in turns on one
card, one process each.  The row-blocked route is whatever that checkout
has: ``bn_forward_blocked`` and ``bn_backward_blocked`` (one launch each,
on ``bn_plan``, whose plans the line carries), or the older three launches
a direction (``bn_stats_blocked`` and ``bn_normalize``;
``bn_bwd_sums_blocked`` and ``bn_dx``).

With ``--pcba``, it also times and profiles the pcba accumulated train step
(``chip_smoke.py``'s pcba configuration and batches, dropout on, K = 4), where
the blocked pair runs 28 times each way: ms per step, kernels per step, the
device's busy time and its idle share.

The timers are ``chip_smoke.py``'s: device us per call from one CUDA graph
of 100 calls (median of 5 replays) and us per eager call.  Inputs are made
from seed 6; the mask keeps ~75 % of the rows (a padded batch's), and at
[4096, 512] it is the pcba batch's node mask
(``synthetic_batch(128, 4096, 8192, seed=0)``).  Each line carries a SHA-256
of D's and E's outputs, so that two checkouts can be shown bit-equal.
Prints the card's name and power limit, then one JSON line per shape.
Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
SHAPES = ((4096, 200), (129, 768), (129, 256), (129, 200), (129, 128),
          (129, 100), (129, 64))
# pcba's conv outputs, and a shape whose CTAs walk their rows in chunks
# (x 67 MB, past the 50 MB L2)
BLOCKED_SHAPES = ((4096, 512), (32768, 512))


def digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def blocked_route(fused_bn):
    """(forward, backward, launches) of the checkout's row-blocked route."""
    if hasattr(fused_bn, "bn_forward_blocked"):
        return (fused_bn.bn_forward_blocked, fused_bn.bn_backward_blocked,
                "one launch a direction")

    saved = {}  # the forward's count, which the backward takes

    def fwd(x, mask, scale, bias, eps):
        mean, var, saved["cnt"] = fused_bn.bn_stats_blocked(x, mask)
        return fused_bn.bn_normalize(x, mean, var, scale, bias, eps), mean, var

    def bwd(x, mask, scale, mean, var, eps, g):
        sg, sgx = fused_bn.bn_bwd_sums_blocked(x, g, mean, var, eps)
        return (fused_bn.bn_dx(x, mask, g, scale, mean, var, eps, sg, sgx,
                               saved["cnt"]), sgx, sg)

    return fwd, bwd, "three launches a direction"


def pcba_step(torch, dev) -> dict:
    """The pcba accumulated train step of the checkout's ``chip_smoke.py``,
    eager, timed and profiled as its pcba phase does (the step's eager body,
    ``train.state._eager_accum_train_step``, where the checkout has it:
    there ``make_accum_train_step`` replays a CUDA graph)."""
    import chip_smoke as cs
    from phc_gnn_torch.train import make_optimizer, state

    make = getattr(state, "_eager_accum_train_step",
                   state.make_accum_train_step)

    batches = [cs.pcba_batch(torch, s, cs.PCBA).to(dev)
               for s in range(cs.PCBA_K)]
    model, loss_fn, cfg = cs.pcba_model(torch, dev)
    opt = make_optimizer(dict(model.named_parameters()),
                         grad_clip=cfg.grad_clipping)
    step = make(model, opt, loss_fn, weight_decay=cfg.weightdecay,
                loss_name=cfg.loss, seed=0, device=dev)
    step_ms, host_ms = cs.time_steps(torch, lambda: step(batches, cfg.lr))
    prof = cs.device_profile(torch, lambda: step(batches, cfg.lr), step_ms)
    return {"pcba_step_ms": step_ms, "pcba_step_host_ms": host_ms,
            "pcba_kernels_per_step": prof["kernels_per_call"],
            "pcba_device_busy_ms": prof["busy_ms"],
            "pcba_device_idle_share": prof["idle_share"]}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(REPO))
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--pcba", action="store_true",
                    help="also time and profile the pcba accumulated step")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    sys.path.insert(1, str(REPO))
    import torch

    if not torch.cuda.is_available():
        print("time_fused_bn: no CUDA device", file=sys.stderr)
        sys.exit(1)
    from chip_smoke import time_eager, time_graph
    from phc_gnn_torch.data import synthetic_batch
    from phc_gnn_torch.ops import fused_bn

    if not Path(fused_bn.__file__).resolve().is_relative_to(
            Path(args.root).resolve()):
        sys.exit(f"time_fused_bn: imported {fused_bn.__file__}, not from "
                 f"{args.root}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(6)

    def inputs(n, d):
        x = (torch.randn((n, d), generator=gen) * 2 + 3).to(dev)
        g = torch.randn((n, d), generator=gen).to(dev)
        scale = torch.randn(d, generator=gen).to(dev)
        bias = torch.randn(d, generator=gen).to(dev)
        mask = (torch.rand(n, generator=gen) > 0.25).to(dev)
        return x, g, scale, bias, mask

    def timed(prefix, fwd, bwd, x, g, scale, bias, mask):
        _, mean, var = fwd(x, mask, scale, bias, 1e-5)

        def f():
            return fwd(x, mask, scale, bias, 1e-5)

        def b():
            return bwd(x, mask, scale, mean, var, 1e-5, g)

        return {f"{prefix}_forward_graph_us": time_graph(torch, f) * 1e3,
                f"{prefix}_backward_graph_us": time_graph(torch, b) * 1e3,
                f"{prefix}_forward_eager_us": time_eager(torch, f) * 1e3,
                f"{prefix}_backward_eager_us": time_eager(torch, b) * 1e3}

    for n, d in SHAPES:
        x, g, scale, bias, mask = inputs(n, d)
        y, mean, var = fused_bn.bn_forward(x, mask, scale, bias, 1e-5)
        outs = (y, mean, var) + fused_bn.bn_backward(x, mask, scale, mean, var,
                                                     1e-5, g)
        print(json.dumps({
            "label": args.label, "shape": [n, d], "outputs_sha256": digest(outs),
            **timed("bn", fused_bn.bn_forward, fused_bn.bn_backward, x, g,
                    scale, bias, mask)}), flush=True)

    fwd, bwd, how = blocked_route(fused_bn)
    for n, d in BLOCKED_SHAPES:
        x, g, scale, bias, mask = inputs(n, d)
        if n == 4096:
            mask = synthetic_batch(128, 4096, 8192, seed=0).node_mask.to(dev)
        line = {"label": args.label, "shape": [n, d], "blocked_route": how,
                **timed("blocked", fwd, bwd, x, g, scale, bias, mask)}
        if how == "one launch a direction":
            line["plans"] = [fused_bn.bn_plan(n, d, t)._asdict()
                             for t in (1, 2)]
        print(json.dumps(line), flush=True)
    if args.pcba:
        torch.backends.cuda.matmul.allow_tf32 = False  # as chip_smoke.py
        torch.backends.cudnn.allow_tf32 = False
        print(json.dumps({"label": args.label, **pcba_step(torch, dev)}),
              flush=True)


if __name__ == "__main__":
    main()
