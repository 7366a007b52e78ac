#!/usr/bin/env python3
"""Profile a model's train step and eval forward on one NVIDIA GPU, eager
and, where the checkout has them, as CUDA graphs.

    python3 tools/time_scan.py [--root DIR] [--label NAME] [--model pcba]
                               [--dtype bf16]

``--root`` names the checkout whose ``phc_gnn_torch`` and ``chip_smoke.py``
are run (default: this one), so that two versions can be profiled in turns
on one card, one process each: parent, change, change, parent.  The model,
weights, batch and training setup are ``chip_smoke.py``'s flagship (width
200, dropout on, ``synthetic_batch(128, 4096, 8192, seed=0)``, masked L1
with weight decay 0.1, clip 2.0, lr 1e-3), or with ``--model pcba`` its
pcba model (``pcba_model``: width 512, 7 layers, 128 tasks, dropout on),
its accumulated step over K = 4 batches of ``PCBA`` and its eval forward
on the 512-graph ``PCBA_EVAL`` batch, both eager (the accumulated step's
eager body, ``train.state._eager_accum_train_step``, where the checkout has
it: there ``make_accum_train_step`` replays a CUDA graph of it, profiled
beside as ``graph_step``).  ``--dtype bf16`` builds either model with
``compute_dtype`` bf16 (default float32).

Per checkout, one JSON line: the eager train step's ms (CUDA events, median
of 30 after 5), its CUDA kernels, device busy ms and idle share
(``torch.profiler`` over 10 steps), the device us a step of the kernels of
the encoders' lookups and their backward (names holding ``embedding``,
``sort`` or ``Radix``) and the step's top kernels; the same for the eval
forward; and, where the checkout has ``make_scan_train_steps``, the graphed
step over 8 batches and the graphed eval over 3 (ms a step from CUDA
events, kernels and busy from the profile).  For pcba, the eager
accumulated step and eval, and the graphed accumulated step where the
checkout has one.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
LOOKUP_NAMES = ("embedding", "sort", "Radix")


def profile(torch, cs, fn, call_ms: float, iters: int, per: int = 1) -> dict:
    """``chip_smoke.device_profile`` of ``fn`` with the lookups' device us
    beside it, per step of ``per`` steps a call."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    prof = cs.device_profile(torch, fn, call_ms * per, iters=iters)
    with torch.profiler.profile(activities=acts) as p:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    lookups = sum(e.time_range.elapsed_us() for e in p.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and any(k in e.name for k in LOOKUP_NAMES))
    return {"ms": call_ms, "kernels": prof["kernels_per_call"] / per,
            "busy_ms": prof["busy_ms"] / per,
            "idle_share": prof["idle_share"],
            "lookup_us": lookups / iters / per,
            "top_us": [[n, us / per] for n, us in prof["top_us"]]}


def flagship(torch, cs, train, dev, dtype: str) -> dict:
    """The flagship's eager and graphed train step and eval forward."""
    from phc_gnn_torch.data import synthetic_batch
    from phc_gnn_torch.graph import attach_csr_plan
    from phc_gnn_torch.models import PHCGNN

    batches = [attach_csr_plan(synthetic_batch(seed=s, **cs.FLAGSHIP)).to(dev)
               for s in range(8)]
    b0 = batches[0]

    def loss_fn(out, b):
        return train.masked_l1(out, b.y)

    kw = {"compute_dtype": torch.bfloat16} if dtype == "bf16" else {}

    def build():
        model = PHCGNN(**cs.flagship_config(), seed=0, device=dev, **kw)
        opt = train.make_optimizer(dict(model.named_parameters()),
                                   grad_clip=cs.GRAD_CLIP)
        return model, opt

    model, opt = build()
    step = train.make_train_step(model, opt, loss_fn,
                                 weight_decay=cs.WEIGHT_DECAY, seed=0,
                                 device=dev)
    line = {}
    ms, _ = cs.time_steps(torch, lambda: step(b0, cs.LR))
    line["eager_step"] = profile(torch, cs, lambda: step(b0, cs.LR), ms, 10)
    served = PHCGNN(**cs.flagship_config(), seed=0, device=dev, **kw)
    cs.randomize_eval_state(torch, served)
    ev = train.make_eval_step(served, device=dev)
    ms, _ = cs.time_steps(torch, lambda: ev(b0))
    line["eager_eval"] = profile(torch, cs, lambda: ev(b0), ms, 20)
    if hasattr(train, "make_scan_train_steps"):
        model, opt = build()
        steps = train.make_scan_train_steps(model, opt, loss_fn,
                                            weight_decay=cs.WEIGHT_DECAY,
                                            seed=0, device=dev)
        ms, _ = cs.time_scan(torch, lambda: steps(batches, cs.LR), 8)
        line["graph_step"] = profile(torch, cs, lambda: steps(batches, cs.LR),
                                     ms, 2, per=8)
        scan_ev = train.make_scan_eval_steps(served, device=dev)
        ms, _ = cs.time_scan(torch, lambda: scan_ev(batches[:3]), 3)
        line["graph_eval"] = profile(torch, cs, lambda: scan_ev(batches[:3]),
                                     ms, 6, per=3)
    return line


def pcba(torch, cs, train, dev, dtype: str) -> dict:
    """pcba's eager accumulated train step (K batches) and eval forward, and
    the graphed step where the checkout has one."""
    from phc_gnn_torch.train import state

    host = [cs.pcba_batch(torch, s, cs.PCBA) for s in range(cs.PCBA_K)]
    batches = [b.to(dev) for b in host]
    eager = getattr(state, "_eager_accum_train_step", None)
    kw = {"compute_dtype": dtype} if dtype == "bf16" else {}
    makers = {"eager_step": eager or train.make_accum_train_step}
    if eager is not None:
        makers["graph_step"] = train.make_accum_train_step
    line = {}
    for name, make in makers.items():
        model, loss_fn, cfg = cs.pcba_model(torch, dev, **kw)
        opt = train.make_optimizer(dict(model.named_parameters()),
                                   grad_clip=cfg.grad_clipping)
        step = make(model, opt, loss_fn, weight_decay=cfg.weightdecay,
                    loss_name=cfg.loss, seed=0, device=dev)
        ms, _ = cs.time_steps(torch, lambda: step(batches, cfg.lr))
        line[name] = profile(torch, cs, lambda: step(batches, cfg.lr), ms,
                             10)
    served, _, _ = cs.pcba_model(torch, dev, **kw)
    cs.randomize_eval_state(torch, served)
    ev = train.make_eval_step(served, device=dev)
    b = cs.pcba_batch(torch, 0, cs.PCBA_EVAL).to(dev)
    ms, _ = cs.time_steps(torch, lambda: ev(b))
    line["eager_eval"] = profile(torch, cs, lambda: ev(b), ms, 20)
    return line


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(REPO))
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--model", choices=("flagship", "pcba"),
                    default="flagship")
    ap.add_argument("--dtype", choices=("f32", "bf16"), default="f32",
                    help="the model's compute_dtype")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("time_scan: no CUDA device", file=sys.stderr)
        sys.exit(1)
    import chip_smoke as cs
    import phc_gnn_torch
    from phc_gnn_torch import train

    if not Path(phc_gnn_torch.__file__).resolve().is_relative_to(root):
        sys.exit(f"time_scan: imported {phc_gnn_torch.__file__}, not from "
                 f"{root}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False  # as chip_smoke.py
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    line = {"label": args.label, "model": args.model, "dtype": args.dtype}
    if args.model == "pcba":
        line.update(pcba(torch, cs, train, dev, args.dtype))
    else:
        line.update(flagship(torch, cs, train, dev, args.dtype))
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
