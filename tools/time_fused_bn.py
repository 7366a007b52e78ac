#!/usr/bin/env python3
"""Time the masked batch-norm pair D and E (``bn_forward``, ``bn_backward``)
on one NVIDIA GPU at the shapes where the train steps launch them.

    python3 tools/time_fused_bn.py [--root DIR] [--label NAME]

``--root`` names the checkout whose ``phc_gnn_torch`` is timed (default:
this one), so that two versions of the kernels can be timed in turns on one
card, one process each.  The timers are ``chip_smoke.py``'s: device us per
call from one CUDA graph of 100 calls (median of 5 replays) and us per
eager call.  Inputs are made from seed 6; the mask keeps ~75 % of the rows
(a padded batch's).  Prints the card's name and power limit, then one JSON
line per shape.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
SHAPES = ((4096, 200), (129, 768), (129, 256), (129, 200), (129, 128),
          (129, 100), (129, 64))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(REPO))
    ap.add_argument("--label", default="this checkout")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    sys.path.insert(1, str(REPO))
    import torch

    if not torch.cuda.is_available():
        print("time_fused_bn: no CUDA device", file=sys.stderr)
        sys.exit(1)
    from chip_smoke import time_eager, time_graph
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
    for n, d in SHAPES:
        x = (torch.randn((n, d), generator=gen) * 2 + 3).to(dev)
        g = torch.randn((n, d), generator=gen).to(dev)
        scale = torch.randn(d, generator=gen).to(dev)
        bias = torch.randn(d, generator=gen).to(dev)
        mask = (torch.rand(n, generator=gen) > 0.25).to(dev)
        _, mean, var = fused_bn.bn_forward(x, mask, scale, bias, 1e-5)

        def fwd():
            return fused_bn.bn_forward(x, mask, scale, bias, 1e-5)

        def bwd():
            return fused_bn.bn_backward(x, mask, scale, mean, var, 1e-5, g)

        print(json.dumps({
            "label": args.label, "shape": [n, d],
            "bn_forward_graph_us": time_graph(torch, fwd) * 1e3,
            "bn_backward_graph_us": time_graph(torch, bwd) * 1e3,
            "bn_forward_eager_us": time_eager(torch, fwd) * 1e3,
            "bn_backward_eager_us": time_eager(torch, bwd) * 1e3}),
            flush=True)


if __name__ == "__main__":
    main()
