#!/usr/bin/env python3
"""Count the CUDA kernels of the flagship's eager eval and of its exported
forward with torch.profiler, on one NVIDIA GPU, to see how often a profile
loses events.

    python3 tools/profile_export_kernels.py [--reps 40]

The model and batch are ``chip_smoke.py``'s export phase's: the flagship at
width 200 with random eval state on ``synthetic_batch(128, 4096, 8192,
seed=0)`` with its CSR plan, exported with ``export.export_forward``.  Each
of ``--reps`` rounds profiles 10 calls of each (``chip_smoke.device_profile``).
Prints one JSON line: per call, the kernels a call and the device-to-device
copies a call of every profile, and the ops that reach the dispatcher in
one call of each where they differ (``chip_smoke.ops_a_call``, which loses
nothing).  Both calls launch the same kernels, so a profile that reads
fewer kernels than the others has lost events.  Exits non-zero without a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
COPY = "Memcpy DtoD (Device -> Device)"


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--reps", type=int, default=40)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script profiles the port on a GPU")
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from phc_gnn_torch import export
    from phc_gnn_torch.data import synthetic_batch
    from phc_gnn_torch.graph import attach_csr_plan
    from phc_gnn_torch.models import PHCGNN
    from phc_gnn_torch.ops import _build
    from phc_gnn_torch.train import make_eval_step

    _build.load_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    batch = attach_csr_plan(synthetic_batch(seed=0, **cs.FLAGSHIP)).to(dev)
    model = PHCGNN(**cs.flagship_config(), seed=0, device=dev)
    cs.randomize_eval_state(torch, model)
    module = export.export_forward(model, batch).module()
    inputs = export.forward_args(batch)
    eager = make_eval_step(model, device=dev)

    def exported():
        with torch.inference_mode():
            return module(*inputs)

    fns = {"eager": lambda: eager(batch), "exported": exported}
    for fn in fns.values():
        for _ in range(20):
            fn()
    torch.cuda.synchronize()

    ops = {how: cs.ops_a_call(torch, fn) for how, fn in fns.items()}
    reads = {how: {"kernels": [], "copies": []} for how in fns}
    for _ in range(args.reps):
        for how, fn in fns.items():
            prof = cs.device_profile(torch, fn, 1.0, iters=10)
            reads[how]["kernels"].append(prof["kernels_per_call"])
            reads[how]["copies"].append(prof["counts"].get(COPY, 0) / 10)
    print(json.dumps({
        "ops_beyond_eager": dict(ops["exported"] - ops["eager"]),
        "ops_below_eager": dict(ops["eager"] - ops["exported"]),
        "profiles": reads}))


if __name__ == "__main__":
    main()
