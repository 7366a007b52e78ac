"""Where the host time of a training epoch goes, on one GPU.

    python3 tools/time_harness.py [--epochs 3] [--variant NAME ...]

Trains the synthetic recipe through the port's CLI
(``cli.common.run_benchmark("synthetic", ...)``: the flagship's convs at
width 200, 4,096 / 512 / 512 graphs, ``scan_chunk`` 16) once per variant,
in turns in one process, and prints one JSON line a variant: each epoch's
steps/s and real edges/s (``scalars.jsonl``) beside ``Trainer.epoch_log``'s
host ms (a batch's packing, its plans, its move to the card, the loop's
wait for it; a step's call), with the card's name and power limit.

Variants: ``default`` (prefetch depth 2, Python's 5 ms thread switch
interval), ``switch0.1ms`` (the interpreter's switch interval at 0.1 ms:
does the packing thread hold the GIL from the loop?), ``depth0`` (no
prefetch thread: the loop packs), ``depth8``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

VARIANTS = {"default": {}, "switch0.1ms": {"switch": 1e-4},
            "depth0": {"depth": 0}, "depth8": {"depth": 8},
            "zinc-like": {"chunk": 0}, "zinc-like-switch0.1ms":
                {"chunk": 0, "switch": 1e-4}}


def run(name: str, epochs: int) -> dict:
    from phc_gnn_torch.cli import common
    from phc_gnn_torch.train.trainer import Trainer

    v = VARIANTS[name]
    seen = []
    init, config = Trainer.__init__, common.config_from_args

    def watched(self, *args, **kwargs):
        init(self, *args, **kwargs)
        seen.append(self)

    def configured(dataset, args):
        # the CLI has no flag for it, as JAX's has none
        cfg = config(dataset, args)
        cfg.prefetch_depth = v.get("depth", cfg.prefetch_depth)
        return cfg

    switch = sys.getswitchinterval()
    Trainer.__init__, common.config_from_args = watched, configured
    try:
        if "switch" in v:
            sys.setswitchinterval(v["switch"])
        with tempfile.TemporaryDirectory() as tmp:
            common.run_benchmark("synthetic", [
                "--epochs", str(epochs), "--save_dir", tmp,
                "--scan_chunk", str(v.get("chunk", 16))])
            with open(os.path.join(tmp, "run_1", "scalars.jsonl")) as f:
                rows = [json.loads(line) for line in f]
    finally:
        Trainer.__init__, common.config_from_args = init, config
        sys.setswitchinterval(switch)
    epochs_out = []
    for row, log in zip(rows, seen[0].epoch_log):
        epochs_out.append({"epoch": row["epoch"],
                           "steps_per_s": row["steps_per_s"],
                           "edges_per_s": row["edges_per_s"],
                           **{k: log[k] for k in (
                               "seconds", "steps", "loader_ms", "plan_ms",
                               "move_ms", "wait_ms", "step_host_ms")}})
    return {"variant": name, "epochs": epochs_out}


def main() -> None:
    import logging

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--variant", action="append", choices=sorted(VARIANTS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script times the port on a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    for name in args.variant or list(VARIANTS):
        out = run(name, args.epochs)
        logging.getLogger().handlers.clear()
        print(json.dumps({**out, "card": card}), flush=True)


if __name__ == "__main__":
    main()
