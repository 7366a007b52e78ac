"""Evaluate a trained run's best-validation weights on the test split (the
counterpart of benchmarks/inference.py; reference: benchmarks/
inference.ipynb).

    python -m phc_gnn_torch.cli.inference zinc --save_dir experiments/zinc \\
        --run 1 --data_root <dir> [the run's model flags]

Prints one JSON line, ``{"dataset", "run", "loss", <metric>}``, as JAX's
does.  The test batches are packed in the run's eval bucket and evaluated
by the Trainer's eval path, so the metric reproduces the run's
``test_bestval`` (bit for bit under torch's deterministic algorithms).
"""

from __future__ import annotations

import json
import os
import sys

from phc_gnn_torch.cli.common import (config_from_args, get_parser, prepare,
                                     use_csr_plan)
from phc_gnn_torch.data import PaddedLoader
from phc_gnn_torch.train.checkpoint import CheckpointManager
from phc_gnn_torch.train.trainer import Trainer, build_model

__all__ = ["main"]


def main(argv=None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    dataset = argv[0]
    parser = get_parser(dataset)
    parser.add_argument("--run", type=int, default=1)
    args = parser.parse_args(argv[1:])
    cfg = config_from_args(dataset, args)
    d = prepare(dataset, args, cfg)

    def batches():
        return PaddedLoader(d["splits"]["test"], d["eval_bucket"],
                            transform=d["transform"],
                            csr_plan=use_csr_plan(cfg))

    model = build_model(cfg, d["atom_dims"], d["bond_dims"],
                        avg_deg=d["avg_deg"], seed=cfg.seed, device="cpu")
    trainer = Trainer(cfg, model, lambda seed: batches(), batches, batches,
                      device=args.device)
    run_dir = os.path.join(cfg.save_dir, f"run_{args.run}")
    ckpt = CheckpointManager(os.path.join(run_dir, "ckpt"))
    trainer.model.load_state_dict(ckpt.restore_best())
    result = {"dataset": dataset, "run": args.run,
              **trainer.evaluate(batches())}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
