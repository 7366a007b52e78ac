"""Train the port on one of the seven datasets (the counterpart of
benchmarks/train_<dataset>.py, one entry point for all of them).

    python -m phc_gnn_torch.cli.train zinc --data_root <dir> [flags]
    python -m phc_gnn_torch.cli.train synthetic --epochs 3 --device cpu

``--help`` after the dataset lists the flags: JAX's, plus ``--device``
(default ``cuda``).
"""

from __future__ import annotations

import argparse
import sys

from phc_gnn_torch.cli.common import DATASETS, run_benchmark

__all__ = ["main"]


def main(argv=None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in DATASETS:
        argparse.ArgumentParser(
            prog="python -m phc_gnn_torch.cli.train",
            usage=f"%(prog)s {{{','.join(DATASETS)}}} [flags]").error(
            f"the first argument names the dataset: one of {list(DATASETS)}")
    return run_benchmark(argv[0], argv[1:])


if __name__ == "__main__":
    main()
