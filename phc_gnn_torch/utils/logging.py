"""Console and file logging (a copy of phc_gnn_tpu/utils/logging.py;
reference: benchmarks/utils.py:10-19)."""

from __future__ import annotations

import logging
import sys

__all__ = ["set_logging"]


def set_logging(logfile: str | None = None, level=logging.INFO):
    """Log to stdout and, with ``logfile``, to that file too, replacing the
    root logger's handlers."""
    root = logging.getLogger()
    root.setLevel(level)
    for h in list(root.handlers):
        root.removeHandler(h)
        h.close()
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    root.addHandler(sh)
    if logfile:
        fh = logging.FileHandler(logfile)
        fh.setFormatter(fmt)
        root.addHandler(fh)
