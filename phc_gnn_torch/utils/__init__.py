"""Utilities of the port: logging, seeding, profiling, oversmoothing
diagnostics (counterparts of phc_gnn_tpu/utils/)."""

from phc_gnn_torch.utils.logging import set_logging
from phc_gnn_torch.utils.oversmoothing import col_diff, row_diff
from phc_gnn_torch.utils.profiling import StepMeter, trace_context
from phc_gnn_torch.utils.seed import set_seed_all

__all__ = ["StepMeter", "col_diff", "round_up", "row_diff", "set_logging",
           "set_seed_all", "trace_context"]


def round_up(x: int, m: int) -> int:
    """Smallest multiple of m that is >= x (shared padding/alignment helper)."""
    return ((x + m - 1) // m) * m
