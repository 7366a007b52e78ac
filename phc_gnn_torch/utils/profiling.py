"""Throughput metering and profiler traces (counterpart of
phc_gnn_tpu/utils/profiling.py: ``StepMeter`` is a copy; ``trace_context``
records with ``torch.profiler`` where JAX's records with ``jax.profiler``).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch

__all__ = ["StepMeter", "trace_context"]


class StepMeter:
    """Rolling steps/s and edges/s meter for the training loop."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times: list[float] = []
        self._edges: list[int] = []

    def tick(self, edges_in_batch: int = 0):
        self._times.append(time.perf_counter())
        self._edges.append(edges_in_batch)
        if len(self._times) > self.window + 1:
            self._times.pop(0)
            self._edges.pop(0)

    @property
    def steps_per_s(self) -> float:
        if len(self._times) < 2:
            return 0.0
        dt = self._times[-1] - self._times[0]
        return (len(self._times) - 1) / max(dt, 1e-9)

    @property
    def edges_per_s(self) -> float:
        if len(self._times) < 2:
            return 0.0
        dt = self._times[-1] - self._times[0]
        return sum(self._edges[1:]) / max(dt, 1e-9)


@contextlib.contextmanager
def trace_context(logdir: Optional[str]):
    """``torch.profiler`` trace of the block (host, and the card's kernels
    where CUDA is available), written as a Chrome trace to
    ``logdir/trace.json`` when the block ends; does nothing when ``logdir``
    is None."""
    if logdir is None:
        yield
        return
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
