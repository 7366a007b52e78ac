"""Checkpoints and the best-validation export: the counterpart of
phc_gnn_tpu/train/checkpoint.py:21-64, with ``torch.save`` and
``torch.load`` where JAX uses orbax.

A checkpoint is one file a step, ``<dir>/step_<n>.pt``, written atomically
(a temporary file, then ``os.replace``), the last ``max_to_keep`` kept.  The
best-validation export is ``<dir>/best.pt``.  What a checkpoint holds is
the caller's: the Trainer saves the model's ``state_dict``, Adam's count,
moments and lr, the dropout generator's state and the epoch; the export
holds the parameters and running stats alone.  Tensors are saved as CPU
copies; a restore copies them into the caller's tensors, never replacing
them (a captured CUDA graph reads the old addresses).
"""

from __future__ import annotations

import os
import re
from typing import Any, List, Optional

import torch

__all__ = ["CheckpointManager"]

_STEP = re.compile(r"^step_(\d+)\.pt$")


def _atomic_save(obj: Any, path: str) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


class CheckpointManager:
    """save(step, state), restore the latest, export and restore the best."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self._dir = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self._dir, exist_ok=True)

    def _steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_STEP.match,
                                                   os.listdir(self._dir)) if m)

    def _path(self, step: int) -> str:
        return os.path.join(self._dir, f"step_{step}.pt")

    def save(self, step: int, state: Any) -> None:
        """Write ``state`` (nested dicts of tensors and numbers) as step
        ``step``, then drop all but the newest ``max_to_keep`` steps."""
        _atomic_save(state, self._path(step))
        for old in self._steps()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None) -> Any:
        """The state saved at ``step`` (default: the latest), on the CPU."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self._dir}")
        return torch.load(self._path(step), map_location="cpu",
                          weights_only=True)

    def export_best(self, state: Any, name: str = "best") -> None:
        """Stand-alone export of the best-validation state (the reference's
        model.pt analogue)."""
        _atomic_save(state, os.path.join(self._dir, f"{name}.pt"))

    def has_best(self, name: str = "best") -> bool:
        return os.path.exists(os.path.join(self._dir, f"{name}.pt"))

    def restore_best(self, name: str = "best") -> Any:
        return torch.load(os.path.join(self._dir, f"{name}.pt"),
                          map_location="cpu", weights_only=True)
