"""Serving entry point: the eval step.

Counterpart of ``make_eval_step`` in phc_gnn_tpu/train/state.py:107-113.  The
port's model owns its parameters and running stats, so the step takes the
batch alone.
"""

from __future__ import annotations

from typing import Callable, Union

import torch
from torch import nn

from phc_gnn_torch.device import resolve_device
from phc_gnn_torch.graph.batch import GraphsTuple

__all__ = ["make_eval_step"]


def make_eval_step(model: nn.Module, device: Union[str, torch.device] = "cuda"
                   ) -> Callable[[GraphsTuple], torch.Tensor]:
    """Move ``model`` to ``device`` (default "cuda"; without CUDA this raises
    unless ``device="cpu"``) in eval mode and return ``step(batch)``, which
    moves the batch there and runs the forward under
    ``torch.inference_mode()``.  The result stays on the device: the caller
    decides when to synchronise."""
    dev = resolve_device(device)
    model.to(dev).eval()

    def step(batch: GraphsTuple) -> torch.Tensor:
        batch = batch.to(dev, non_blocking=True)
        with torch.inference_mode():
            return model(batch, training=False)

    return step
