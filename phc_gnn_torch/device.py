"""Device resolution for the port's entry points.

Entry points take ``device=`` and default to ``"cuda"``.  Without a CUDA
device they raise unless the caller asked for the CPU: the port never carries
on on the CPU silently.
"""

from __future__ import annotations

from typing import Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "phc_gnn_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run the plain PyTorch path on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev
