"""Device selection shared by the port's entry points."""

from __future__ import annotations

from typing import Any

import torch


def resolve_device(device: Any) -> torch.device:
    """``torch.device`` for ``device``; a CUDA device with no card raises
    instead of carrying on on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return device
