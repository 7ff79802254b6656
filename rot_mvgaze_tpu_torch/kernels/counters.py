"""Arrival counters shared by the kernels that finish a reduction in the
last block to arrive at a tile: the BatchNorm reductions
(``ops/batchnorm.py``), the conv + statistics kernel (``ops/conv_bn.py``)
and the generic fuser's split-K (``ops/fusion.py``)."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

_counters: Dict[Tuple[int, int], torch.Tensor] = {}


def tile_counters(device: torch.device, tiles: int) -> torch.Tensor:
    """Per-tile arrival counters, one zeroed int32 buffer per (device,
    stream). The last block of a tile resets its counter, so the buffer
    stays zero between launches and needs no fill per call; launches on one
    stream run in order, so they can share it."""
    stream = torch.cuda.current_stream(device)
    key = (device.index, stream.cuda_stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < tiles:
        buf = torch.zeros(max(tiles, 1024), dtype=torch.int32, device=device)
        _counters[key] = buf
    return buf
