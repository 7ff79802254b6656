"""Step timing (port of ``StepTimer`` in ``rot_mvgaze_tpu/utils/profiling.py``).

PyTorch returns before the card has finished, so a step's time is read on
the host clock after a synchronize of the device its result lives on."""

from __future__ import annotations

import time
import warnings
from typing import Any, Optional

import torch

from rot_mvgaze_tpu_torch.utils.helper import AverageMeter


def _first_tensor(result: Any) -> Optional[torch.Tensor]:
    if isinstance(result, torch.Tensor):
        return result
    if isinstance(result, dict):
        result = list(result.values())
    if isinstance(result, (list, tuple)):
        for v in result:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


class StepTimer:
    """Host time of steps, fenced on the device, and images per second."""

    def __init__(self, items_per_step: int = 0) -> None:
        self.items_per_step = items_per_step
        self.meter = AverageMeter()
        self._t0: Optional[float] = None
        self._warned_no_fence = False

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, result: Any = None) -> float:
        """Seconds since :meth:`start`, after the device of the first tensor
        in ``result`` (a tensor, or a dict, list or tuple holding one) has
        finished its work. Without a tensor to fence on, the time is the
        host's enqueue time, and a warning says so once."""
        t = _first_tensor(result)
        if t is not None:
            if t.is_cuda:
                torch.cuda.synchronize(t.device)
        elif not self._warned_no_fence:
            warnings.warn(
                "StepTimer.stop() has no tensor to fence on: the time excludes "
                "work the device has not finished. Pass the step's output.",
                stacklevel=2,
            )
            self._warned_no_fence = True
        if self._t0 is None:
            raise RuntimeError("StepTimer.stop() without start()")
        dt = time.perf_counter() - self._t0
        self._t0 = None
        self.meter.update(dt)
        return dt

    @property
    def avg_step_seconds(self) -> float:
        return self.meter.avg

    @property
    def items_per_second(self) -> float:
        return self.items_per_step / self.meter.avg if self.meter.avg else 0.0
