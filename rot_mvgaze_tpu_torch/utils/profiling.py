"""Tracing and timing hooks (port of ``rot_mvgaze_tpu/utils/profiling.py``).

- :func:`trace`: a ``torch.profiler`` trace of the region it encloses,
  written as a Chrome trace file (Perfetto, chrome://tracing).
- :class:`StepTimer`: step times and images per second. PyTorch returns
  before the card has finished, so a step's time is read on the host clock
  after a synchronize of the device its result lives on.
- :func:`device_memory_stats`: the cards' memory in use, its peak and their
  capacity.
"""

from __future__ import annotations

import contextlib
import os
import time
import warnings
from typing import Any, Dict, Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str, device: Any = None) -> Iterator[str]:
    """Trace the enclosed region into ``<log_dir>/trace.json`` (the path is
    what the context yields): the CPU activity, plus the card's kernels
    where ``device`` is a card (``None``: where one is visible), with the
    card synchronised at both edges of the region."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available() if device is None else torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    path = os.path.join(log_dir, "trace.json")
    prof = profile(activities=activities)
    if cuda:
        torch.cuda.synchronize()
    prof.start()
    try:
        yield path
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(path)


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """``{"cuda:i": {"bytes_in_use", "peak_bytes_in_use", "bytes_limit"}}``
    for every visible card: the caching allocator's allocated bytes now and
    at their peak (``torch.cuda.memory_stats``) and the card's capacity
    (``torch.cuda.mem_get_info``). ``{}`` where no card is visible."""
    out: Dict[str, Dict[str, int]] = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        _free, total = torch.cuda.mem_get_info(i)
        out[str(torch.device("cuda", i))] = {
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(total),
        }
    return out

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
