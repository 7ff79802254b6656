"""The harness's own record of a run: spans around its calls into the
system, and, in a traced run, the profiler's device activity.

Spans are kept in memory as (name, start, end) on the host clock and
summarised when the run ends. A traced run wraps the measured window in
``torch.profiler`` (host operations and the card's kernels, copies and
fills) with the card synchronised at both edges; each span is also a
``record_function`` range in the trace, so an idle gap on the device can
be named by what the host was doing in it. The profiler may drop a few
kernel records per window (seen on this card before); the readers take
what is there.
"""

from __future__ import annotations

import bisect
import contextlib
import threading
import time
from collections import defaultdict
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_ACTIVITIES = ("cpu_op", "user_annotation")
TOP = 10  # entries in each list of the breakdown
SHORT_GAP_NS = 20_000  # gaps shorter than this are launch latency, summed unnamed
SHORT_GAP = "gaps under 20 us (launch latency)"
LOOK_BACK = 4000  # host ranges searched for the one open at a gap


def activity(e: Any) -> str:
    """The kineto activity of a profiler event: ``activity_type()`` where
    PyTorch has it (2.13), else told from the device, the user-annotation
    flag and the name, as PyTorch 2.11 binds the event."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    if e.device_type() == torch.autograd.DeviceType.CPU:
        return "user_annotation" if e.is_user_annotation() else "cpu_op"
    if e.is_user_annotation():
        return "gpu_user_annotation"
    name = e.name()
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


class Spans:
    """Named host-clock intervals, recorded from any thread. The profiler
    records host operations of the thread that started it alone, so the
    spans of other threads (the serving dispatcher, the clients) are handed
    to the trace's reading as host ranges of their own (:meth:`ranges_ns`,
    on the profiler's wall clock)."""

    def __init__(self, annotate: bool = False) -> None:
        self.annotate = annotate
        self._items: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
        self._lock = threading.Lock()
        self._wall_ns = time.time_ns() - time.perf_counter_ns()

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        ctx = torch.profiler.record_function(f"perfbench.{name}") if self.annotate else contextlib.nullcontext()
        t0 = time.perf_counter()
        with ctx:
            yield
        self.add(name, t0, time.perf_counter())

    def add(self, name: str, start: float, end: float) -> None:
        with self._lock:
            self._items[name].append((start, end))

    def seconds(self, name: str) -> List[float]:
        return [e - s for s, e in self._items.get(name, [])]

    def quarters(self, name: str, start: float, end: float) -> List[Tuple[int, float]]:
        """(count, mean seconds) of the spans ending in each quarter of
        [start, end]: whether the window drifts."""
        bins: List[List[float]] = [[], [], [], []]
        for s, e in self._items.get(name, []):
            if start <= e <= end:
                bins[min(3, int(4 * (e - start) / (end - start)))].append(e - s)
        return [(len(b), sum(b) / len(b) if b else 0.0) for b in bins]

    def ranges_ns(self) -> List[Tuple[int, int, str]]:
        return [(int(s * 1e9) + self._wall_ns, int(e * 1e9) + self._wall_ns, f"perfbench.{name}")
                for name, items in self._items.items() for s, e in items]


class DeviceTrace:
    """``torch.profiler`` over the enclosed window; :meth:`summary` reads it."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.events: List[Any] = []
        self.window: Tuple[int, int] = (0, 0)

    @contextlib.contextmanager
    def window_of(self) -> Iterator[None]:
        from torch.profiler import ProfilerActivity, profile

        cuda = self.device.type == "cuda"
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        prof = profile(activities=activities)
        if cuda:
            torch.cuda.synchronize(self.device)
        prof.start()
        try:
            with torch.profiler.record_function("perfbench.window"):
                yield
                if cuda:
                    torch.cuda.synchronize(self.device)
        finally:
            prof.stop()
        self.events = list(prof.profiler.kineto_results.events())
        marks = [e for e in self.events if e.name() == "perfbench.window"]
        if marks:
            self.window = (marks[0].start_ns(), marks[0].start_ns() + marks[0].duration_ns())

    def summary(self, spans: Optional[Spans] = None) -> Dict[str, Any]:
        """``busy_s`` (the union of the device's activity inside the
        window), ``window_s``, ``kernel_seconds`` by name, and the
        ``breakdown`` of the contract: the device operations that took most
        time and the longest idle gaps by the innermost host range (a
        profiled operation or one of ``spans``) open at their midpoint."""
        lo, hi = self.window
        device = []
        host = [r for r in (spans.ranges_ns() if spans else []) if r[1] > lo and r[0] < hi]
        for e in self.events:
            kind = activity(e)
            start, end = e.start_ns(), e.start_ns() + e.duration_ns()
            if end <= lo or start >= hi:
                continue
            if kind in DEVICE_ACTIVITIES:
                device.append((max(start, lo), min(end, hi), e.name()))
            elif kind in HOST_ACTIVITIES and e.name() != "perfbench.window":
                host.append((start, end, e.name()))
        device.sort()
        by_name: Dict[str, float] = defaultdict(float)
        for s, e, name in device:
            by_name[name] += (e - s) / 1e9
        busy, gaps, cursor = 0, [], lo
        for s, e, _ in device:
            if s > cursor:
                gaps.append((cursor, s))
            if e > cursor:
                busy += e - max(s, cursor)
                cursor = e
        if hi > cursor:
            gaps.append((cursor, hi))
        idle: Dict[str, float] = defaultdict(float)
        host.sort()
        starts = [h[0] for h in host]
        for s, e in gaps:
            name = SHORT_GAP if e - s < SHORT_GAP_NS else _innermost(host, starts, (s + e) // 2)
            idle[name] += (e - s) / 1e9
        return {
            "busy_s": busy / 1e9,
            "window_s": (hi - lo) / 1e9,
            "kernel_seconds": dict(by_name),
            "breakdown": {
                "device_ops": [[n[:160], v] for n, v in sorted(by_name.items(), key=lambda x: -x[1])[:TOP]],
                "idle_gaps": [[n[:160], v] for n, v in sorted(idle.items(), key=lambda x: -x[1])[:TOP]],
            },
        }


def _innermost(host: List[Tuple[int, int, str]], starts: List[int], t: int) -> str:
    """The shortest host range open at ``t`` among the ``LOOK_BACK`` that
    started last before it (``host`` sorted by start, ``starts`` its
    starts)."""
    best: Optional[Tuple[int, str]] = None
    i = bisect.bisect_right(starts, t)
    for s, e, name in host[max(0, i - LOOK_BACK):i]:
        if e > t and (best is None or e - s < best[0]):
            best = (e - s, name)
    return best[1] if best else "host: no range open"
