"""Streaming scalar statistics (port of ``rot_mvgaze_tpu/utils/helper.py``:
the reference's running-average meter, with min and max, and an incremental
mean that stays accurate over long runs)."""

from __future__ import annotations

import math
from dataclasses import dataclass, field


@dataclass
class StreamingStats:
    """Mean, last, min and max of a scalar stream. The mean is updated as
    ``avg += n * (val - avg) / count`` rather than kept as a running sum."""

    val: float = 0.0
    avg: float = 0.0
    count: int = 0
    min: float = field(default=math.inf)
    max: float = field(default=-math.inf)

    def reset(self) -> None:
        self.val, self.avg, self.count = 0.0, 0.0, 0
        self.min, self.max = math.inf, -math.inf

    def update(self, val: float, n: int = 1) -> None:
        val = float(val)
        self.val = val
        self.count += n
        self.avg += n * (val - self.avg) / self.count
        self.min = min(self.min, val)
        self.max = max(self.max, val)

    @property
    def sum(self) -> float:
        return self.avg * self.count


# the reference's name
AverageMeter = StreamingStats
