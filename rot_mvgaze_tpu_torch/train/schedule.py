"""Cyclic learning-rate schedule (port of ``rot_mvgaze_tpu/train/schedule.py``).

The reference's ``CyclicLR(base_lr=1e-6, max_lr=1e-3, step_size_up,
step_size_down, mode='triangular2')``: a triangle wave between base and max
whose amplitude halves every cycle. The reference steps it once per epoch,
not once per update; ``steps_per_epoch=N`` reproduces that by mapping the
update count to ``count // N`` (``steps_per_epoch=1`` steps per update).
"""

from __future__ import annotations

import math
from typing import Callable


def cyclic_triangular2(
    base_lr: float = 1e-6,
    max_lr: float = 1e-3,
    step_size_up: int = 1,
    step_size_down: int = 1,
    steps_per_epoch: int = 1,
) -> Callable[[int], float]:
    """Return ``count -> lr``, ``count`` being the number of updates already
    made (optax's count)."""
    total = step_size_up + step_size_down

    def schedule(count: int) -> float:
        t = int(count) // steps_per_epoch
        cycle = math.floor(t / total)
        x = t - cycle * total
        up = min(x / step_size_up, 1.0)
        down = max((x - step_size_up) / step_size_down, 0.0)
        return base_lr + (max_lr - base_lr) * (0.5**cycle) * (up - down)

    return schedule
