"""The numbers that decide ``correct``, and the decision.

Training (the first steps, program against reference):

- ``pred_gap_mean_deg``: the mean angle between the program's and the
  reference's answers of the first step (view 0's gaze of the last
  iteration, every row), in degrees.
- ``loss_gap``: the largest relative gap of a step's loss.
- ``grad_gap``: over the leaves, the largest gap between the program's and
  the reference's norm of the first gradient (the program's read from its
  optimizer's first moment after one step), over the larger of the
  reference's norm of that leaf and of the median leaf;
  ``grad_gap_median`` the median leaf's.
- ``change_gap``: the same of each leaf's change over the steps, over the
  leaves whose first reference gradient is at least a thousandth of the
  median leaf's (the others move under Adam by round-off alone).

Serving: the angle between each reply and the reference's answer for the
same frame; ``answer_gap_deg`` the widest, ``answer_gap_p99_deg`` the 99th
percentile, ``answer_gap_mean_deg`` the mean, and ``answers_over_1deg``
the count of replies more than 1 degree off (one misrouted or altered
reply among thousands).

A cell's check (``perfbench/checks/<cell>.json``) names the numbers it
compares; the others are printed beside them as readings.

A run is correct when every number is within its limit
(``perfbench/checks/<cell>.json``) and no request or step failed.
"""

from __future__ import annotations

import math
import statistics
from typing import Any, Dict, Tuple

import numpy as np

from perfbench.reference.ops import angle_deg

MOVED = 1e-3  # a leaf moves for the change gap from this share of the median gradient


def _leaf_gaps(program: Dict[str, float], reference: Dict[str, float], leaves) -> list:
    floor = statistics.median(reference[n] for n in leaves)
    return [abs(program.get(n, 0.0) - reference[n]) / max(reference[n], floor) for n in leaves]


def train_numbers(program: Dict[str, Any], reference: Dict[str, Any]) -> Dict[str, float]:
    """The numbers of the module docstring."""
    losses = [abs(p - r) / abs(r) for p, r in zip(program["loss"], reference["loss"])]
    g_ref = reference["grad_norm"]
    median = statistics.median(g_ref.values())
    moved = [n for n, v in g_ref.items() if v >= MOVED * median]
    grad = _leaf_gaps(program["grad_norm"], g_ref, list(g_ref))
    change = _leaf_gaps(program["change_norm"], reference["change_norm"], moved)
    p, r = program["pred_first"], reference["pred_first"]
    answers = angle_deg(p, r) if p.shape == r.shape else np.array([math.inf])
    return {
        "loss_gap": max(losses), "pred_gap_mean_deg": float(answers.mean()),
        "grad_gap": max(grad), "grad_gap_median": statistics.median(grad), "change_gap": max(change),
    }


def judge(numbers: Dict[str, float], limits: Dict[str, Any], failed: int) -> Tuple[bool, Dict[str, Any]]:
    """``(correct, {name: {"value", "limit"}})``: every number of the
    cell's check present, finite and within its limit, and nothing failed.
    A limit not yet set (null) fails."""
    checks, ok = {}, failed == 0
    for name, spec in limits.items():
        value, limit = numbers.get(name), spec["limit"]
        checks[name] = {"value": value, "limit": limit}
        ok = ok and value is not None and limit is not None and math.isfinite(value) and value <= limit
    return ok, checks
