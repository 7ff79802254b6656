"""Two-view and per-iteration loss composition over the model's output dict
(port of ``rot_mvgaze_tpu/losses/stereo.py``).

For the shipped configuration (``iter_decay=0.5``, 3 iterations,
``rel_weight=0.01``, ``reference_decay=1.0``) the total is
``0.01 * (0.25*L(iter_0) + 0.5*L(iter_1) + 1.0*L(iter_2))`` with
``L = angular(g0, gt0) + angular(g1, gt1)``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch

from rot_mvgaze_tpu_torch.losses.gaze import make_gaze_loss


@dataclass(frozen=True)
class StereoL1Loss:
    """``(L(g0, gt0) + reference_decay * L(g1, gt1)) * rel_weight``. Despite
    the name the distance is angular, the only metric the reference wires."""

    rel_weight: float = 1.0
    reference_decay: float = 1.0
    distance_metric: str = "angular_error"
    pred_gaze_key: str = "pred_gaze"

    def __post_init__(self) -> None:
        if self.distance_metric != "angular_error":
            raise ValueError(
                f"StereoL1Loss only implements distance_metric='angular_error'; "
                f"got {self.distance_metric!r}. Use losses.make_gaze_loss for "
                f"other metrics."
            )

    def __call__(self, data: Dict[str, Any]) -> torch.Tensor:
        loss_fn = make_gaze_loss("angular")
        loss = loss_fn(data[f"{self.pred_gaze_key}_0"], data["gt_gaze"])
        loss_aux = loss_fn(data[f"{self.pred_gaze_key}_1"], data["gt_gaze_1"])
        return (loss + loss_aux * self.reference_decay) * self.rel_weight


@dataclass(frozen=True)
class IterationLoss:
    """``total = total * iter_decay + loss(iter_i ∪ common)`` over the
    ``iter_{i}`` keys in numeric order, plus the optional
    ``additional_decay`` term for the last iteration. ``loss`` is a
    :class:`StereoL1Loss` or a ``MultiViewL1Loss``."""

    loss: Callable[[Dict[str, Any]], torch.Tensor]
    iter_decay: float = 1.0
    additional_decay: Optional[float] = None

    def __call__(self, data: Dict[str, Any]) -> torch.Tensor:
        iter_keys = sorted(
            (k for k in data if k.startswith("iter_")),
            key=lambda k: int(k.split("_")[1]),
        )
        common = {k: v for k, v in data.items() if not k.startswith("iter_")}
        num_iter = len(iter_keys)
        if self.additional_decay is not None:
            num_iter -= 1
        total = None
        for k in iter_keys[:num_iter]:
            term = self.loss({**common, **data[k]})
            total = term if total is None else total * self.iter_decay + term
        if self.additional_decay is not None:
            last = self.loss({**common, **data[iter_keys[num_iter]]})
            total = last * self.additional_decay if total is None else (
                total + last * self.additional_decay
            )
        if total is None:
            raise ValueError("IterationLoss needs at least one iter_{i} entry")
        return total
