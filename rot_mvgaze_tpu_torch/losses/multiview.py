"""V-view supervised loss (port of ``rot_mvgaze_tpu/losses/multiview.py``).

``(L(g_0, gt_0) + reference_decay * sum_{v>=1} L(g_v, gt_v)) * rel_weight``
over the stacked ``pred_gazes`` / ``gt_gazes`` (B, V, 2) of
``models.multiview.FeatRotationMultiView``, angular only. View 0 is the
eval view; at V=2 this is ``StereoL1Loss``. It composes with
``IterationLoss`` as the stereo loss does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch

from rot_mvgaze_tpu_torch.losses.gaze import make_gaze_loss


@dataclass(frozen=True)
class MultiViewL1Loss:
    """See the module docstring."""

    rel_weight: float = 1.0
    reference_decay: float = 1.0

    def __call__(self, data: Dict[str, Any]) -> torch.Tensor:
        loss_fn = make_gaze_loss("angular")
        preds, gts = data["pred_gazes"], data["gt_gazes"]
        if preds.shape != gts.shape or preds.ndim != 3:
            raise ValueError(
                f"pred_gazes/gt_gazes must both be (B, V, 2); got {tuple(preds.shape)} vs "
                f"{tuple(gts.shape)}"
            )
        total = loss_fn(preds[:, 0], gts[:, 0])
        for v in range(1, preds.shape[1]):
            total = total + loss_fn(preds[:, v], gts[:, v]) * self.reference_decay
        return total * self.rel_weight
