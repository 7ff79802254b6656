"""Synthetic inputs from the run's seed, made on the device in bulk.

The distributions are those of the system's own synthetic batches
(uniform uint8 pixels, gaze labels U(-1, 1) rad, head poses U(-0.8, 0.8)
rad), drawn here by the benchmark so that later changes to the system
cannot change them.
"""

from __future__ import annotations

from typing import Dict

import torch


def _uniform(shape, lo: float, hi: float, g: torch.Generator) -> torch.Tensor:
    return torch.rand(shape, generator=g, device=g.device) * (hi - lo) + lo


def train_batch(pairs: int, size: int, g: torch.Generator) -> Dict[str, torch.Tensor]:
    """One two-view training batch: uint8 views (B, S, S, 3), gaze labels
    and head poses (B, 2)."""
    img = torch.randint(0, 256, (2, pairs, size, size, 3), generator=g, device=g.device, dtype=torch.uint8)
    labels = _uniform((2, pairs, 2), -1.0, 1.0, g)
    poses = _uniform((2, pairs, 2), -0.8, 0.8, g)
    return {"img_0": img[0], "img_1": img[1], "gt_gaze": labels[0], "gt_gaze_1": labels[1],
            "head_pose_0": poses[0], "head_pose_1": poses[1]}


def frames(count: int, views: int, size: int, g: torch.Generator) -> Dict[str, torch.Tensor]:
    """A pool of serving frames: ``imgs`` (N, V, S, S, 3) uint8 and
    ``head_poses`` (N, V, 2)."""
    imgs = torch.randint(0, 256, (count, views, size, size, 3), generator=g, device=g.device, dtype=torch.uint8)
    return {"imgs": imgs, "head_poses": _uniform((count, views, 2), -0.8, 0.8, g)}
