"""Per-pair gaze losses (port of ``rot_mvgaze_tpu/losses/gaze.py``).

The angular loss is ``acos(clip(cos_sim, -1+eps, 1-eps)) * 180/pi`` over
unit vectors derived from pitchyaw. The ``1e-6`` clamp keeps the gradient
finite when a prediction equals its label (``d acos(x)/dx`` is infinite at
1); it biases the loss by at most ``acos(1-1e-6)`` = 0.08 degrees, and only
at zero error. Norms are floored at ``eps`` as ``F.cosine_similarity``
floors them.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from rot_mvgaze_tpu_torch.geometry.gaze import pitchyaw_to_vector

_RAD2DEG = 180.0 / np.pi
_SIM_EPS = 1e-6


def _cosine_similarity(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Dot over ``max(||a||, eps) * max(||b||, eps)``, as torch's
    ``F.cosine_similarity`` computes it."""
    dot = torch.sum(a * b, dim=-1)
    na = torch.clamp(torch.linalg.vector_norm(a, dim=-1), min=eps)
    nb = torch.clamp(torch.linalg.vector_norm(b, dim=-1), min=eps)
    return dot / (na * nb)


def gaze_angular_loss(y_hat: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean angular distance in degrees between pitchyaw predictions."""
    va = pitchyaw_to_vector(y)
    vb = pitchyaw_to_vector(y_hat)
    sim = torch.clamp(_cosine_similarity(va, vb), -1.0 + _SIM_EPS, 1.0 - _SIM_EPS)
    return torch.mean(torch.acos(sim) * _RAD2DEG)


def gaze_l2_loss(y: torch.Tensor, y_hat: torch.Tensor) -> torch.Tensor:
    """Mean squared error over pitchyaw."""
    return torch.mean(torch.square(y - y_hat))


def gaze_l1_loss(y: torch.Tensor, y_hat: torch.Tensor) -> torch.Tensor:
    """Mean absolute error over pitchyaw. |d| is written as ``where(d >= 0,
    d, -d)`` so that its gradient at d = 0 is +1, as ``jnp.abs``'s is
    (``torch.abs``'s is 0); the values are the same."""
    d = y - y_hat
    return torch.mean(torch.where(d >= 0, d, -d))


def make_gaze_loss(loss_type: str) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """``'l1'``, ``'l2'`` or ``'angular'``."""
    if loss_type == "l1":
        return gaze_l1_loss
    if loss_type == "l2":
        return gaze_l2_loss
    if loss_type == "angular":
        return gaze_angular_loss
    raise ValueError(f"unknown loss type {loss_type!r}")
