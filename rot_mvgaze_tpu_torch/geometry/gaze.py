"""Gaze geometry primitives (port of ``rot_mvgaze_tpu/geometry/gaze.py``).

Conventions:
- ``pitchyaw = (pitch, yaw)``; gaze vector
  ``v = (cos(p)·sin(y), sin(p), cos(p)·cos(y))``.
- Head-pose rotation ``R = Ry(yaw) @ Rx(-pitch)``: the pitch sign flip is
  part of the head-pose definition.

The torch functions work over the trailing axis and broadcast over leading
batch dims. The float64 numpy functions are the host-side eval metric; they
are copies of the JAX package's numpy twins, since the port may not import
that package.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "pitchyaw_to_vector",
    "pitchyaw_to_vector_numpy",
    "vector_to_pitchyaw",
    "vector_to_pitchyaw_numpy",
    "angular_error",
    "angular_error_numpy",
    "rotation_matrix_2d",
]

_RAD2DEG = 180.0 / np.pi


def pitchyaw_to_vector(pitchyaws: torch.Tensor) -> torch.Tensor:
    """(..., 2) pitchyaw angles -> (..., 3) unit gaze vectors."""
    pitch = pitchyaws[..., 0]
    yaw = pitchyaws[..., 1]
    cos_p = torch.cos(pitch)
    return torch.stack(
        [cos_p * torch.sin(yaw), torch.sin(pitch), cos_p * torch.cos(yaw)],
        dim=-1,
    )


def vector_to_pitchyaw(vectors: torch.Tensor) -> torch.Tensor:
    """(..., 3) gaze vectors -> (..., 2) pitchyaw angles."""
    norm = torch.linalg.vector_norm(vectors, dim=-1, keepdim=True)
    v = vectors / torch.clamp(norm, min=1e-12)
    pitch = torch.asin(torch.clamp(v[..., 1], -1.0, 1.0))
    yaw = torch.atan2(v[..., 0], v[..., 2])
    return torch.stack([pitch, yaw], dim=-1)


def angular_error(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Angular error in degrees between gaze directions.

    Inputs may be (..., 2) pitchyaw or (..., 3) vectors. Norms are floored at
    1e-7 and the cosine similarity is clamped to [-1, 1] before ``acos``.
    """
    if a.shape[-1] == 2:
        a = pitchyaw_to_vector(a)
    if b.shape[-1] == 2:
        b = pitchyaw_to_vector(b)
    ab = torch.sum(a * b, dim=-1)
    a_norm = torch.clamp(torch.linalg.vector_norm(a, dim=-1), min=1e-7)
    b_norm = torch.clamp(torch.linalg.vector_norm(b, dim=-1), min=1e-7)
    sim = torch.clamp(ab / (a_norm * b_norm), -1.0, 1.0)
    return torch.acos(sim) * _RAD2DEG


def rotation_matrix_2d(
    pitch_yaw: torch.Tensor, inverse: bool = False
) -> torch.Tensor:
    """Head-pose pitchyaw (..., 2) -> SO(3) rotation matrices (..., 3, 3).

    ``R = Ry(yaw) @ Rx(-pitch)`` in closed form; ``inverse=True`` transposes
    (label -> canonical).
    """
    pitch = -pitch_yaw[..., 0]
    yaw = pitch_yaw[..., 1]
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    zeros = torch.zeros_like(cp)
    mats = torch.stack(
        [cy, sy * sp, sy * cp,
         zeros, cp, -sp,
         -sy, cy * sp, cy * cp],
        dim=-1,
    ).reshape(*pitch.shape, 3, 3)
    if inverse:
        mats = mats.transpose(-1, -2)
    return mats


# ---------------------------------------------------------------------------
# float64 numpy versions: the host-side eval metric path.
# ---------------------------------------------------------------------------


def pitchyaw_to_vector_numpy(pitchyaws: np.ndarray) -> np.ndarray:
    """float64 numpy twin of :func:`pitchyaw_to_vector`."""
    pitchyaws = np.asarray(pitchyaws, dtype=np.float64)
    sin = np.sin(pitchyaws)
    cos = np.cos(pitchyaws)
    out = np.empty((*pitchyaws.shape[:-1], 3), dtype=np.float64)
    out[..., 0] = cos[..., 0] * sin[..., 1]
    out[..., 1] = sin[..., 0]
    out[..., 2] = cos[..., 0] * cos[..., 1]
    return out


def vector_to_pitchyaw_numpy(vectors: np.ndarray) -> np.ndarray:
    """float64 numpy twin of :func:`vector_to_pitchyaw`."""
    vectors = np.asarray(vectors, dtype=np.float64)
    norm = np.linalg.norm(vectors, axis=-1, keepdims=True)
    v = vectors / np.maximum(norm, 1e-12)
    out = np.empty((*vectors.shape[:-1], 2), dtype=np.float64)
    out[..., 0] = np.arcsin(np.clip(v[..., 1], -1.0, 1.0))
    out[..., 1] = np.arctan2(v[..., 0], v[..., 2])
    return out


def angular_error_numpy(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """float64 per-sample angular error in degrees (norms clipped at 1e-7,
    cosine clamped to [-1, 1] so round-off at 0° cannot produce NaN)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    if a.shape[-1] == 2:
        a = pitchyaw_to_vector_numpy(a)
    if b.shape[-1] == 2:
        b = pitchyaw_to_vector_numpy(b)
    ab = np.sum(a * b, axis=-1)
    a_norm = np.clip(np.linalg.norm(a, axis=-1), 1e-7, None)
    b_norm = np.clip(np.linalg.norm(b, axis=-1), 1e-7, None)
    sim = np.clip(ab / (a_norm * b_norm), -1.0, 1.0)
    return np.arccos(sim) * 180.0 / np.pi
