"""Synthetic subject archives (port of ``rot_mvgaze_tpu/data/synthetic.py``).

Rows have the real datasets' schema and layout: ``face_patch (N,H,W,3)
uint8``, ``face_gaze (N,2)``, ``face_head_pose (N,2)``, frame-major over 18
cameras. :func:`synthetic_rows` makes the arrays; :func:`write_synthetic_h5`
writes them to an HDF5 archive (``h5py`` is imported only there);
:class:`InMemoryGazeDataset` and :class:`InMemoryMultiViewGazeDataset`
serve them with ``GazeDataset``'s and ``MultiViewGazeDataset``'s sample
contracts and no archive at all.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import numpy as np

from rot_mvgaze_tpu_torch.data.multiview import stack_views
from rot_mvgaze_tpu_torch.data.pairing import build_multiview_index, build_pair_index_reference

#: Label range (rad) and normalisation half-range of the learnable corpus.
LEARNABLE_GAZE_RANGE = 0.6
_LEARNABLE_NORM = 0.7


def _learnable_rows(rng: np.random.Generator, n: int, image_size: int):
    """Images whose gaze label can be read from the pixels: a bright disc
    over mid-gray noise, centred at the position that linearly encodes
    (pitch, yaw). It survives the train augmentation (no rotation, ±1%
    translation, brightness scaling keeps the disc's local contrast), so
    training on it can drive the eval error down."""
    s = image_size
    gaze = rng.uniform(-LEARNABLE_GAZE_RANGE, LEARNABLE_GAZE_RANGE, (n, 2)).astype(np.float32)
    imgs = rng.integers(96, 161, (n, s, s, 3), dtype=np.uint8)
    yy, xx = np.mgrid[0:s, 0:s]
    r2 = (s / 8.0) ** 2
    cy = (gaze[:, 0] / _LEARNABLE_NORM + 1.0) / 2.0 * (s - 1)
    cx = (gaze[:, 1] / _LEARNABLE_NORM + 1.0) / 2.0 * (s - 1)
    for i in range(n):
        imgs[i][(yy - cy[i]) ** 2 + (xx - cx[i]) ** 2 <= r2] = 255
    return imgs, gaze


def synthetic_rows(
    n_frames: int = 4,
    n_cameras: int = 18,
    image_size: int = 32,
    seed: int = 0,
    learnable: bool = False,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(face_patch, face_gaze, face_head_pose)`` of one synthetic subject,
    ``n_frames * n_cameras`` rows drawn from ``numpy.random.default_rng(seed)``.
    ``learnable=True`` encodes the gaze label in the pixels
    (:func:`_learnable_rows`); the default is label-independent noise."""
    rng = np.random.default_rng(seed)
    n = n_frames * n_cameras
    if learnable:
        imgs, gaze = _learnable_rows(rng, n, image_size)
    else:
        imgs = rng.integers(0, 256, (n, image_size, image_size, 3), dtype=np.uint8)
        gaze = rng.uniform(-1.0, 1.0, (n, 2)).astype(np.float32)
    head_pose = rng.uniform(-0.8, 0.8, (n, 2)).astype(np.float32)
    return imgs, gaze, head_pose


def write_synthetic_h5(
    path: str,
    n_frames: int = 4,
    n_cameras: int = 18,
    image_size: int = 32,
    seed: int = 0,
    learnable: bool = False,
) -> str:
    """Write one synthetic subject archive of :func:`synthetic_rows`;
    returns ``path``."""
    import h5py

    imgs, gaze, head_pose = synthetic_rows(n_frames, n_cameras, image_size, seed, learnable)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("face_patch", data=imgs)
        f.create_dataset("face_gaze", data=gaze)
        f.create_dataset("face_head_pose", data=head_pose)
    return path


def write_synthetic_dataset(
    root: str,
    subjects: Optional[list] = None,
    n_frames: int = 4,
    image_size: int = 32,
    seed: int = 0,
    n_cameras: int = 18,
    learnable: bool = False,
) -> list:
    """Write one archive per name in ``subjects`` under ``root``, subject i
    from seed ``seed + i``; returns the names."""
    subjects = subjects if subjects is not None else ["s00.h5", "s01.h5"]
    for i, name in enumerate(subjects):
        write_synthetic_h5(
            os.path.join(root, name), n_frames=n_frames, n_cameras=n_cameras,
            image_size=image_size, seed=seed + i, learnable=learnable,
        )
    return subjects


class InMemoryGazeDataset:
    """``GazeDataset``'s stereo samples over synthetic subjects held in
    memory, for machines without ``h5py``: subject ``i`` is
    ``synthetic_rows(n_frames, 18, image_size, seed + i, learnable)`` and the
    pairs come from the reference pairing with ``seed``. It yields what
    ``GazeDataset("xgaze", root, "rgb", names, camera_tag, seed=seed)``
    yields over ``write_synthetic_dataset(root, names, n_frames, image_size,
    seed, learnable=learnable)``, bit for bit."""

    def __init__(
        self,
        subjects: int,
        n_frames: int = 4,
        image_size: int = 32,
        seed: int = 0,
        learnable: bool = False,
        camera_tag: str = "all",
    ) -> None:
        self.rows = [
            synthetic_rows(n_frames, 18, image_size, seed + i, learnable) for i in range(subjects)
        ]
        self.file_sizes = [len(r[0]) for r in self.rows]
        self.idx_to_kv = build_pair_index_reference(self.file_sizes, camera_tag, seed=seed)

    def __len__(self) -> int:
        return len(self.idx_to_kv)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        subject, a, b = self.idx_to_kv[index]
        imgs, gaze, pose = self.rows[subject]
        return {"img_0": imgs[a], "gt_gaze": gaze[a].astype(np.float64),
                "head_pose_0": pose[a].astype(np.float64), "idx_0": a,
                "img_1": imgs[b], "gt_gaze_1": gaze[b].astype(np.float64),
                "head_pose_1": pose[b].astype(np.float64), "idx_1": b}


class InMemoryMultiViewGazeDataset:
    """``MultiViewGazeDataset``'s V-view samples over synthetic subjects held
    in memory, for machines without ``h5py``: subject ``i`` as in
    :class:`InMemoryGazeDataset`, the index from ``build_multiview_index``
    with ``seed``. It yields what ``MultiViewGazeDataset("xgaze", root,
    "rgb", names, n_views, camera_tag, seed)`` yields over
    ``write_synthetic_dataset(root, names, n_frames, image_size, seed,
    learnable=learnable)``, bit for bit."""

    def __init__(
        self,
        subjects: int,
        n_views: int = 3,
        n_frames: int = 4,
        image_size: int = 32,
        seed: int = 0,
        learnable: bool = False,
        camera_tag: str = "all",
    ) -> None:
        self.rows = [
            synthetic_rows(n_frames, 18, image_size, seed + i, learnable) for i in range(subjects)
        ]
        self.n_views = int(n_views)
        self.file_sizes = [len(r[0]) for r in self.rows]
        self.idx_to_kv = build_multiview_index(self.file_sizes, camera_tag, n_views=self.n_views, seed=seed)

    def __len__(self) -> int:
        return len(self.idx_to_kv)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        subject, idxs = self.idx_to_kv[index]
        imgs, gaze, pose = self.rows[subject]
        return stack_views([{"img": imgs[i], "gaze": gaze[i].astype(np.float64),
                             "head_pose": pose[i].astype(np.float64)} for i in idxs], idxs)
