"""HDF5-backed stereo gaze dataset (port of ``GazeDataset`` in
``rot_mvgaze_tpu/data/hdf5.py``).

``__getitem__`` returns raw uint8 RGB images; float conversion,
normalisation and augmentation run on the card inside the train step.
Archives are opened lazily, once per reading thread (SWMR), so the loader's
thread pool reads in parallel. ``h5py`` is imported only when a dataset is
built: the port imports without it.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, List, Sequence

import numpy as np

from rot_mvgaze_tpu_torch.data.pairing import PairIndex, resolve_pair_index


class GazeDataset:
    """Stereo-pair gaze dataset over per-subject HDF5 archives.

    Each archive holds ``face_patch (N,H,W,3) uint8``, ``face_gaze (N,2)``
    and ``face_head_pose (N,2)``, rows frame-major over 18 cameras. A sample
    is ``{img_0, gt_gaze, head_pose_0, idx_0[, img_1, gt_gaze_1,
    head_pose_1, idx_1]}``: ``img_*`` raw uint8 RGB (H, W, 3) (``"bgr"``
    archives are flipped to RGB), labels float64, and MPII-NV's head-pose
    pitch negated to the XGaze convention. ``idx_to_kv`` is the pair index
    (:func:`rot_mvgaze_tpu_torch.data.pairing.resolve_pair_index`:
    ``pairing``, ``pair_rng``, ``seed``, ``pair_index``).
    """

    def __init__(
        self,
        dataset_name: str,
        dataset_path: str,
        color_type: str,
        keys_to_use: Sequence[str],
        camera_tag: str = "all",
        stereo: bool = True,
        seed: int = 0,
        pairing: str = "reference",
        pair_rng=None,
        pair_index: "PairIndex | None" = None,
    ) -> None:
        import h5py

        if dataset_name not in ("xgaze", "mpiinv"):
            raise ValueError(f"dataset_name must be 'xgaze' or 'mpiinv', got {dataset_name!r}")
        if color_type not in ("rgb", "bgr"):
            raise ValueError(f"color_type must be 'rgb' or 'bgr', got {color_type!r}")
        self.dataset_name = dataset_name
        self.color_type = color_type
        self.camera_tag = camera_tag
        self.stereo = stereo
        self.file_paths = [os.path.join(dataset_path, k) for k in keys_to_use]
        if not self.file_paths:
            raise ValueError("keys_to_use must be non-empty")
        sizes = []
        for p in self.file_paths:
            with h5py.File(p, "r", swmr=True) as f:
                sizes.append(f["face_patch"].shape[0])
        self.file_sizes = sizes
        self.idx_to_kv = resolve_pair_index(
            sizes, camera_tag, pairing=pairing, pair_rng=pair_rng, seed=seed,
            pair_index=pair_index,
        )
        # Every thread's handles, keyed by the owning thread, so that close()
        # reaches them (threading.local hides them from the closing thread)
        # and dead threads' handles are closed when a new thread opens: the
        # loader starts a fresh pool every epoch.
        self._local = threading.local()
        self._open_handles: List[tuple] = []  # (thread, [h5py.File, ...])
        self._handles_lock = threading.Lock()
        # bumped by close(): a thread whose handles were closed reopens
        self._generation = 0

    def _archives(self) -> list:
        if getattr(self._local, "generation", -1) != self._generation:
            import h5py

            # open and register under the lock, so that a concurrent close()
            # either sees these handles or bumps the generation first
            with self._handles_lock:
                dead = [e for e in self._open_handles if not e[0].is_alive()]
                self._open_handles = [e for e in self._open_handles if e[0].is_alive()]
                handles = [h5py.File(p, "r", swmr=True) for p in self.file_paths]
                gen = self._generation
                self._open_handles.append((threading.current_thread(), handles))
            for _, hs in dead:
                for f in hs:
                    f.close()
            self._local.archives = handles
            self._local.generation = gen
        return self._local.archives

    def __len__(self) -> int:
        return len(self.idx_to_kv)

    def _read_view(self, hdf, idx: int) -> Dict[str, Any]:
        image = np.asarray(hdf["face_patch"][idx])
        if self.color_type == "bgr":
            image = image[..., ::-1]
        gaze = np.asarray(hdf["face_gaze"][idx], dtype=np.float64)
        head_pose = np.asarray(hdf["face_head_pose"][idx], dtype=np.float64)
        if self.dataset_name == "mpiinv":
            head_pose = head_pose.copy()
            head_pose[0] *= -1
        return {"img": image, "gaze": gaze, "head_pose": head_pose}

    def __getitem__(self, index: int) -> Dict[str, Any]:
        key, idx, idx_b = self.idx_to_kv[index]
        hdf = self._archives()[key]
        v0 = self._read_view(hdf, idx)
        data: Dict[str, Any] = {
            "img_0": v0["img"], "gt_gaze": v0["gaze"], "head_pose_0": v0["head_pose"], "idx_0": idx,
        }
        if self.stereo:
            v1 = self._read_view(hdf, idx_b)
            data.update({
                "img_1": v1["img"], "gt_gaze_1": v1["gaze"], "head_pose_1": v1["head_pose"],
                "idx_1": idx_b,
            })
        return data

    def close(self) -> None:
        """Close every thread's handles. Quiesce the loaders first: a read in
        flight fails on its closed handle; a later read reopens."""
        with self._handles_lock:
            entries, self._open_handles = self._open_handles, []
            self._generation += 1
        for _, handles in entries:
            for f in handles:
                f.close()
        if hasattr(self._local, "archives"):
            del self._local.archives
