"""V-view dataset over the per-subject HDF5 archives (port of
``rot_mvgaze_tpu/data/multiview.py``).

A sample stacks ``n_views`` views of one frame::

    {"imgs": (V,H,W,3) uint8, "gt_gazes": (V,2), "head_poses": (V,2),
     "idxs": (V,) int64}

View 0 is the sample's own row (the eval view); the partners come from
:func:`rot_mvgaze_tpu_torch.data.pairing.build_multiview_index`, drawn once
at construction. Archive handling is :class:`GazeDataset`'s.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np

from rot_mvgaze_tpu_torch.data.hdf5 import GazeDataset
from rot_mvgaze_tpu_torch.data.pairing import build_multiview_index


class MultiViewGazeDataset(GazeDataset):
    """See the module docstring. ``idx_to_kv`` holds ``(file, (row,
    partner rows...))``."""

    def __init__(
        self,
        dataset_name: str,
        dataset_path: str,
        color_type: str,
        keys_to_use: Sequence[str],
        n_views: int = 3,
        camera_tag: str = "all",
        seed: int = 0,
    ) -> None:
        # no stereo pairing is drawn: the V-view index replaces it
        super().__init__(dataset_name, dataset_path, color_type, keys_to_use,
                         camera_tag=camera_tag, stereo=True, seed=seed, pair_index=[])
        self.n_views = int(n_views)
        self.idx_to_kv = build_multiview_index(self.file_sizes, camera_tag, n_views=self.n_views, seed=seed)
        if not self.idx_to_kv:
            raise ValueError(
                f"n_views={self.n_views} left no usable frame in {dataset_name!r} "
                f"(camera_tag={camera_tag!r}, {len(self.file_sizes)} files): every frame has fewer "
                f"than {self.n_views} valid rows"
            )

    def __getitem__(self, index: int) -> Dict[str, Any]:
        key, idxs = self.idx_to_kv[index]
        hdf = self._archives()[key]
        return stack_views([self._read_view(hdf, i) for i in idxs], idxs)


def stack_views(views: list, idxs: Sequence[int]) -> Dict[str, Any]:
    """One V-view sample from per-view ``{img, gaze, head_pose}`` dicts."""
    return {
        "imgs": np.stack([v["img"] for v in views]),
        "gt_gazes": np.stack([v["gaze"] for v in views]),
        "head_poses": np.stack([v["head_pose"] for v in views]),
        "idxs": np.asarray(idxs, dtype=np.int64),
    }
