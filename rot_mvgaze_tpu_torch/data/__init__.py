"""The port's data tier (counterpart of ``rot_mvgaze_tpu/data``): stereo
pair index and camera splits, the V-view index, HDF5 datasets (stereo,
single-view and V-view), synthetic archives, the packed cache and its C++
loader, host-side batching and prefetch to the card.
Images stay raw uint8 until the train step's augmentation on the card."""

from rot_mvgaze_tpu_torch.data.hdf5 import GazeDataset
from rot_mvgaze_tpu_torch.data.multiview import MultiViewGazeDataset
from rot_mvgaze_tpu_torch.data.native import NativeBatchLoader, NativePool, PackedGazeDataset
from rot_mvgaze_tpu_torch.data.packed import PackedFile, pack_dataset, pack_hdf5, pack_rows, write_pack
from rot_mvgaze_tpu_torch.data.pairing import (
    CAMERA_TAGS,
    NUM_CAMERAS,
    build_multiview_index,
    build_pair_index,
    build_pair_index_reference,
    reference_pair_indices,
    resolve_pair_index,
)
from rot_mvgaze_tpu_torch.data.pipeline import BatchLoader, collate, device_prefetch
from rot_mvgaze_tpu_torch.data.synthetic import (
    InMemoryGazeDataset,
    InMemoryMultiViewGazeDataset,
    synthetic_rows,
    write_synthetic_corpus,
    write_synthetic_dataset,
    write_synthetic_h5,
)

__all__ = [
    "BatchLoader",
    "CAMERA_TAGS",
    "GazeDataset",
    "InMemoryGazeDataset",
    "InMemoryMultiViewGazeDataset",
    "MultiViewGazeDataset",
    "NUM_CAMERAS",
    "NativeBatchLoader",
    "NativePool",
    "PackedFile",
    "PackedGazeDataset",
    "build_multiview_index",
    "build_pair_index",
    "build_pair_index_reference",
    "collate",
    "device_prefetch",
    "pack_dataset",
    "pack_hdf5",
    "pack_rows",
    "reference_pair_indices",
    "resolve_pair_index",
    "synthetic_rows",
    "write_synthetic_corpus",
    "write_synthetic_dataset",
    "write_synthetic_h5",
    "write_pack",
]
