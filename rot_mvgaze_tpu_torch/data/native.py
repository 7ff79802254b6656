"""The packed-cache loader over the native gather engine (port of
``rot_mvgaze_tpu/data/native.py``; batches bit for bit the JAX loader's).

``rot_mvgaze_tpu_torch/native/loader.cpp`` is built with ``g++`` at first
use into ``build/torch_native/librmg_loader.so`` under the repository root
(under a temporary name, then renamed; rebuilt when the source is newer) and
loaded with ``ctypes``:

- :class:`NativePool`: the C++ memory maps and gather threads.
- :class:`PackedGazeDataset`: ``GazeDataset``'s samples and pair index over
  the packs (``data/packed.py``), packing missing or stale ones first; where
  the pool cannot be built (no ``g++``) its samples are numpy gathers from
  memory maps, served through ``data.BatchLoader``.
- :class:`NativeBatchLoader`: ``data.BatchLoader``'s batch contract (keys,
  dtypes, seeded epoch order, ``drop_last``, ``epoch`` and the one-shot
  ``skip_batches`` of a step-exact resume), each batch assembled by the pool
  while the previous one is consumed.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np

from rot_mvgaze_tpu_torch.data.packed import PackedFile, pack_dataset
from rot_mvgaze_tpu_torch.data.pairing import resolve_pair_index
from rot_mvgaze_tpu_torch.data.pipeline import epoch_order, sharded_num_samples

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(_PKG, "native", "loader.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_native")
LIB_PATH = os.path.join(BUILD_DIR, "librmg_loader.so")

_lib = None
_lib_failed = False  # a failed build is not retried: no g++ appears mid-process
_lib_lock = threading.Lock()

_ADD_ERRORS = {
    -1: "cannot open or map",
    -2: "bad magic or truncated header",
    -3: "inconsistent extents (truncated or corrupt pack)",
    -4: "image dims differ from the pool's first file (all packs of a pool share one geometry)",
}


def _load_library() -> Optional[ctypes.CDLL]:
    global _lib, _lib_failed
    with _lib_lock:
        if _lib is not None or _lib_failed:
            return _lib
        try:
            if not os.path.exists(LIB_PATH) or os.path.getmtime(LIB_PATH) < os.path.getmtime(SRC):
                os.makedirs(BUILD_DIR, exist_ok=True)
                # a private name, then an atomic rename: concurrent builds
                # cannot corrupt each other's library, and a compile cut short
                # leaves none whose fresh mtime would stop the rebuild
                tmp = f"{LIB_PATH}.tmp.{os.getpid()}"
                try:
                    subprocess.run(
                        ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
                         "-o", tmp, SRC, "-lpthread"],
                        check=True, capture_output=True,
                    )
                    os.replace(tmp, LIB_PATH)
                finally:
                    if os.path.exists(tmp):
                        os.unlink(tmp)
            lib = ctypes.CDLL(LIB_PATH)
        except (OSError, subprocess.CalledProcessError):
            _lib_failed = True
            return None
        lib.rmg_pool_create.restype = ctypes.c_void_p
        lib.rmg_pool_create.argtypes = [ctypes.c_int]
        lib.rmg_pool_destroy.restype = None
        lib.rmg_pool_destroy.argtypes = [ctypes.c_void_p]
        lib.rmg_pool_add.restype = ctypes.c_int
        lib.rmg_pool_add.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.rmg_file_info.restype = ctypes.c_int
        lib.rmg_file_info.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        gather_args = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.rmg_pool_gather.restype = None
        lib.rmg_pool_gather.argtypes = gather_args
        lib.rmg_pool_gather_async.restype = ctypes.c_uint64
        lib.rmg_pool_gather_async.argtypes = gather_args
        lib.rmg_wait.restype = None
        lib.rmg_wait.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        _lib = lib
        return _lib


class NativePool:
    """The C++ pool over the packs at ``paths`` (all of one image geometry;
    a truncated, corrupt or differently shaped pack raises ``IOError``)."""

    def __init__(self, paths: Sequence[str], n_threads: int = 0) -> None:
        lib = _load_library()
        if lib is None:
            raise RuntimeError("native loader unavailable (no g++?)")
        self._lib = lib
        self._pool = ctypes.c_void_p(lib.rmg_pool_create(n_threads))
        # index arrays and output buffers of the gathers in flight, kept alive
        self._inflight: Dict[int, tuple] = {}
        self.shapes: List[tuple] = []
        for p in paths:
            idx = lib.rmg_pool_add(self._pool, os.fsencode(p))
            if idx < 0:
                raise IOError(f"rmg_pool_add failed for {p}: {_ADD_ERRORS.get(idx, f'error {idx}')}")
            n, h, w, c = ctypes.c_int64(), ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
            lib.rmg_file_info(self._pool, idx, n, h, w, c)
            self.shapes.append((n.value, h.value, w.value, c.value))

    @staticmethod
    def available() -> bool:
        """Whether the engine builds and loads here."""
        return _load_library() is not None

    @staticmethod
    def _index(files: np.ndarray, rows: np.ndarray):
        return np.ascontiguousarray(files, np.int32), np.ascontiguousarray(rows, np.int64)

    def gather(self, files: np.ndarray, rows: np.ndarray) -> Dict[str, np.ndarray]:
        """Rows ``rows`` of packs ``files``: ``{"img", "gaze", "head_pose"}``."""
        files, rows = self._index(files, rows)
        n = len(rows)
        _, h, w, c = self.shapes[0]
        out = {"img": np.empty((n, h, w, c), np.uint8), "gaze": np.empty((n, 2), np.float32),
               "head_pose": np.empty((n, 2), np.float32)}
        self._lib.rmg_pool_gather(
            self._pool, files.ctypes.data, rows.ctypes.data, n,
            out["img"].ctypes.data, out["gaze"].ctypes.data, out["head_pose"].ctypes.data,
        )
        return out

    def gather_async(self, files, rows, imgs, gaze, pose) -> int:
        """Start gathering into the given buffers; returns the ticket that
        :meth:`wait` takes."""
        files, rows = self._index(files, rows)
        ticket = self._lib.rmg_pool_gather_async(
            self._pool, files.ctypes.data, rows.ctypes.data, len(rows),
            imgs.ctypes.data, gaze.ctypes.data, pose.ctypes.data,
        )
        self._inflight[ticket] = (files, rows, imgs, gaze, pose)
        return ticket

    def wait(self, ticket: int) -> None:
        self._lib.rmg_wait(self._pool, ticket)
        self._inflight.pop(ticket, None)

    def __del__(self) -> None:
        if getattr(self, "_pool", None):
            self._lib.rmg_pool_destroy(self._pool)
            self._pool = None


class PackedGazeDataset:
    """``GazeDataset``'s stereo dataset over packs: the packs of
    ``keys_to_use`` in ``cache_dir`` (default
    ``<dataset_path>/_rmgpack/<dataset_name>``), packed from the archives
    where missing or stale; the pair index from their row counts
    (``pairing``, ``pair_rng``, ``seed``, or ``pair_index`` as given), checked
    against those counts, so that a stale pack raises here rather than
    faulting in a C++ memcpy. ``pool`` is the C++ pool, or None where it
    cannot be built (or ``use_native`` is false); samples are numpy gathers
    either way."""

    def __init__(
        self,
        dataset_name: str,
        dataset_path: str,
        color_type: str,
        keys_to_use: Sequence[str],
        camera_tag: str = "all",
        stereo: bool = True,
        seed: int = 0,
        cache_dir: Optional[str] = None,
        use_native: bool = True,
        pairing: str = "reference",
        pair_rng=None,
        pair_index=None,
    ) -> None:
        self.dataset_name = dataset_name
        self.color_type = color_type
        self.camera_tag = camera_tag
        self.stereo = stereo
        cache_dir = cache_dir or os.path.join(dataset_path, "_rmgpack", dataset_name)
        self.paths = pack_dataset(dataset_path, list(keys_to_use), cache_dir, dataset_name, color_type)
        self._np_files = [PackedFile(p) for p in self.paths]
        self.file_sizes = [f.n for f in self._np_files]
        self.idx_to_kv = resolve_pair_index(
            self.file_sizes, camera_tag, pairing=pairing, pair_rng=pair_rng, seed=seed,
            pair_index=pair_index,
        )
        kv = np.asarray(self.idx_to_kv, np.int64).reshape(-1, 3)
        if kv.size:
            if kv[:, 0].min() < 0 or kv[:, 0].max() >= len(self.file_sizes):
                raise ValueError(f"pair index references file {int(kv[:, 0].max())} but only "
                                 f"{len(self.file_sizes)} packed files exist")
            limits = np.asarray(self.file_sizes, np.int64)[kv[:, 0]]
            bad = (kv[:, 1] < 0) | (kv[:, 1] >= limits) | (kv[:, 2] < 0) | (kv[:, 2] >= limits)
            if bad.any():
                i = int(np.argmax(bad))
                raise ValueError(
                    f"pair index row {i} references sample {int(max(kv[i, 1], kv[i, 2]))} of "
                    f"'{keys_to_use[int(kv[i, 0])]}' but its pack holds only {int(limits[i])} rows: "
                    f"the pack is stale (its archive changed without a newer mtime). Delete "
                    f"'{cache_dir}' to re-pack."
                )
        self.pool: Optional[NativePool] = None
        if use_native and NativePool.available():
            self.pool = NativePool(self.paths)

    def __len__(self) -> int:
        return len(self.idx_to_kv)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        key, idx, idx_b = self.idx_to_kv[index]
        f = self._np_files[key]
        data = {"img_0": np.asarray(f.images[idx]), "gt_gaze": np.asarray(f.gaze[idx], np.float64),
                "head_pose_0": np.asarray(f.head_pose[idx], np.float64), "idx_0": idx}
        if self.stereo:
            data.update({"img_1": np.asarray(f.images[idx_b]),
                         "gt_gaze_1": np.asarray(f.gaze[idx_b], np.float64),
                         "head_pose_1": np.asarray(f.head_pose[idx_b], np.float64), "idx_1": idx_b})
        return data


class NativeBatchLoader:
    """Shuffling batch iterator whose batches the C++ pool assembles, two
    in flight. One ``__iter__`` is one epoch in ``epoch_order`` for the
    loader's ``epoch``, which then advances; ``skip_batches`` fast-forwards
    the next epoch once; ``last_epoch_order`` holds the rows an iteration
    yields. Batches: ``img_0``/``img_1`` uint8, ``gt_gaze``, ``gt_gaze_1``,
    ``head_pose_0``, ``head_pose_1`` float32, ``idx_0``/``idx_1`` int32."""

    def __init__(
        self,
        dataset: PackedGazeDataset,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        drop_last: bool = False,
        process_shard: Optional[tuple] = None,
    ) -> None:
        if dataset.pool is None:
            raise ValueError("NativeBatchLoader needs the dataset's C++ pool (use_native and g++)")
        if len(dataset.idx_to_kv) == 0:
            raise ValueError("dataset pair index is empty (no frame has >= 2 cameras in this split): "
                             "nothing to load")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.process_shard = process_shard
        self.epoch = 0
        self.skip_batches = 0
        kv = np.asarray(dataset.idx_to_kv, np.int64)
        self._files = kv[:, 0].astype(np.int32)
        self._rows = kv[:, 1]
        self._rows_b = kv[:, 2]

    def num_samples(self) -> int:
        return sharded_num_samples(len(self.dataset), self.process_shard)

    def __len__(self) -> int:
        n = self.num_samples()
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self):
        pool = self.dataset.pool
        order = epoch_order(len(self.dataset), self.shuffle, self.seed, self.epoch, self.process_shard)
        skip, self.skip_batches = int(self.skip_batches), 0
        first = skip * self.batch_size
        self.last_epoch_order = order[first:]
        n = len(order)
        stop = (n // self.batch_size) * self.batch_size if self.drop_last else n
        starts = list(range(first, stop, self.batch_size))
        _, h, w, c = pool.shapes[0]

        def submit(start):
            idxs = order[start : start + self.batch_size]
            bs = len(idxs)
            buf = {
                "img_0": np.empty((bs, h, w, c), np.uint8),
                "gt_gaze": np.empty((bs, 2), np.float32),
                "head_pose_0": np.empty((bs, 2), np.float32),
                "img_1": np.empty((bs, h, w, c), np.uint8),
                "gt_gaze_1": np.empty((bs, 2), np.float32),
                "head_pose_1": np.empty((bs, 2), np.float32),
            }
            t0 = pool.gather_async(self._files[idxs], self._rows[idxs],
                                   buf["img_0"], buf["gt_gaze"], buf["head_pose_0"])
            t1 = pool.gather_async(self._files[idxs], self._rows_b[idxs],
                                   buf["img_1"], buf["gt_gaze_1"], buf["head_pose_1"])
            buf["idx_0"] = self._rows[idxs].astype(np.int32)
            buf["idx_1"] = self._rows_b[idxs].astype(np.int32)
            return t0, t1, buf

        inflight = []
        try:
            for start in starts[:2]:
                inflight.append(submit(start))
            next_i = 2
            while inflight:
                t0, t1, buf = inflight.pop(0)
                pool.wait(t0)
                pool.wait(t1)
                if next_i < len(starts):
                    inflight.append(submit(starts[next_i]))
                    next_i += 1
                yield buf
        finally:
            # a consumer that stops early: drain the gathers still writing
            # into their buffers, and end the epoch as BatchLoader does
            for t0, t1, _ in inflight:
                pool.wait(t0)
                pool.wait(t1)
            self.epoch += 1
