"""Packed sample cache, the on-disk format of the native (C++) loader (the
port's own copy of ``rot_mvgaze_tpu/data/packed.py``; files are byte for
byte the JAX package's).

Each subject's HDF5 archive is packed once into a flat, uncompressed file
that can be memory-mapped; a batch is then a parallel memcpy
(``data/native.py`` and ``native/loader.cpp``) with no per-sample Python or
HDF5. This is also the one dataset format a machine without ``h5py`` reads:
packs made elsewhere, copied beside their archives, are used as they are.

Layout (little-endian, structure of arrays)::

    offset 0   : magic  b"RMGPACK1"
    offset 8   : u64 n_samples
    offset 16  : u32 height, u32 width, u32 channels, u32 flags
    offset 32  : u64 img_off, u64 gaze_off, u64 pose_off   (absolute)
    img  : n * H * W * C  uint8   (RGB: the BGR archives are flipped here)
    gaze : n * 2          float32
    pose : n * 2          float32 (MPII-NV's pitch sign flipped here)

Every per-sample transform of the HDF5 reader (``data/hdf5.py``) is baked
in at pack time, so the hot path has none.

    python -m rot_mvgaze_tpu_torch.data.packed DATASET_DIR --dataset {xgaze,mpiinv}

packs every ``*.h5`` under ``DATASET_DIR`` into ``DATASET_DIR/_rmgpack/<dataset>``
(needs ``h5py``).
"""

from __future__ import annotations

import os
import struct
import uuid
from typing import Iterable, List, Sequence, Tuple

import numpy as np

MAGIC = b"RMGPACK1"
HEADER_SIZE = 56


def write_pack(out_path: str, n: int, h: int, w: int, c: int,
               image_blocks: Iterable[np.ndarray], gaze: np.ndarray, pose: np.ndarray) -> str:
    """Write one pack: ``image_blocks`` are uint8 ``(m, h, w, c)`` blocks
    totalling ``n`` samples (streamed, so memory stays bounded); ``gaze`` and
    ``pose`` are ``(n, 2)`` float32. The file is written under a temporary
    name, flushed to disk and renamed: a write cut short never leaves a
    truncated pack at ``out_path``, whose fresh mtime would pass the
    freshness check."""
    gaze = np.ascontiguousarray(gaze, dtype=np.float32)
    pose = np.ascontiguousarray(pose, dtype=np.float32)
    if gaze.shape != (n, 2) or pose.shape != (n, 2):
        raise ValueError(f"gaze {gaze.shape} and pose {pose.shape} must be ({n}, 2)")
    img_off = HEADER_SIZE
    gaze_off = img_off + n * h * w * c
    pose_off = gaze_off + gaze.nbytes
    tmp_path = f"{out_path}.tmp.{uuid.uuid4().hex}"
    try:
        with open(tmp_path, "wb") as out:
            out.write(MAGIC)
            out.write(struct.pack("<Q", n))
            out.write(struct.pack("<IIII", h, w, c, 0))
            out.write(struct.pack("<QQQ", img_off, gaze_off, pose_off))
            written = 0
            for block in image_blocks:
                block = np.ascontiguousarray(block, dtype=np.uint8)
                if block.shape[1:] != (h, w, c):
                    raise ValueError(f"image block {block.shape} is not (m, {h}, {w}, {c})")
                written += block.shape[0]
                out.write(block.tobytes())
            if written != n:
                raise ValueError(f"image blocks totalled {written} samples, not {n}")
            out.write(gaze.tobytes())
            out.write(pose.tobytes())
            out.flush()
            os.fsync(out.fileno())
        os.replace(tmp_path, out_path)
    finally:
        if os.path.exists(tmp_path):
            os.unlink(tmp_path)
    return out_path


def _pack_pose(pose: np.ndarray, dataset_name: str) -> np.ndarray:
    pose = np.array(pose, dtype=np.float32)
    if dataset_name == "mpiinv":
        pose[:, 0] *= -1  # the pitch sign convention
    return pose


def pack_hdf5(h5_path: str, out_path: str, dataset_name: str = "xgaze",
              color_type: str = "bgr", chunk: int = 512) -> str:
    """Pack one subject's HDF5 archive (``h5py`` is imported here only)."""
    import h5py

    with h5py.File(h5_path, "r") as f:
        n, h, w, c = f["face_patch"].shape
        gaze = np.asarray(f["face_gaze"], dtype=np.float32)
        pose = _pack_pose(f["face_head_pose"], dataset_name)

        def blocks():
            for start in range(0, n, chunk):
                block = np.asarray(f["face_patch"][start : start + chunk])
                yield block[..., ::-1] if color_type == "bgr" else block

        write_pack(out_path, n, h, w, c, blocks(), gaze, pose)
    return out_path


def pack_rows(out_path: str, face_patch: np.ndarray, face_gaze: np.ndarray,
              face_head_pose: np.ndarray, dataset_name: str = "xgaze",
              color_type: str = "bgr") -> str:
    """Pack one subject's rows as its archive would hold them: the pack
    :func:`pack_hdf5` writes from an archive of these arrays, byte for byte,
    with no archive and no ``h5py``."""
    n, h, w, c = face_patch.shape
    block = face_patch[..., ::-1] if color_type == "bgr" else face_patch
    return write_pack(out_path, n, h, w, c, [block], face_gaze,
                      _pack_pose(face_head_pose, dataset_name))


def read_header(path: str) -> Tuple[int, int, int, int, int, int, int]:
    """``(n, h, w, c, img_off, gaze_off, pose_off)`` of a pack; a file that
    does not start with the magic raises ``ValueError``."""
    with open(path, "rb") as f:
        head = f.read(HEADER_SIZE)
    if len(head) < HEADER_SIZE or head[:8] != MAGIC:
        raise ValueError(f"{path}: not a pack (bad magic or short header)")
    n = struct.unpack_from("<Q", head, 8)[0]
    h, w, c, _flags = struct.unpack_from("<IIII", head, 16)
    img_off, gaze_off, pose_off = struct.unpack_from("<QQQ", head, 32)
    return n, h, w, c, img_off, gaze_off, pose_off


def expected_size(path: str) -> int:
    """The byte size a pack's header claims."""
    n, _h, _w, _c, _img_off, _gaze_off, pose_off = read_header(path)
    return pose_off + n * 8


def is_valid_pack(path: str) -> bool:
    """Whether ``path`` is a whole pack (magic, and the size its header
    claims)."""
    try:
        return os.path.getsize(path) >= expected_size(path)
    except (OSError, ValueError):
        return False


class PackedFile:
    """A numpy memory map of one pack: ``images (n, h, w, c)``, ``gaze`` and
    ``head_pose`` ``(n, 2)`` (the numpy gathers, where the C++ pool is not
    available)."""

    def __init__(self, path: str) -> None:
        self.path = path
        self.n, self.h, self.w, self.c, img_off, gaze_off, pose_off = read_header(path)
        if os.path.getsize(path) < pose_off + self.n * 8:
            raise ValueError(f"{path}: truncated pack ({os.path.getsize(path)} bytes, its header "
                             f"claims {pose_off + self.n * 8})")
        mm = np.memmap(path, dtype=np.uint8, mode="r")
        size = self.n * self.h * self.w * self.c
        self.images = mm[img_off : img_off + size].reshape(self.n, self.h, self.w, self.c)
        self.gaze = mm[gaze_off : gaze_off + self.n * 8].view(np.float32).reshape(self.n, 2)
        self.head_pose = mm[pose_off : pose_off + self.n * 8].view(np.float32).reshape(self.n, 2)


def pack_dataset(dataset_path: str, subjects: Sequence[str], cache_dir: str,
                 dataset_name: str, color_type: str) -> List[str]:
    """The pack of each subject archive under ``cache_dir``
    (``<name>.rmgpack``), packing only those that are missing, older than
    their archive or not whole. A current pack is used as it is, without
    opening the archive (so without ``h5py``); so is a whole pack whose
    archive is absent (a corpus kept as packs only)."""
    os.makedirs(cache_dir, exist_ok=True)
    out = []
    for name in subjects:
        src = os.path.join(dataset_path, name)
        dst = os.path.join(cache_dir, name + ".rmgpack")
        if not os.path.exists(src):
            if not is_valid_pack(dst):
                raise FileNotFoundError(f"{src}: no archive, and {dst} is not a whole pack")
        elif (not os.path.exists(dst) or os.path.getmtime(dst) < os.path.getmtime(src)
                or not is_valid_pack(dst)):
            pack_hdf5(src, dst, dataset_name=dataset_name, color_type=color_type)
        out.append(dst)
    return out


def _main(argv=None) -> int:
    import argparse
    import glob
    import sys
    import time

    p = argparse.ArgumentParser(
        description="Pack subject HDF5 archives for the native loader (needs h5py).")
    p.add_argument("dataset_dir")
    p.add_argument("--dataset", choices=["xgaze", "mpiinv"], default="xgaze")
    p.add_argument("--color", choices=["bgr", "rgb"], default=None,
                   help="colour order of the archives (default: bgr for xgaze, rgb for mpiinv)")
    p.add_argument("--cache_dir", default=None,
                   help="default DATASET_DIR/_rmgpack/<dataset>, where the CLI looks")
    args = p.parse_args(argv)
    color = args.color or ("bgr" if args.dataset == "xgaze" else "rgb")
    subjects = sorted(os.path.basename(f) for f in glob.glob(os.path.join(args.dataset_dir, "*.h5")))
    if not subjects:
        print(f"no .h5 archives under {args.dataset_dir}", file=sys.stderr)
        return 1
    cache_dir = args.cache_dir or os.path.join(args.dataset_dir, "_rmgpack", args.dataset)
    t0 = time.perf_counter()
    paths = pack_dataset(args.dataset_dir, subjects, cache_dir, args.dataset, color)
    print(f"packed {len(paths)} archives -> {cache_dir} ({time.perf_counter() - t0:.1f}s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
