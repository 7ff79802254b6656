"""The cold data path: archive-to-pack conversion, and the first epoch over
packs out of the page cache against the second (port of
``scripts/bench_cold_path.py``).

1. **Conversion throughput**: ``data.packed.pack_hdf5`` over synthetic
   subject archives (``data.synthetic.write_synthetic_h5``), the one-time
   cost each archive pays before the C++ loader serves it, each pack's
   ``fsync`` included. It needs ``h5py``; where that does not import, the
   record holds ``"conversion": null`` and the reason, and the packs are
   written from the same rows by ``data.packed.pack_rows``.
2. **Cold against hot epoch**: one pass of ``NativeBatchLoader`` (one pool
   thread, every row of every pack, each batch's images copied to the
   device) over packs whose pages were just evicted from the page cache,
   then a second pass over the same packs. The eviction is per file, with
   ``os.posix_fadvise(fd, 0, 0, POSIX_FADV_DONTNEED)`` after an ``fsync``:
   the run touches no system-wide setting. The kernel may keep a page it
   cannot drop; on tmpfs nothing is evicted (RAM is the store), so such a
   directory is refused.

::

    python -m rot_mvgaze_tpu_torch.bench_cold_path [--samples 4096] [--files 2] [--image-size 224]
        [--batch 128] [--dir DIR] [--out PATH] [--device cpu]

``--dir`` must be on a disk-backed file system (default: the temporary
directory). Prints one JSON line (the JAX record's keys where they apply,
``conversion`` and ``device``: the card's name and power limit).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional

import torch

N_CAMERAS = 18  # rows per frame of a synthetic subject


def fs_type(path: str) -> str:
    """File system type of the mount holding ``path`` (the longest mount
    point of ``/proc/mounts`` that prefixes it; '' if unreadable)."""
    path = os.path.realpath(path)
    best, best_type = "", ""
    try:
        with open("/proc/mounts") as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 3:
                    mnt = parts[1]
                    if (path == mnt or path.startswith(mnt.rstrip("/") + "/")) and len(mnt) > len(best):
                        best, best_type = mnt, parts[2]
    except OSError:
        pass
    return best_type


def evict(paths: List[str]) -> bool:
    """Ask the kernel to drop ``paths``' pages from the page cache (each
    file synced first); False where ``posix_fadvise`` is missing."""
    if not hasattr(os, "posix_fadvise"):
        return False
    for p in paths:
        fd = os.open(p, os.O_RDONLY)
        try:
            os.fsync(fd)
            os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
        finally:
            os.close(fd)
    return True


def epoch_rate(paths: List[str], batch: int, device: torch.device) -> tuple:
    """One pass over every row of every pack: (stereo samples/s, samples,
    seconds)."""
    from rot_mvgaze_tpu_torch.bench_loader_scaling import RandomPairs, consume
    from rot_mvgaze_tpu_torch.data.native import NativeBatchLoader, NativePool

    pool = NativePool(paths, n_threads=1)
    loader = NativeBatchLoader(RandomPairs(pool), batch_size=batch, shuffle=True, seed=0)
    done = 0
    t0 = time.perf_counter()
    for b in loader:
        done += consume(b, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    del loader, pool
    return done / dt, done, dt


def h5py_missing() -> Optional[str]:
    """None where ``h5py`` imports, else why not."""
    try:
        import h5py  # noqa: F401
    except ImportError as e:
        return f"h5py does not import here ({e}); the packs were written from the same rows by pack_rows"
    return None


def run(samples: int = 4096, files: int = 2, image_size: int = 224, batch: int = 128,
        work_dir: Optional[str] = None, device: str = "cuda", log=None) -> Dict[str, Any]:
    from rot_mvgaze_tpu_torch.data.packed import pack_hdf5, pack_rows
    from rot_mvgaze_tpu_torch.data.synthetic import synthetic_rows, write_synthetic_h5
    from rot_mvgaze_tpu_torch.utils.device import resolve_device
    from rot_mvgaze_tpu_torch.utils.drivers import card_of

    dev = resolve_device(device)
    work_dir = work_dir or tempfile.gettempdir()
    fstype = fs_type(work_dir)
    if fstype in ("tmpfs", "ramfs"):
        raise SystemExit(f"--dir {work_dir} is {fstype}: its pages cannot be evicted, so a cold epoch "
                         "there would read memory; pass a directory on a disk-backed file system")
    frames = -(-samples // N_CAMERAS)
    n_rows = frames * N_CAMERAS
    s = image_size
    bytes_per_row = 2 * (s * s * 3 + 16)  # a stereo gather reads 2 rows
    record: Dict[str, Any] = {"samples_per_file": samples, "files": files, "image_size": s,
                              "rows_per_file": n_rows, "cpu_count": os.cpu_count(), "fs_type": fstype}
    work = tempfile.mkdtemp(prefix="cold_path_", dir=work_dir)
    try:
        missing = h5py_missing()
        packs = []
        if missing is None:
            archives = [write_synthetic_h5(os.path.join(work, f"s{i:02d}.h5"), n_frames=frames,
                                           image_size=s, seed=i) for i in range(files)]
            evict(archives)
            t0 = time.perf_counter()
            packs = [pack_hdf5(p, p + ".rmgpack") for p in archives]  # each fsynced by write_pack
            dt = time.perf_counter() - t0
            total_mb = sum(os.path.getsize(p) for p in packs) / 1e6
            record["conversion"] = {"rows_per_sec": n_rows * files / dt, "mb_per_sec": total_mb / dt,
                                    "total_rows": n_rows * files, "source_evicted": True}
        else:
            for i in range(files):
                imgs, gaze, pose = synthetic_rows(frames, N_CAMERAS, s, i, False)
                packs.append(pack_rows(os.path.join(work, f"s{i:02d}.rmgpack"), imgs, gaze, pose))
            record["conversion"] = None
            record["conversion_reason"] = missing
        record["page_cache_evicted"] = evict(packs)
        record["eviction"] = "os.posix_fadvise(POSIX_FADV_DONTNEED) per pack, after fsync"
        cold = epoch_rate(packs, batch, dev)
        hot = epoch_rate(packs, batch, dev)
        record.update({
            "cold_epoch_samples_per_sec": cold[0], "hot_epoch_samples_per_sec": hot[0],
            "cold_epoch_mb_per_sec": cold[0] * bytes_per_row / 1e6,
            "hot_epoch_mb_per_sec": hot[0] * bytes_per_row / 1e6,
            "epoch_samples": cold[1], "device": card_of(dev),
        })
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if log is not None:
        log(f"cold path: cold epoch {record['cold_epoch_samples_per_sec']:.1f} samples/s, hot "
            f"{record['hot_epoch_samples_per_sec']:.1f}")
    return record


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--samples", type=int, default=4096, help="rows per synthetic subject archive")
    ap.add_argument("--files", type=int, default=2)
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--dir", default=None, help="a directory on a disk-backed file system (default: the "
                                                "temporary directory)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="where the batches are copied: cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    record = run(args.samples, args.files, args.image_size, args.batch, args.dir, args.device,
                 log=lambda msg: print(msg, file=sys.stderr, flush=True))
    print(json.dumps(record), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=2)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
