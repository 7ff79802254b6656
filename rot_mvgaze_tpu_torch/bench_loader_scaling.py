"""Can the host feed the card? The packed loader's rate against its thread
count (port of ``scripts/bench_loader_scaling.py``).

Synthetic packs are written by the port's ``data.packed.write_pack`` (4
files of ``--samples`` rows), then read through the port's
``NativeBatchLoader`` over the C++ gather engine
(``rot_mvgaze_tpu_torch/native/loader.cpp``): shuffled stereo batches, two
gathers in flight, the whole Python iteration, and each batch's two image
arrays copied to the device, for each pool thread count of ``--threads``.
The packs are written just before, so their pages are in the page cache:
the measurement is the gather engine and the copy, not a cold disk (see
``bench_cold_path`` for that)::

    python -m rot_mvgaze_tpu_torch.bench_loader_scaling [--threads 1,2,4,8] [--samples 8192]
        [--image-size 224] [--batch 128] [--iter-samples 16384] [--dir DIR] [--out PATH] [--device cpu]

The packs go to a temporary directory under ``--dir`` (the system's
temporary directory by default). One JSON line per thread count
(``n_threads``, ``stereo_samples_per_sec``, ``images_per_sec``,
``gbytes_per_sec``, ``per_thread_rate``, ``timed_samples``, ``wall_s``,
``device``: the card's name and power limit, which the batches were copied
to), then the markdown table.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch


def write_synth_pack(path: str, n: int, size: int, seed: int) -> str:
    """A synthetic pack of ``n`` uint8 ``size``x``size`` rows through
    ``write_pack`` (blocks of 1,024 rows, so memory stays bounded)."""
    from rot_mvgaze_tpu_torch.data.packed import write_pack

    rng = np.random.default_rng(seed)

    def blocks():
        for start in range(0, n, 1024):
            yield rng.integers(0, 256, (min(1024, n - start), size, size, 3), dtype=np.uint8)

    return write_pack(path, n, size, size, 3, blocks(), rng.uniform(-1, 1, (n, 2)).astype(np.float32),
                      rng.uniform(-1, 1, (n, 2)).astype(np.float32))


class RandomPairs:
    """The dataset contract ``NativeBatchLoader`` reads (``pool``,
    ``idx_to_kv``, ``len``): every row of every pack paired with a random
    partner of its own file (a throughput sweep needs no pair index)."""

    def __init__(self, pool: Any) -> None:
        self.pool = pool
        rng = np.random.default_rng(0)
        kv = []
        for fi, (n, _h, _w, _c) in enumerate(pool.shapes):
            partners = rng.integers(0, n, n)
            kv.extend((fi, i, int(partners[i])) for i in range(n))
        self.idx_to_kv = kv

    def __len__(self) -> int:
        return len(self.idx_to_kv)


def consume(batch: Dict[str, np.ndarray], device: torch.device) -> int:
    """Copy a batch's two image arrays to ``device``; returns its rows."""
    for view in ("img_0", "img_1"):
        torch.from_numpy(batch[view]).to(device)
    return len(batch["idx_0"])


def run_point(paths: Sequence[str], n_threads: int, batch: int, n_iter_samples: int,
              device: torch.device) -> tuple:
    """(stereo samples/s, samples timed, seconds) at ``n_threads``, after 4
    warm-up batches."""
    from rot_mvgaze_tpu_torch.data.native import NativeBatchLoader, NativePool

    pool = NativePool(paths, n_threads=n_threads)
    loader = NativeBatchLoader(RandomPairs(pool), batch_size=batch, shuffle=True, seed=0)
    it = iter(loader)
    for _ in range(4):
        consume(next(it), device)
    done = 0
    t0 = time.perf_counter()
    for b in it:
        done += consume(b, device)
        if done >= n_iter_samples:
            break
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    it.close()
    return done / dt, done, dt


def run(threads: List[int], samples: int = 8192, image_size: int = 224, batch: int = 128,
        iter_samples: int = 16384, work_dir: Optional[str] = None, device: str = "cuda",
        log=None) -> List[Dict[str, Any]]:
    from rot_mvgaze_tpu_torch.data.native import NativePool
    from rot_mvgaze_tpu_torch.utils.device import resolve_device
    from rot_mvgaze_tpu_torch.utils.drivers import card_of

    dev = resolve_device(device)
    if not NativePool.available():
        raise SystemExit("native loader unavailable (no g++?)")
    card = card_of(dev)
    bytes_per_stereo = 2 * image_size * image_size * 3
    results = []
    with tempfile.TemporaryDirectory(prefix="loader_scaling_", dir=work_dir) as td:
        paths = [write_synth_pack(os.path.join(td, f"pack{i}.rmg"), samples, image_size, seed=i) for i in range(4)]
        if log is not None:
            log(f"# host cpus={os.cpu_count()} packs=4x{samples} ({4 * samples * bytes_per_stereo / 2 / 1e9:.2f} "
                f"GB in {td}) image={image_size}^2 batch={batch} device={dev}")
        for t in threads:
            rate, done, dt = run_point(paths, t, batch, iter_samples, dev)
            rec = {"n_threads": t, "stereo_samples_per_sec": rate, "images_per_sec": 2 * rate,
                   "gbytes_per_sec": rate * bytes_per_stereo / 1e9, "per_thread_rate": rate / max(t, 1),
                   "timed_samples": done, "wall_s": dt, "device": card}
            results.append(rec)
            if log is not None:
                log(json.dumps(rec))
    return results


def table(results: List[Dict[str, Any]]) -> str:
    """The markdown table of a sweep."""
    lines = ["| threads | stereo samples/s | imgs/s | GB/s | per-thread |", "|---|---|---|---|---|"]
    lines += [f"| {r['n_threads']} | {r['stereo_samples_per_sec']:,.1f} | {r['images_per_sec']:,.1f} | "
              f"{r['gbytes_per_sec']:.2f} | {r['per_thread_rate']:,.1f} |" for r in results]
    return "\n".join(lines)


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--threads", default="1,2,4,8")
    ap.add_argument("--samples", type=int, default=8192, help="synthetic samples per file (x4 files)")
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--iter-samples", type=int, default=16384, help="stereo samples to time per point")
    ap.add_argument("--dir", default=None, help="where the packs go (default: the temporary directory)")
    ap.add_argument("--out", default=None, help="also write the results here as JSON")
    ap.add_argument("--device", default="cuda",
                    help="where the batches are copied: cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    results = run([int(x) for x in args.threads.split(",")], args.samples, args.image_size, args.batch,
                  args.iter_samples, args.dir, args.device, log=lambda line: print(line, flush=True))
    print("\n" + table(results), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"cpus": os.cpu_count(), "results": results}, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
