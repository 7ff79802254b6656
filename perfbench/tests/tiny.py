"""A copy of the benchmark with two tiny cells added by files and manifest
entries alone (the serving one with the serving metrics, which no cell of
the benchmark lists yet), for the CPU tests: the published widths at 32x32 images, 4 pairs per step, 4
clients over a pool of 12 frames, in float32, where the sound path and the
controls stand apart on the CPU (bf16 round-off at 32x32 and 4 pairs
swamps them). The tiny cells' limits are set from CPU readings of the sound
path, the faults and the controls at this size (``TINY_LIMITS``), not from
the card's."""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Dict

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TINY_LIMITS = {
    # sound float32 readings at this size (7 seeds): loss_gap <= 1e-6, grad_gap_median <= 6.3e-5,
    # change_gap <= 2.6e-3, pred_gap_mean_deg 1.5e-4 (one seed); the float8 control >= 0.0127, 0.044,
    # 0.056, the int8 control 0.022, 0.096, 0.060, 2.09 deg; unchanged 1.0; half batch >= 0.074
    "tiny_train": {"loss_gap": 1e-4, "pred_gap_mean_deg": 0.01, "grad_gap_median": 1e-3, "change_gap": 0.02},
    # sound <= 8.1e-5 deg (widest); int8 >= 1.93 (widest), >= 0.94 (mean); one answer moved 2.86
    "tiny_serve": {"answer_gap_p99_deg": 0.01, "answer_gap_mean_deg": 0.01, "answers_over_1deg": 0},
}


# the serving metrics as a serving cell lists them (their readers are in
# perfbench/metrics/; no cell of BENCHMARK.json lists them yet)
SERVE_END_TO_END = [
    {"name": "serve_images_per_s", "unit": "images/s", "better": "higher", "source": "host_clock"},
    {"name": "serve_p95_ms", "unit": "ms", "better": "lower", "source": "host_clock"},
]
SERVE_PER_LAYER = [
    {"name": "rows_per_microbatch.serve", "unit": "frames", "better": "higher", "source": "program_counter",
     "layer": "coalescing, serving.BatchingPredictor", "moves": "serve_images_per_s"},
    {"name": "microbatch_ms.serve", "unit": "ms", "better": "lower", "source": "host_clock",
     "layer": "predictor, serving.MultiViewGazePredictor", "moves": "serve_p95_ms"},
    {"name": "mfu_pct.serve", "unit": "%", "better": "higher", "source": "host_clock",
     "layer": "whole forward", "moves": "serve_images_per_s"},
    {"name": "device_idle_pct.serve", "unit": "%", "better": "lower", "source": "device_trace",
     "layer": "device", "moves": "serve_images_per_s"},
]


def _write(path: str, data: Dict) -> None:
    with open(path, "w") as f:
        json.dump(data, f, indent=1)


def _read(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def digests(root: str) -> Dict[str, str]:
    """sha256 of every file of the benchmark under ``root``."""
    out = {}
    for base in ("perfbench", "BENCHMARK.json"):
        top = os.path.join(root, base)
        paths = [top] if os.path.isfile(top) else [os.path.join(d, f) for d, _, fs in os.walk(top) for f in fs]
        for p in paths:
            if "__pycache__" not in p:
                with open(p, "rb") as f:
                    out[os.path.relpath(p, root)] = hashlib.sha256(f.read()).hexdigest()
    return out


def make_root(dest: str) -> str:
    """Copy the benchmark to ``dest`` and add the tiny cells: new files and
    new entries only. Returns ``dest``."""
    shutil.copytree(os.path.join(REPO, "perfbench"), os.path.join(dest, "perfbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), dest)
    pb = os.path.join(dest, "perfbench")
    for base, name in (("rotmv_r50_stereo", "tiny_stereo"), ("rotmv_r50_mv3", "tiny_mv3")):
        cfg = _read(os.path.join(pb, "configs", f"{base}.json"))
        cfg["name"] = name
        cfg["model"]["image_size"] = 32
        cfg["model"]["dtype"] = "float32"
        _write(os.path.join(pb, "configs", f"{name}.json"), cfg)
    train = dict(_read(os.path.join(pb, "traffic", "train_b512.json")), pairs=4, distinct_batches=3, warmup_steps=1)
    _write(os.path.join(pb, "traffic", "tiny_train.json"), train)
    serve = dict(_read(os.path.join(pb, "traffic", "serve_cams64.json")), clients=4, frames_per_request=1,
                 frames=12, micro_batch=4, warmup_seconds=0.2)
    _write(os.path.join(pb, "traffic", "tiny_serve.json"), serve)
    for cell, limits in TINY_LIMITS.items():
        _write(os.path.join(pb, "checks", f"{cell}.json"),
               {"numbers": {k: {"limit": v} for k, v in limits.items()}})
    manifest = _read(os.path.join(dest, "BENCHMARK.json"))
    manifest["configs"] += [
        {"name": "tiny_stereo", "source": "https://arxiv.org/abs/2305.12704", "file": "perfbench/configs/tiny_stereo.json",
         "reduced": ["image_size"], "why": "CPU test size"},
        {"name": "tiny_mv3", "source": "https://arxiv.org/abs/2305.12704", "file": "perfbench/configs/tiny_mv3.json",
         "reduced": ["image_size"], "why": "CPU test size"}]
    manifest["workloads"] += [
        {"name": "tiny_train", "config": "tiny_stereo", "traffic": "tiny_train", "chips": 1, "why": "CPU test"},
        {"name": "tiny_serve", "config": "tiny_mv3", "traffic": "tiny_serve", "chips": 1, "why": "CPU test"}]
    for metric in manifest["end_to_end"] + manifest["per_layer"]:
        listed = metric.get("workloads", [])
        if "train_r50_stereo_b512" in listed:
            listed.append("tiny_train")
    manifest["end_to_end"] += [dict(m, workloads=["tiny_serve"]) for m in SERVE_END_TO_END]
    manifest["per_layer"] += [dict(m, workloads=["tiny_serve"]) for m in SERVE_PER_LAYER]
    _write(os.path.join(dest, "BENCHMARK.json"), manifest)
    return dest
