"""Eval-forward throughput and serving latency through ``GazePredictor`` on the
card (port of ``scripts/bench_eval.py``).

R50 x 3 iterations, seeded random weights saved as a reference-format
checkpoint and loaded by ``serving.GazePredictor`` (bf16 compute, float32
BatchNorm, as the predictor serves):

- throughput: the predictor's forward (preprocessing, backbone, heads) on
  a batch of ``BENCH_BATCH`` pairs already on the device, 3 warm-up calls,
  then 30 timed calls between two ``torch.cuda.synchronize()`` calls;
- latency: ``predict`` on ``SERVE_BATCH`` pairs of numpy images (host to
  host, the micro-batch set to ``SERVE_BATCH``), 3 warm-up requests, then
  the p50 and p99 of 50.

``BENCH_INT8=1`` serves the backbone's convs in int8 with dynamic
activation scales, ``BENCH_INT8=static`` with static scales calibrated on
the throughput batch first (``ops/quant.py``, ``models/resnet.py::
QuantConv2d``). ``BENCH_NUM_VIEWS=V`` (> 2) serves
``MultiViewGazePredictor`` on (N, V, H, W, 3) requests, V images per
sample::

    python -m rot_mvgaze_tpu_torch.bench_eval [--device cpu]

The JAX script chains each call's input on the previous output to defeat
its remote backend's short-circuiting; the card needs no such chain, and
CUDA synchronisation fences the timing. Prints one JSON line:
``eval_imgs_per_sec``, ``serving_p50_ms``, ``serving_p99_ms``,
``serving_batch``, ``int8``, ``num_views`` and ``device`` (the card's name
and power limit).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

INT8_SETTINGS = {"0": False, "1": True, "static": "static"}


def read_settings(env: Mapping[str, str] = os.environ) -> Dict[str, Any]:
    raw = env.get("BENCH_INT8", "0")
    if raw not in INT8_SETTINGS:
        raise SystemExit(f"BENCH_INT8 must be 0, 1, or static; got {raw!r}")
    num_views = int(env.get("BENCH_NUM_VIEWS", "2"))
    if num_views < 2:
        raise SystemExit(f"BENCH_NUM_VIEWS must be >= 2; got {num_views}")
    return {
        "batch": int(env.get("BENCH_BATCH", "128")),
        "serve_batch": int(env.get("SERVE_BATCH", "8")),
        "int8": INT8_SETTINGS[raw],
        "num_views": num_views,
        "size": 224,
        "depth": 50,
    }


def seeded_checkpoint(path: str, num_views: int = 2, backbone_depth: int = 50, num_iter: int = 3,
                      seed: int = 0) -> str:
    """Seeded random weights of the stereo (or, V > 2, V-view) model saved as
    a reference-format state dict."""
    from rot_mvgaze_tpu_torch.models import FeatRotationMultiView, FeatRotationSymm

    torch.manual_seed(seed)
    cls = FeatRotationMultiView if num_views > 2 else FeatRotationSymm
    torch.save(cls(backbone_depth=backbone_depth, num_iter=num_iter).state_dict(), path)
    return path


def make_request(rng: np.random.Generator, n: int, size: int, num_views: int) -> tuple:
    """A request in ``predict``'s positional order: uint8 views and head
    poses."""
    if num_views > 2:
        return (rng.integers(0, 256, (n, num_views, size, size, 3), dtype=np.uint8),
                rng.uniform(-0.8, 0.8, (n, num_views, 2)).astype(np.float32))
    return (rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8),
            rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8),
            rng.uniform(-0.8, 0.8, (n, 2)).astype(np.float32),
            rng.uniform(-0.8, 0.8, (n, 2)).astype(np.float32))


def build_predictor(ckpt: str, settings: Dict[str, Any], device: Any, micro_batch: int):
    from rot_mvgaze_tpu_torch.serving import GazePredictor, MultiViewGazePredictor

    common = dict(backbone_depth=settings["depth"], num_iter=3, micro_batch=micro_batch,
                  image_size=settings["size"], dtype=torch.bfloat16, int8=settings["int8"], device=device)
    if settings["num_views"] > 2:
        return MultiViewGazePredictor(ckpt, settings["num_views"], **common)
    return GazePredictor(ckpt, **common)


def device_forward(pred, request: tuple):
    """``() -> pred_gaze``: the predictor's serving forward on ``request``
    staged on its device once."""
    from rot_mvgaze_tpu_torch.serving import make_multiview_serving_forward, make_serving_forward

    tensors = tuple(torch.from_numpy(a).to(pred.device) for a in request)
    if len(request) == 2:
        forward = make_multiview_serving_forward(pred.model, pred.image_size)
    else:
        forward = make_serving_forward(pred.model, pred.image_size)

    @torch.inference_mode()
    def call():
        return forward(None, *tensors)

    return call


def run(settings: Dict[str, Any], device: str = "cuda", n_steps: int = 30, n_latency: int = 50,
        log=None) -> Dict[str, Any]:
    """The benchmark: returns ``{"record", "forwards"}``, ``forwards`` the
    model forwards it ran (warm-ups, timed calls, requests and, under static
    int8, the calibration pass)."""
    from rot_mvgaze_tpu_torch.utils.device import resolve_device
    from rot_mvgaze_tpu_torch.utils.drivers import card_of

    dev = resolve_device(device)
    s = settings
    views = s["num_views"]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory(prefix="bench_eval_") as tmp:
        ckpt = seeded_checkpoint(os.path.join(tmp, "seeded.pth.tar"), views, s["depth"])
        pred = build_predictor(ckpt, s, dev, micro_batch=s["batch"])
    big = make_request(rng, s["batch"], s["size"], views)
    forwards = 0
    if s["int8"] == "static":
        pred.calibrate(*big)  # one calibration pass before the timing, as the JAX script
        forwards += 1
    forward = device_forward(pred, big)
    for _ in range(3):
        out = forward()
    sync()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        out = forward()
    sync()
    dt = time.perf_counter() - t0
    if not torch.isfinite(out).all():
        raise RuntimeError("non-finite eval predictions")
    forwards += 3 + n_steps
    eval_ips = views * s["batch"] * n_steps / dt

    pred.micro_batch = s["serve_batch"]
    small = make_request(rng, s["serve_batch"], s["size"], views)
    for _ in range(3):
        pred.predict(*small)
    lat = []
    for _ in range(n_latency):
        t0 = time.perf_counter()
        pred.predict(*small)
        lat.append((time.perf_counter() - t0) * 1e3)
    forwards += 3 + n_latency
    record = {
        "eval_imgs_per_sec": eval_ips,
        "serving_p50_ms": float(np.percentile(lat, 50)),
        "serving_p99_ms": float(np.percentile(lat, 99)),
        "serving_batch": s["serve_batch"],
        "int8": s["int8"],
        "num_views": views,
        "device": card_of(dev),
    }
    if log is not None:
        log(f"bench_eval (int8={s['int8']}, V={views}): {eval_ips:.1f} images/s at {s['batch']}, "
            f"p50 {record['serving_p50_ms']:.2f} ms at {s['serve_batch']}")
    return {"record": record, "forwards": forwards}


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    out = run(read_settings(), args.device, log=lambda msg: print(msg, file=sys.stderr, flush=True))
    print(json.dumps(out["record"]), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
