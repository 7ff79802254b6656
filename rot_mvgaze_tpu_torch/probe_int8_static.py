"""End-to-end int8 eval throughput with the activation scale fixed (port of
``scripts/probe_int8_static.py``).

A dynamic activation scale costs one abs-max reduction per conv input. This
probe replaces ``ops.quant.quantize_symmetric``, for the run only, by one
that gives every 4-D activation the fixed scale 8/127 (weights keep their
per-channel scales), then serves R50 x 3 in int8 through
``serving.GazePredictor(int8=True)`` at ``BENCH_BATCH`` pairs: numerically
wrong, but its throughput is what a path with frozen scales reaches. The
original function is restored afterwards, whatever happens::

    python -m rot_mvgaze_tpu_torch.probe_int8_static [--device cpu]

Seeded random weights; the throughput is ``bench_eval``'s (the predictor's
forward on a batch staged on the device, 3 warm-up calls, then 30
timed calls between two ``torch.cuda.synchronize()`` calls). Prints one
JSON line: ``static_scale_int8_eval_imgs_per_sec``, ``act_scale``,
``batch`` and ``device`` (the card's name and power limit).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

FIXED_SCALE = 8.0 / 127.0


@contextlib.contextmanager
def fixed_activation_scale(scale: float = FIXED_SCALE) -> Iterator[None]:
    """``ops.quant.quantize_symmetric`` with every 4-D per-tensor input (an
    activation) quantized at ``scale``; restored on exit."""
    from rot_mvgaze_tpu_torch.ops import quant

    orig = quant.quantize_symmetric

    def fixed(x: torch.Tensor, reduce_dims=None):
        if reduce_dims is None and x.dim() == 4:
            s = torch.tensor(scale, dtype=torch.float32, device=x.device)
            return quant.quantize_with_scale(x, s), s
        return orig(x, reduce_dims)

    quant.quantize_symmetric = fixed
    try:
        yield
    finally:
        quant.quantize_symmetric = orig


def run(batch: int = 128, steps: int = 30, device: str = "cuda", size: int = 224, depth: int = 50,
        log=None) -> Dict[str, Any]:
    """The probe: returns ``{"record", "forwards"}``."""
    from rot_mvgaze_tpu_torch.bench_eval import build_predictor, device_forward, make_request, seeded_checkpoint
    from rot_mvgaze_tpu_torch.utils.device import resolve_device
    from rot_mvgaze_tpu_torch.utils.drivers import card_of

    dev = resolve_device(device)
    settings = {"depth": depth, "size": size, "int8": True, "num_views": 2}
    with tempfile.TemporaryDirectory(prefix="probe_int8_static_") as tmp:
        pred = build_predictor(seeded_checkpoint(os.path.join(tmp, "seeded.pth.tar"), 2, depth), settings, dev,
                               micro_batch=batch)
    forward = device_forward(pred, make_request(np.random.default_rng(0), batch, size, 2))
    with fixed_activation_scale():
        for _ in range(3):
            out = forward()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(steps):
            out = forward()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
    if not torch.isfinite(out).all():
        raise RuntimeError("non-finite predictions")
    record = {"static_scale_int8_eval_imgs_per_sec": 2 * batch * steps / dt, "act_scale": FIXED_SCALE,
              "batch": batch, "device": card_of(dev)}
    if log is not None:
        log(f"static-scale int8 eval: {record['static_scale_int8_eval_imgs_per_sec']:.1f} images/s")
    return {"record": record, "forwards": 3 + steps}


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    out = run(int(os.environ.get("BENCH_BATCH", "128")), device=args.device,
              log=lambda msg: print(msg, file=sys.stderr, flush=True))
    print(json.dumps(out["record"]), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
