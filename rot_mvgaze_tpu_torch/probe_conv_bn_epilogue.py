"""Probe: does a 3x3 convolution with the BatchNorm statistics in its
epilogue beat the convolution plus a separate statistics pass?

    python -m rot_mvgaze_tpu_torch.probe_conv_bn_epilogue [--device cuda|cpu]

The port's counterpart of ``scripts/probe_conv_bn_epilogue.py``. At R50
layer 3's 3x3 shape at a training batch (``PROBE_BATCH`` images of
``PROBE_HW`` x ``PROBE_HW`` x ``PROBE_C`` NHWC bf16; defaults 256, 14, 256)
it times, over ``PROBE_STEPS`` calls each (default 50):

  a) the library convolution alone: ``F.conv2d`` in bf16 on the NCHW view
     with channels_last strides, as ``models/resnet.py`` runs its
     convolutions;
  b) the same convolution plus a separate per-channel statistics pass over
     its output (``torch.batch_norm_stats``, the pass a train-mode
     BatchNorm runs on the card; float32 sums on the CPU);
  c) the kernel, ``ops.conv_bn.conv3x3_bn_stats`` (one pass);

and prints one JSON line: the kernel's deltas against its plain version,
the times, the kernel's bound (operations at 989 TFLOP/s bf16 or bytes at
3.35 TB/s, whichever is larger) and the verdict, ``lever_real`` if (c) is
faster than (b), else ``falsified``. Every variant is checked against the
plain version before it is timed, and a miss raises. The library calls are
the yardstick only; the port never calls them.

On the card, times are CUDA events around the calls, and the inputs rotate
through enough copies (twice the L2 cache) that each call reads x from
device memory. ``--device cpu`` runs the same steps with the host clock, for
a test of the record; its times are CPU times, not the card's.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from typing import Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F

from rot_mvgaze_tpu_torch.ops import conv_bn

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
# Bars of the JAX suite (tests/test_conv_bn.py): out atol 3e-2, stats rtol
# 5e-3 / atol 1.0
OUT_ATOL, STATS_RTOL, STATS_ATOL = 3e-2, 5e-3, 1.0
_EPS = 1e-5  # batch_norm_stats' eps; undone when its result is checked


def bound(batch: int, hw: int, c: int, cout: int, itemsize: int = 2) -> Dict[str, object]:
    """The least time the card could take for one call: the larger of the
    convolution's operations (2·M·9C·Cout) at the bf16 tensor-core peak and
    its bytes (x, w and out once each, stats in f32) at the memory rate."""
    m = batch * hw * hw
    ops = 2 * m * 9 * c * cout
    nbytes = itemsize * (m * c + 9 * c * cout + m * cout) + 4 * 2 * cout
    t_ops, t_bytes = ops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": ops, "bytes": nbytes}


def _stats_pass(o: torch.Tensor):
    """The separate statistics pass over the library convolution's output
    ``o`` (NCHW, channels_last): on the card ``torch.batch_norm_stats``, the
    one-pass (mean, invstd) that a train-mode BatchNorm runs; on the CPU,
    which has no such op, float32 (sum, sum of squares)."""
    if o.is_cuda:
        return torch.batch_norm_stats(o, _EPS)
    of = o.float()
    return of.sum((0, 2, 3)), (of * of).sum((0, 2, 3))


def _as_sums(o: torch.Tensor, result) -> torch.Tensor:
    """:func:`_stats_pass`'s result as (2, Cout) float32 (sum, sum of squares)."""
    if not o.is_cuda:
        return torch.stack(result)
    n = o.numel() // o.shape[1]
    mean, invstd = (t.double() for t in result)
    var = 1.0 / (invstd * invstd) - _EPS
    return torch.stack([mean * n, (var + mean * mean) * n]).float()


def _timer(device: torch.device, steps: int):
    """ms per call of fn(i), i = 0..steps-1, after 3 warm-up calls: CUDA
    events on the card, the host clock on the CPU."""

    def timed(fn: Callable[[int], object]) -> float:
        for i in range(3):
            fn(i)
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(device)
            start.record()
            for i in range(steps):
                fn(i)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / steps
        t0 = time.perf_counter()
        for i in range(steps):
            fn(i)
        return (time.perf_counter() - t0) * 1e3 / steps

    return timed


def _check(name: str, got: torch.Tensor, want: torch.Tensor, atol: float, rtol: float) -> None:
    try:
        torch.testing.assert_close(got, want, atol=atol, rtol=rtol)
    except AssertionError as e:
        raise RuntimeError(f"probe: {name} misses its bar (atol {atol}, rtol {rtol}): {e}") from e


def run_probe(batch: int = 256, hw: int = 14, c: int = 256, steps: int = 50,
              device: str = "cuda") -> Dict[str, object]:
    """Check, time and judge the three variants at (batch, hw, hw, c) ->
    c, bf16; returns the record printed by the module."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("probe: no CUDA card; pass device='cpu' for a CPU run")
    rng = np.random.default_rng(0)
    # x standard normal, w scaled by 1/sqrt(9C): |out| stays near 1, where a
    # bf16 output is within 2^-6 of its f32 accumulator
    x0 = torch.from_numpy(rng.standard_normal((batch, hw, hw, c), dtype=np.float32))
    w0 = torch.from_numpy((rng.standard_normal((3, 3, c, c), dtype=np.float32) / np.sqrt(9 * c)))
    x = x0.to(dev, torch.bfloat16)
    w = w0.to(dev, torch.bfloat16)
    w_oihw = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)

    # copies of x in rotation, so that on the card each call reads x from
    # device memory and not from the L2 cache
    copies = 1
    if dev.type == "cuda":
        l2 = torch.cuda.get_device_properties(dev).L2_cache_size
        copies = max(2, math.ceil(2 * l2 / (x.numel() * x.element_size())) + 1)
    xs = [x] + [x.clone() for _ in range(copies - 1)]
    xs_nchw = [t.permute(0, 3, 1, 2) for t in xs]  # channels_last views, no copy

    # --- correctness first, one call each, against the plain version
    acc, plain_stats = conv_bn.conv3x3_bn_stats_plain(x.float(), w)  # f32 accumulator
    out, stats = conv_bn.conv3x3_bn_stats(x, w)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    _check("kernel out", out.float(), acc, OUT_ATOL, 0.0)
    _check("kernel stats", stats, plain_stats, STATS_ATOL, STATS_RTOL)
    lib = F.conv2d(xs_nchw[0], w_oihw, padding=1)
    _check("library conv", lib.permute(0, 2, 3, 1).float(), acc, OUT_ATOL, 0.0)
    # the two-pass pipeline's stats are of the rounded output: held to the
    # plain version's rounded output, summed in f64
    rounded = acc.to(torch.bfloat16).double().reshape(-1, c)
    want_rounded = torch.stack([rounded.sum(0), (rounded * rounded).sum(0)]).float()
    _check("library stats", _as_sums(lib, _stats_pass(lib)), want_rounded, STATS_ATOL, STATS_RTOL)
    record: Dict[str, object] = {
        "B": batch, "HW": hw, "C": c, "n_steps": steps, "device": device,
        "device_name": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "x_copies": copies,
        "out_max_abs_diff": float((out.float() - acc).abs().max()),
        "stats_max_rel_diff": float(((stats - plain_stats).abs() / (plain_stats.abs() + 1e-3)).max()),
        "stats_max_abs_diff": float((stats - plain_stats).abs().max()),
    }
    del acc, rounded, lib

    # --- timings, in turns: library, library + stats, kernel, then back
    timed = _timer(dev, steps)
    n = len(xs)
    variants = {
        "library_conv_ms": lambda i: F.conv2d(xs_nchw[i % n], w_oihw, padding=1),
        "library_conv_plus_stats_ms": lambda i: _stats_pass(F.conv2d(xs_nchw[i % n], w_oihw, padding=1)),
        "kernel_ms": lambda i: conv_bn.conv3x3_bn_stats(xs[i % n], w),
    }
    times = {k: [] for k in variants}
    for key in list(variants) + list(variants)[::-1]:
        times[key].append(timed(variants[key]))
    for key, ts in times.items():
        record[key] = min(ts)
        record[key.replace("_ms", "_ms_runs")] = ts
    plain_steps = max(1, steps // 5)  # the plain version is slow; fewer calls
    record["plain_ms"] = _timer(dev, plain_steps)(lambda i: conv_bn.conv3x3_bn_stats_plain(xs[i % n], w))
    record.update(bound(batch, hw, c, c))
    record["verdict"] = (
        "lever_real" if record["kernel_ms"] < record["library_conv_plus_stats_ms"] else "falsified"
    )
    return record


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    env = os.environ
    record = run_probe(
        batch=int(env.get("PROBE_BATCH", "256")), hw=int(env.get("PROBE_HW", "14")),
        c=int(env.get("PROBE_C", "256")), steps=int(env.get("PROBE_STEPS", "50")),
        device=args.device,
    )
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
