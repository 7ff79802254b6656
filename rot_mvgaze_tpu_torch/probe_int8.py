"""Does an int8 GEMM beat bf16 on the card at R50's shapes? (port of
``scripts/probe_int8.py``).

Times bf16 against int8 with int32 accumulation on R50's three stride-1 3x3
conv shapes at 128 images and on a 4096x2048 . 2048x2048 product. The int8
side is the port's own route, ``ops/quant.py``: ``int8_conv_accumulate``
(im2col, then ``int8_matmul``: ``torch._int_mm``, cuBLASLt on the int8
tensor cores; a float64 product on the CPU) and ``int8_matmul``; the bf16
side is cuDNN's conv and cuBLAS's product. The int8 GEMM replaces XLA work
in the JAX package, not a Pallas kernel.

Each case is a chain of 100 data-dependent iterations per call (int8: the
int32 sums shifted right by 8 and clipped back to int8; bf16: scaled by the
weights' gain so the magnitude holds), 1 warm-up call and 3 timed calls
between CUDA events, reported in ms per iteration and as a share of the
H100 SXM's published dense peaks, 1,979 TOP/s int8 and 989 TFLOP/s bf16 (at
its 700 W limit; ``device`` gives the card's own)::

    python -m rot_mvgaze_tpu_torch.probe_int8 [--device cpu]

One JSON line per case: ``case``, ``bf16_ms_per_iter``,
``int8_ms_per_iter``, ``bf16_tflops``, ``int8_tops``,
``bf16_share_of_peak``, ``int8_share_of_peak`` (null on the CPU), ``speedup`` (bf16 time over
int8 time) and ``device`` (the card's name and power limit).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

#: the H100 SXM's published dense tensor-core peaks, operations per second
PEAK_INT8_OPS = 1979e12
PEAK_BF16_FLOPS = 989e12

#: (name, x NHWC, w HWIO) as the JAX script names them
CONV_CASES = [
    ("conv 128x56x56x64 3x3x64x64", (128, 56, 56, 64), (3, 3, 64, 64)),
    ("conv 128x28x28x128 3x3x128x128", (128, 28, 28, 128), (3, 3, 128, 128)),
    ("conv 128x14x14x256 3x3x256x256", (128, 14, 14, 256), (3, 3, 256, 256)),
]
DOT_CASES = [("dot 4096x2048 x 2048x2048", (4096, 2048), (2048, 2048))]


def requantize(y: torch.Tensor) -> torch.Tensor:
    """int32 sums back to int8: ``clip(y >> 8, -127, 127)`` (an arithmetic
    shift), as the JAX chain does."""
    return torch.clamp(torch.bitwise_right_shift(y, 8), -127, 127).to(torch.int8)


def int8_conv_chain(x8: torch.Tensor, w8: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` chained 3x3 'same' int8 convs of NCHW ``x8`` by (O, C, 3, 3)
    ``w8`` through ``ops.quant.int8_conv_accumulate``, each requantized."""
    from rot_mvgaze_tpu_torch.ops.quant import int8_conv_accumulate

    for _ in range(n):
        x8 = requantize(int8_conv_accumulate(x8, w8, 1, 1))
    return x8


def int8_dot_chain(a8: torch.Tensor, b8: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` chained int8 products ``a8 @ b8`` through
    ``ops.quant.int8_matmul``, each requantized."""
    from rot_mvgaze_tpu_torch.ops.quant import int8_matmul

    for _ in range(n):
        a8 = requantize(int8_matmul(a8, b8))
    return a8


def _unit_rms(x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    return (xf * torch.rsqrt((xf ** 2).mean() + 1e-12)).to(x.dtype)


def bf16_conv_chain(x: torch.Tensor, w: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` chained bf16 3x3 'same' convs, each scaled by the filter's
    inverse gain so the carry's magnitude holds (the carry is set to unit
    RMS on entry)."""
    inv_gain = torch.rsqrt((w.float() ** 2).sum() / w.shape[0]).to(x.dtype)
    x = _unit_rms(x)
    for _ in range(n):
        x = F.conv2d(x, w, padding=1) * inv_gain
    return x


def bf16_dot_chain(a: torch.Tensor, b: torch.Tensor, n: int) -> torch.Tensor:
    inv_gain = torch.rsqrt((b.float() ** 2).sum() / b.shape[-1]).to(a.dtype)
    a = _unit_rms(a)
    for _ in range(n):
        a = (a @ b) * inv_gain
    return a


def time_chain(fn: Callable, x: torch.Tensor, w: torch.Tensor, iters: int, reps: int,
               device: torch.device) -> float:
    """ms per iteration over ``reps`` calls of ``iters`` iterations, after
    one warm-up call; CUDA events on the card, the host clock on the CPU."""
    x = fn(x, w, iters)
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        for _ in range(reps):
            x = fn(x, w, iters)
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / (reps * iters)
    t0 = time.perf_counter()
    for _ in range(reps):
        x = fn(x, w, iters)
    return (time.perf_counter() - t0) * 1e3 / (reps * iters)


def conv_operands(rng: np.random.Generator, xs, ws, device) -> tuple:
    """(x8, w8, xb, wb): int8 and bf16 operands of a conv case, NCHW (as a
    channels_last view of the NHWC draw) and (O, C, kh, kw)."""
    def nchw(a):
        return torch.from_numpy(a).to(device).permute(0, 3, 1, 2)

    def oihw(a):
        return torch.from_numpy(a).to(device).permute(3, 2, 0, 1).contiguous()

    x8 = nchw(rng.integers(-127, 127, xs, dtype=np.int8))
    w8 = oihw(rng.integers(-127, 127, ws, dtype=np.int8))
    xb = nchw(rng.standard_normal(xs).astype(np.float32)).to(torch.bfloat16)
    wb = oihw(rng.standard_normal(ws).astype(np.float32)).to(torch.bfloat16)
    return x8, w8, xb, wb


def run(iters: int = 100, reps: int = 3, device: str = "cuda", log=None) -> List[Dict[str, Any]]:
    from rot_mvgaze_tpu_torch.utils.device import resolve_device
    from rot_mvgaze_tpu_torch.utils.drivers import card_of

    dev = resolve_device(device)
    card = card_of(dev)
    rng = np.random.default_rng(0)
    records = []

    def record(name, ops, tb, t8):
        on_card = dev.type == "cuda"  # the peaks are the card's
        rec = {"case": name, "bf16_ms_per_iter": tb, "int8_ms_per_iter": t8,
               "bf16_tflops": ops / tb / 1e9, "int8_tops": ops / t8 / 1e9,
               "bf16_share_of_peak": ops / tb * 1e3 / PEAK_BF16_FLOPS if on_card else None,
               "int8_share_of_peak": ops / t8 * 1e3 / PEAK_INT8_OPS if on_card else None,
               "speedup": tb / t8, "device": card}
        records.append(rec)
        if log is not None:
            log(json.dumps(rec))

    for name, xs, ws in CONV_CASES:
        x8, w8, xb, wb = conv_operands(rng, xs, ws, dev)
        tb = time_chain(bf16_conv_chain, xb, wb, iters, reps, dev)
        t8 = time_chain(int8_conv_chain, x8, w8, iters, reps, dev)
        record(name, 2 * int(np.prod(xs)) * ws[0] * ws[1] * ws[3], tb, t8)
    for name, ashape, bshape in DOT_CASES:
        a8 = torch.from_numpy(rng.integers(-127, 127, ashape, dtype=np.int8)).to(dev)
        b8 = torch.from_numpy(rng.integers(-127, 127, bshape, dtype=np.int8)).to(dev)
        ab = torch.from_numpy(rng.standard_normal(ashape).astype(np.float32)).to(dev, torch.bfloat16)
        bb = torch.from_numpy(rng.standard_normal(bshape).astype(np.float32)).to(dev, torch.bfloat16)
        tb = time_chain(bf16_dot_chain, ab, bb, iters, reps, dev)
        t8 = time_chain(int8_dot_chain, a8, b8, iters, reps, dev)
        record(name, 2 * ashape[0] * ashape[1] * bshape[1], tb, t8)
    return records


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    run(device=args.device, log=lambda line: print(line, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
