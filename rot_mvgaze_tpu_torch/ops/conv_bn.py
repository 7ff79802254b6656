"""3x3 convolution with the BatchNorm statistics in its epilogue (port of
``rot_mvgaze_tpu/ops/conv_bn.py``).

A 3x3, stride-1, same-padding NHWC convolution that returns, besides its
output, the per-channel sum and sum of squares of its float32 accumulator:
the statistics a train-mode BatchNorm after the convolution needs, taken
while the output is still on chip instead of in a second pass over it.

:func:`conv3x3_bn_stats` launches the hand-written CUDA kernel in
``csrc/conv_bn.cu`` for a CUDA tensor, counted in ``.launches``, and runs
the plain PyTorch version, :func:`conv3x3_bn_stats_plain`, for a CPU tensor.
It never falls back: a CUDA call launches or raises. Inputs are rounded to
bfloat16 and products accumulate in float32, as the JAX package's
``conv3x3_bn_stats_reference`` computes. Unlike the JAX wrapper there is no
``batch_tile``: the kernel tiles the flattened rows itself and takes any
batch size. Its only caller is the probe,
``python -m rot_mvgaze_tpu_torch.probe_conv_bn_epilogue``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from rot_mvgaze_tpu_torch.kernels.counters import tile_counters

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# must agree with BM/BN/BK in csrc/conv_bn.cu (checked when the library loads)
_BM, _BN, _BK = 128, 64, 32
# split K until about this many blocks per SM exist: at R50 layer 4 (3,136
# rows x 512 channels at 64 images) the output tiles alone give 200 blocks
# for 132 SMs
_BLOCKS_PER_SM = 2


def conv3x3_bn_stats_plain(x: torch.Tensor, w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the 9 shifted products of the JAX kernel's
    body, in float32 on the bfloat16-rounded inputs, zero-padded per image.
    Returns ``(out in x's dtype, stats (2, Cout) float32)``; the statistics
    are the sum and sum of squares over rows of the float32 accumulator,
    summed in float64. With a float32 ``x`` the output is that accumulator
    itself."""
    b, h, wd, c = x.shape
    cout = w.shape[3]
    xb = x.to(torch.bfloat16).to(torch.float32)
    wb = w.to(torch.bfloat16).to(torch.float32)
    xp = F.pad(xb, (0, 0, 1, 1, 1, 1))  # NHWC: C unpadded, W and H by one
    acc = torch.zeros(b * h * wd, cout, dtype=torch.float32, device=x.device)
    for tap in range(9):
        dy, dx = divmod(tap, 3)
        acc += xp[:, dy:dy + h, dx:dx + wd, :].reshape(-1, c) @ wb[dy, dx]
    acc64 = acc.to(torch.float64)
    stats = torch.stack([acc64.sum(0), (acc64 * acc64).sum(0)]).to(torch.float32)
    return acc.reshape(b, h, wd, cout).to(x.dtype), stats


def _check_inputs(x: torch.Tensor, w: torch.Tensor) -> Tuple[int, int, int, int, int]:
    """Validate shapes, dtypes, devices and contiguity; returns (B, H, W, C, Cout)."""
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, C), got {tuple(x.shape)}")
    b, h, wd, c = x.shape
    if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, c):
        raise ValueError(f"w must be (3,3,{c},Cout); got {tuple(w.shape)}")
    if min(b, h, wd, c, w.shape[3]) == 0:
        raise ValueError(f"empty input: x {tuple(x.shape)}, w {tuple(w.shape)}")
    for name, t in (("x", x), ("w", w)):
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous ({name} is NHWC / HWIO)")
    if w.device != x.device:
        raise ValueError(f"x is on {x.device}, w on {w.device}")
    return b, h, wd, c, w.shape[3]


def plan_splits(m: int, n: int, k: int, n_sm: int) -> Tuple[int, int]:
    """Split-K plan ``(k_chunk, splits)`` of the (m, k) x (k, n) implicit GEMM:
    ``k_chunk`` is a multiple of the K tile and ``splits = ceil(k / k_chunk)``
    blocks share each output tile, so that about ``_BLOCKS_PER_SM`` blocks
    per SM exist. On 132 SMs at 64 images: 1 split at layers 1-3, 2 at
    layer 4 (25 x 8 tiles, K = 4,608)."""
    tiles = math.ceil(m / _BM) * math.ceil(n / _BN)
    k_tiles = math.ceil(k / _BK)
    want = max(1, min(k_tiles, math.ceil(_BLOCKS_PER_SM * n_sm / tiles)))
    k_chunk = math.ceil(k_tiles / want) * _BK
    return k_chunk, math.ceil(k / k_chunk)


@functools.cache
def _kernel_fn():
    from rot_mvgaze_tpu_torch.kernels.build import library

    lib = library()
    tiles = [ctypes.c_int() for _ in range(3)]
    lib.mvgaze_conv_bn_tiles.argtypes = [ctypes.POINTER(ctypes.c_int)] * 3
    lib.mvgaze_conv_bn_tiles.restype = ctypes.c_int
    lib.mvgaze_conv_bn_tiles(*map(ctypes.byref, tiles))
    if tuple(t.value for t in tiles) != (_BM, _BN, _BK):
        raise RuntimeError(
            f"csrc/conv_bn.cu tiles {[t.value for t in tiles]} != "
            f"ops/conv_bn.py's {(_BM, _BN, _BK)}"
        )
    fn = lib.mvgaze_conv3x3_bn_stats
    p, i = ctypes.c_void_p, ctypes.c_int
    # dtypes, x w out stats ws partials counters, B H W C Cout k_chunk splits vec_x vec_w, stream
    fn.argtypes = [i, i] + [p] * 7 + [i] * 9 + [p]
    fn.restype = ctypes.c_int
    return fn


def conv3x3_bn_stats(x: torch.Tensor, w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """3x3 stride-1 same-pad NHWC convolution and the per-channel (sum, sum
    of squares) of its float32 accumulator.

    ``x (B, H, W, C)`` and ``w (3, 3, C, Cout)`` (HWIO), each float32 or
    bfloat16 and contiguous, are rounded to bfloat16; products accumulate
    in float32. Returns ``(out (B, H, W, Cout) in x's dtype, stats (2, Cout)
    float32)``. CUDA tensors run the kernel (counted in ``.launches``); CPU
    tensors run :func:`conv3x3_bn_stats_plain`."""
    b, h, wd, c, cout = _check_inputs(x, w)
    device = x.device
    if device.type == "cpu":
        return conv3x3_bn_stats_plain(x, w)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    m, k = b * h * wd, 9 * c
    if m >= 2**31:
        raise ValueError(f"x {tuple(x.shape)} has more rows than the kernel's int indices hold")
    fn = _kernel_fn()
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    k_chunk, splits = plan_splits(m, cout, k, n_sm)
    m_tiles, n_tiles = math.ceil(m / _BM), math.ceil(cout / _BN)
    out = torch.empty((b, h, wd, cout), dtype=x.dtype, device=device)
    stats = torch.empty((2, cout), dtype=torch.float32, device=device)
    partials = torch.empty((2, m_tiles, cout), dtype=torch.float64, device=device)
    ws = torch.empty((splits, m, cout), dtype=torch.float32, device=device) if splits > 1 else None
    # counters: one per channel tile (statistics), then one per output tile (split-K)
    counters = tile_counters(device, n_tiles + (m_tiles * n_tiles if splits > 1 else 0))
    # 16-byte loads: 8 channels of a pixel (x) or 8 output channels of a
    # weight row (w) at a 16-byte aligned address
    vec_x = int(c % 8 == 0 and x.data_ptr() % 16 == 0)
    vec_w = int(cout % 8 == 0 and w.data_ptr() % 16 == 0)
    with torch.cuda.device(device):
        err = fn(
            _DTYPE_CODES[x.dtype], _DTYPE_CODES[w.dtype],
            x.data_ptr(), w.data_ptr(), out.data_ptr(), stats.data_ptr(),
            None if ws is None else ws.data_ptr(), partials.data_ptr(), counters.data_ptr(),
            b, h, wd, c, cout, k_chunk, splits, vec_x, vec_w,
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"conv3x3_bn_stats launch failed: cudaError_t {err}")
    conv3x3_bn_stats.launches += 1
    return out, stats


conv3x3_bn_stats.launches = 0
