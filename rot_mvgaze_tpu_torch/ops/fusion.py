"""Rotate + concat + GEMM + ReLU: layer 1 of the rotation-constrained fuser
(port of ``rot_mvgaze_tpu/ops/fusion.py``).

Per fusion iteration and view::

    rotated = R_rel @ f_other                              # (B,3,3) @ (B,3,V)
    h       = relu([img_feat ; rotated.flat] @ W1^T + b1)  # (B, D+3V) x (H, D+3V)
    out     = h @ W2^T + b2

:func:`rotate_concat_matmul_relu` computes ``h`` with the hand-written CUDA
kernel in ``csrc/fusion.cu`` for a CUDA tensor, and with its plain PyTorch
version, :func:`rotate_concat_matmul_relu_reference`, for a CPU tensor. It
never falls back: a CUDA call launches the kernel or raises.
``fused_image_feat_fuser`` adds layer 2 as a plain ``F.linear``. Weights are
used as ``nn.Linear`` stores them, ``(out, in)``. Unlike the JAX wrapper,
the batch is not padded: the kernel masks ragged edges itself.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch
import torch.nn.functional as F

# must agree with BM/BN/BK in csrc/fusion.cu (checked when the library loads)
_BM, _BN, _BK = 64, 64, 32
# split K until about this many blocks per SM are resident: with one block
# per output tile the serving shape fills fewer than half of an H100's SMs
_BLOCKS_PER_SM = 4
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def rotate_concat_matmul_relu_reference(
    img_feat: torch.Tensor,
    rot_feat: torch.Tensor,
    rot: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: rotate in f32, round to the input
    dtype, concat, f32 product + bias, ReLU, round to the input dtype."""
    rotated = torch.einsum("bij,bjv->biv", rot.float(), rot_feat.float())
    x = torch.cat([img_feat, rotated.to(img_feat.dtype).flatten(1)], dim=1)
    return F.linear(x.float(), w1.float(), b1.float()).relu().to(img_feat.dtype)


def _check_inputs(img_feat, rot_feat, rot, w1, b1) -> Tuple[int, int, int, int]:
    """Validate shapes, dtypes, devices and contiguity; returns (B, D, V, H)."""
    if img_feat.dim() != 2 or rot_feat.dim() != 3 or rot_feat.shape[1] != 3:
        raise ValueError(
            f"img_feat must be (B, D) and rot_feat (B, 3, V); got "
            f"{tuple(img_feat.shape)} and {tuple(rot_feat.shape)}"
        )
    b, d = img_feat.shape
    v = rot_feat.shape[2]
    if rot_feat.shape[0] != b or tuple(rot.shape) != (b, 3, 3):
        raise ValueError(
            f"batch mismatch: img_feat {tuple(img_feat.shape)}, rot_feat "
            f"{tuple(rot_feat.shape)}, rot {tuple(rot.shape)}"
        )
    if w1.dim() != 2 or w1.shape[1] != d + 3 * v or tuple(b1.shape) != (w1.shape[0],):
        raise ValueError(
            f"w1 must be (H, D+3V) = (H, {d + 3 * v}) and b1 (H,); got "
            f"{tuple(w1.shape)} and {tuple(b1.shape)}"
        )
    if img_feat.dtype not in _DTYPE_CODES:
        raise TypeError(f"img_feat must be float32 or bfloat16, got {img_feat.dtype}")
    if rot_feat.dtype != img_feat.dtype or w1.dtype != img_feat.dtype:
        raise TypeError(
            f"img_feat, rot_feat and w1 must share a dtype; got {img_feat.dtype}, "
            f"{rot_feat.dtype}, {w1.dtype}"
        )
    if rot.dtype != torch.float32 or b1.dtype != torch.float32:
        raise TypeError(f"rot and b1 must be float32; got {rot.dtype}, {b1.dtype}")
    tensors = (img_feat, rot_feat, rot, w1, b1)
    if any(t.device != img_feat.device for t in tensors):
        raise ValueError("all inputs must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all inputs must be contiguous")
    return b, d, v, w1.shape[0]


def plan_splits(b: int, h: int, k: int, n_sm: int) -> Tuple[int, int]:
    """Split-K plan ``(k_chunk, splits)`` for a (b, k) x (h, k) product.

    ``k_chunk`` is a multiple of the K tile, and ``splits = ceil(k /
    k_chunk)`` blocks share each output tile. At the serving shape (B=64,
    H=K=3584) on 132 SMs: 56 tiles x 10 splits of 384."""
    tiles = math.ceil(h / _BN) * math.ceil(b / _BM)
    k_tiles = math.ceil(k / _BK)
    want = max(1, min(k_tiles, math.ceil(_BLOCKS_PER_SM * n_sm / tiles)))
    k_chunk = math.ceil(k_tiles / want) * _BK
    return k_chunk, math.ceil(k / k_chunk)


@functools.cache
def _kernel_fn():
    from rot_mvgaze_tpu_torch.kernels.build import library

    lib = library()
    tiles = [ctypes.c_int() for _ in range(3)]
    lib.mvgaze_fusion_tiles.argtypes = [ctypes.POINTER(ctypes.c_int)] * 3
    lib.mvgaze_fusion_tiles.restype = ctypes.c_int
    lib.mvgaze_fusion_tiles(*map(ctypes.byref, tiles))
    if tuple(t.value for t in tiles) != (_BM, _BN, _BK):
        raise RuntimeError(
            f"csrc/fusion.cu tiles {[t.value for t in tiles]} != "
            f"ops/fusion.py's {(_BM, _BN, _BK)}"
        )
    fn = lib.mvgaze_rotate_concat_matmul_relu
    fn.argtypes = (
        [ctypes.c_int]
        + [ctypes.c_void_p] * 8
        + [ctypes.c_int] * 7
        + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def rotate_concat_matmul_relu(
    img_feat: torch.Tensor,
    rot_feat: torch.Tensor,
    rot: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
) -> torch.Tensor:
    """h = relu(concat([img_feat, (rot @ rot_feat).flatten(1)]) @ w1^T + b1).

    img_feat (B, D) · rot_feat (B, 3, V) · w1 (H, D+3V), all float32 or all
    bfloat16 · rot (B, 3, 3) float32 · b1 (H,) float32 -> (B, H) in the input
    dtype. CUDA tensors run the kernel (counted in ``.launches``); CPU
    tensors run :func:`rotate_concat_matmul_relu_reference`.
    """
    b, d, v, h = _check_inputs(img_feat, rot_feat, rot, w1, b1)
    device = img_feat.device
    if device.type == "cpu":
        return rotate_concat_matmul_relu_reference(img_feat, rot_feat, rot, w1, b1)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    fn = _kernel_fn()
    k = d + 3 * v
    out = torch.empty((b, h), dtype=img_feat.dtype, device=device)
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    k_chunk, splits = plan_splits(b, h, k, n_sm)
    ws = counters = None
    if splits > 1:
        ws = torch.empty((splits, b, h), dtype=torch.float32, device=device)
        tiles = math.ceil(h / _BN) * math.ceil(b / _BM)
        counters = torch.zeros(tiles, dtype=torch.int32, device=device)
    # 16-byte loads need 16-byte aligned rows and chunks that never straddle
    # the image/rotated boundary or a rotation-row segment
    vec = int(
        d % 8 == 0
        and v % 8 == 0
        and all(t.data_ptr() % 16 == 0 for t in (img_feat, rot_feat, w1))
    )
    with torch.cuda.device(device):
        err = fn(
            _DTYPE_CODES[img_feat.dtype],
            img_feat.data_ptr(), rot_feat.data_ptr(), rot.data_ptr(),
            w1.data_ptr(), b1.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(),
            None if counters is None else counters.data_ptr(),
            b, d, v, h, k_chunk, splits, vec,
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"rotate_concat_matmul_relu launch failed: cudaError_t {err}")
    rotate_concat_matmul_relu.launches += 1
    return out


rotate_concat_matmul_relu.launches = 0


def fused_image_feat_fuser(
    img_feat: torch.Tensor,
    rot_feat: torch.Tensor,
    rot: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
) -> torch.Tensor:
    """Full two-layer ImageFeatFuser: layer 1 above, then ``F.linear(h, w2,
    b2)`` (a plain product, as the JAX package left it to XLA)."""
    h = rotate_concat_matmul_relu(img_feat, rot_feat, rot, w1, b1)
    return F.linear(h, w2, b2)
