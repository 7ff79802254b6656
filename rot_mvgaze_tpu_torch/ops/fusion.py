"""Rotate + concat + GEMM + ReLU: layer 1 of the rotation-constrained fuser
(port of ``rot_mvgaze_tpu/ops/fusion.py``).

Per fusion iteration and view::

    rotated = R_rel @ f_other                              # (B,3,3) @ (B,3,V)
    h       = relu([img_feat ; rotated.flat] @ W1^T + b1)  # (B, D+3V) x (H, D+3V)
    out     = h @ W2^T + b2

:func:`rotate_concat_matmul_relu` computes ``h`` with a hand-written CUDA
kernel for a CUDA tensor, and with its plain PyTorch version,
:func:`rotate_concat_matmul_relu_reference`, for a CPU tensor. Two kernel
variants exist, chosen by dtype and shape alone (:func:`choose_variant`):
``wgmma`` (``csrc/fusion_wgmma.cu``: bf16 on wgmma, W1 by TMA, split-K
reduced in a thread block cluster) and ``generic`` (``csrc/fusion.cu``:
float32 on the FMA units, and bf16 shapes the first does not take, on
``wmma`` with split-K through a global f32 workspace). It never falls back:
a CUDA call launches the chosen kernel or raises.
:func:`rotate_concat_matmul_relu_op` registers that wrapper as the
operator ``mvgaze::rotate_concat_matmul_relu`` (``torch.library.custom_op``
with a shape function), so ``torch.export`` records one node that calls the
wrapper when the program runs; loading such a program needs this module
imported. :class:`RotateConcatMatmulRelu` makes it differentiable: its
forward is that operator, its backward the JAX package's ``custom_vjp``
backward (plain products, as JAX leaves them to XLA).
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

from rot_mvgaze_tpu_torch.kernels.counters import tile_counters

# must agree with BM/BN/BK in csrc/fusion.cu (checked when the library loads)
_BM, _BN, _BK = 64, 64, 32
# generic variant: split K until about this many blocks per SM are resident
_BLOCKS_PER_SM = 4
# must agree with BM/BK/kMaxCluster in csrc/fusion_wgmma.cu (checked at load)
_WG_BM, _WG_BK, _WG_MAX_CLUSTER = 128, 64, 8
VARIANTS = ("wgmma", "generic")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def rotate_concat_matmul_relu_reference(
    img_feat: torch.Tensor,
    rot_feat: torch.Tensor,
    rot: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: rotate in f32, round to the input
    dtype, concat, f32 product + bias, ReLU, round to the input dtype. (A
    float64 input runs in float64 throughout, for a reference.)"""
    acc = torch.promote_types(img_feat.dtype, torch.float32)
    rotated = torch.einsum("bij,bjv->biv", rot.to(acc), rot_feat.to(acc))
    x = torch.cat([img_feat, rotated.to(img_feat.dtype).flatten(1)], dim=1)
    return F.linear(x.to(acc), w1.to(acc), b1.to(acc)).relu().to(img_feat.dtype)


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
    """Split-K plan ``(k_chunk, splits)`` of the generic variant for a
    (b, k) x (h, k) product.

    ``k_chunk`` is a multiple of the K tile, and ``splits = ceil(k /
    k_chunk)`` blocks share each output tile. At the serving shape (B=64,
    H=K=3584) on 132 SMs: 56 tiles x 10 splits of 384."""
    tiles = math.ceil(h / _BN) * math.ceil(b / _BM)
    k_tiles = math.ceil(k / _BK)
    want = max(1, min(k_tiles, math.ceil(_BLOCKS_PER_SM * n_sm / tiles)))
    k_chunk = math.ceil(k_tiles / want) * _BK
    return k_chunk, math.ceil(k / k_chunk)


def plan_wgmma(b: int, d: int, v: int, h: int, n_sm: int) -> Tuple[int, int, int, int, int]:
    """Launch plan ``(n_tile, m_tiles, n_tiles, splits, steps)`` of the
    wgmma variant for img (b, d), feat (b, 3, v) and W1 (h, d + 3v).

    Each block takes 128 rows of W1 (``m_tiles`` of them) against a batch
    tile of ``n_tile`` rows (64 up to B = 64, else 128; ``n_tiles`` of them).
    The ``splits`` blocks that share an output tile form one cluster (at
    most 8), as many as fit beside the other tiles in one wave on ``n_sm``
    SMs; block z takes every splits-th K step of 64 of the image part and
    every splits-th v block (3 steps) of the rotated part, so the busiest
    takes ``steps``. At the serving shape (B=64, D=2048, V=512, H=3584) on
    132 SMs: 28 M-tiles x 4 splits of 8 image + 6 rotated steps, 112 blocks."""
    n_tile = 64 if b <= 64 else 128
    n_tiles = math.ceil(b / n_tile)
    m_tiles = math.ceil(h / _WG_BM)
    units = d // _WG_BK + v // _WG_BK  # image steps and v blocks
    splits = max(1, min(_WG_MAX_CLUSTER, n_sm // (m_tiles * n_tiles), units))
    steps = math.ceil(d // _WG_BK / splits) + 3 * math.ceil(v // _WG_BK / splits)
    return n_tile, m_tiles, n_tiles, splits, steps


def choose_variant(img_feat: torch.Tensor, rot_feat: torch.Tensor, w1: torch.Tensor) -> str:
    """``"wgmma"`` for bf16 with D and V multiples of 64 (a K step of 64 is
    then all image or all one rotation row) and 16-byte aligned
    ``img_feat``, ``rot_feat`` and ``w1``: every shape the model uses (D in
    {512, 2048}, V = 512, any B). ``"generic"`` otherwise: float32, and bf16
    with D or V not a multiple of 64 or a pointer that is not 16-byte
    aligned. Decided by dtype, shape and alignment alone, never by a failed
    build or launch."""
    d, v = img_feat.shape[1], rot_feat.shape[2]
    if (
        img_feat.dtype == torch.bfloat16
        and d % _WG_BK == 0
        and v % _WG_BK == 0
        and all(t.data_ptr() % 16 == 0 for t in (img_feat, rot_feat, w1))
    ):
        return "wgmma"
    return "generic"


@functools.cache
def _wgmma_fn():
    from rot_mvgaze_tpu_torch.kernels.build import library

    lib = library()
    tiles = [ctypes.c_int() for _ in range(3)]
    lib.mvgaze_fusion_wgmma_tiles.argtypes = [ctypes.POINTER(ctypes.c_int)] * 3
    lib.mvgaze_fusion_wgmma_tiles.restype = ctypes.c_int
    lib.mvgaze_fusion_wgmma_tiles(*map(ctypes.byref, tiles))
    if tuple(t.value for t in tiles) != (_WG_BM, _WG_BK, _WG_MAX_CLUSTER):
        raise RuntimeError(
            f"csrc/fusion_wgmma.cu tiles {[t.value for t in tiles]} != "
            f"ops/fusion.py's {(_WG_BM, _WG_BK, _WG_MAX_CLUSTER)}"
        )
    fn = lib.mvgaze_fusion_wgmma
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _generic_fn():
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
    dtype. CUDA tensors run the kernel variant :func:`choose_variant` picks,
    counted in ``.launches`` and ``.launches_by_variant``: ``wgmma`` for
    bf16 with D and V multiples of 64 and 16-byte aligned ``img_feat``,
    ``rot_feat`` and ``w1`` (every shape the model uses), ``generic`` for
    float32 and for bf16 with D or V not a multiple of 64 or a misaligned
    pointer. CPU tensors run :func:`rotate_concat_matmul_relu_reference`.
    """
    b, d, v, h = _check_inputs(img_feat, rot_feat, rot, w1, b1)
    device = img_feat.device
    if device.type == "cpu":
        return rotate_concat_matmul_relu_reference(img_feat, rot_feat, rot, w1, b1)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    variant = choose_variant(img_feat, rot_feat, w1)
    out = torch.empty((b, h), dtype=img_feat.dtype, device=device)
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    stream = torch.cuda.current_stream(device).cuda_stream
    ptrs = (img_feat.data_ptr(), rot_feat.data_ptr(), rot.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), out.data_ptr())
    with torch.cuda.device(device):
        if variant == "wgmma":
            n_tile, _, _, splits, _ = plan_wgmma(b, d, v, h, n_sm)
            err = _wgmma_fn()(*ptrs, b, d, v, h, n_tile, splits, stream)
        else:
            err = _launch_generic(ptrs, img_feat, rot_feat, w1, b, d, v, h, n_sm, stream)
    if err != 0:
        raise RuntimeError(
            f"rotate_concat_matmul_relu ({variant}) launch failed: cudaError_t {err}"
        )
    rotate_concat_matmul_relu.launches += 1
    rotate_concat_matmul_relu.launches_by_variant[variant] += 1
    return out


def _launch_generic(ptrs, img_feat, rot_feat, w1, b, d, v, h, n_sm, stream) -> int:
    """The generic variant's launch: split-K partials in an f32 workspace
    (``torch.empty``: no fill), reduced by the last block of each output tile
    through the persistent arrival counters of ``kernels/counters.py``,
    which the kernel leaves zero."""
    k = d + 3 * v
    k_chunk, splits = plan_splits(b, h, k, n_sm)
    ws = counters = None
    if splits > 1:
        ws = torch.empty((splits, b, h), dtype=torch.float32, device=img_feat.device)
        counters = tile_counters(img_feat.device, math.ceil(h / _BN) * math.ceil(b / _BM))
    # 16-byte loads need 16-byte aligned rows and chunks that never straddle
    # the image/rotated boundary or a rotation-row segment
    vec = int(
        d % 8 == 0
        and v % 8 == 0
        and all(t.data_ptr() % 16 == 0 for t in (img_feat, rot_feat, w1))
    )
    return _generic_fn()(
        _DTYPE_CODES[img_feat.dtype], *ptrs,
        None if ws is None else ws.data_ptr(),
        None if counters is None else counters.data_ptr(),
        b, d, v, h, k_chunk, splits, vec, stream,
    )


rotate_concat_matmul_relu.launches = 0
rotate_concat_matmul_relu.launches_by_variant = dict.fromkeys(VARIANTS, 0)


@torch.library.custom_op("mvgaze::rotate_concat_matmul_relu", mutates_args=())
def rotate_concat_matmul_relu_op(
    img_feat: torch.Tensor,
    rot_feat: torch.Tensor,
    rot: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
) -> torch.Tensor:
    """:func:`rotate_concat_matmul_relu` as one operator (looked up when
    called, so a swap of the module's function reaches it too)."""
    return rotate_concat_matmul_relu(img_feat, rot_feat, rot, w1, b1)


@rotate_concat_matmul_relu_op.register_fake
def _(img_feat, rot_feat, rot, w1, b1):
    b, _, _, h = _check_inputs(img_feat, rot_feat, rot, w1, b1)
    return img_feat.new_empty((b, h))


class RotateConcatMatmulRelu(torch.autograd.Function):
    """Differentiable :func:`rotate_concat_matmul_relu`.

    Saves its inputs and ``h``, as the JAX ``custom_vjp`` does, and in the
    backward masks the gradient by ``h > 0``, recomputes the rotated row in
    f32 rounded to the input dtype, and forms ``dW1 = g^T [img; R f]``,
    ``db1 = Σ g``, ``[dimg; drot] = g W1``, ``dfeat = R^T drot`` and
    ``dR = drot f^T`` (the last two in f32). Gradients come back in each
    input's dtype."""

    @staticmethod
    def forward(ctx, img_feat, rot_feat, rot, w1, b1):
        # autocast off: the op sets its dtypes at its own boundary
        with torch.autocast(img_feat.device.type, enabled=False):
            h = rotate_concat_matmul_relu_op(img_feat, rot_feat, rot, w1, b1)
        ctx.save_for_backward(img_feat, rot_feat, rot, w1, h)
        return h

    @staticmethod
    def backward(ctx, g):
        img_feat, rot_feat, rot, w1, h = ctx.saved_tensors
        d, v = img_feat.shape[1], rot_feat.shape[2]
        need = ctx.needs_input_grad
        dimg = dfeat = drot = dw1 = db1 = None
        # f32 where JAX uses f32 (f64 for a float64 reference)
        acc = torch.promote_types(img_feat.dtype, torch.float32)
        with torch.autocast(img_feat.device.type, enabled=False):
            g = torch.where(h > 0, g, torch.zeros_like(g)).to(img_feat.dtype)
            if need[3]:
                rotated = torch.einsum("bij,bjv->biv", rot.to(acc), rot_feat.to(acc))
                x = torch.cat([img_feat, rotated.to(img_feat.dtype).flatten(1)], dim=1)
                dw1 = g.t() @ x
            if need[4]:
                db1 = g.to(acc).sum(0).to(rot.dtype)
            if need[0] or need[1] or need[2]:
                dx = g @ w1
                dimg = dx[:, :d]
                drotated = dx[:, d:].reshape(-1, 3, v).to(acc)
                if need[1]:
                    dfeat = torch.einsum("bji,bjv->biv", rot.to(acc), drotated).to(rot_feat.dtype)
                if need[2]:
                    drot = torch.einsum("biv,bjv->bij", drotated, rot_feat.to(acc)).to(rot.dtype)
        return dimg, dfeat, drot, dw1, db1


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
    b2)`` (a plain product, as the JAX package left it to XLA). Layer 1 is
    :class:`RotateConcatMatmulRelu` where a gradient is needed, else the
    operator alone (what ``torch.export`` records)."""
    args = (img_feat, rot_feat, rot, w1, b1)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        h = RotateConcatMatmulRelu.apply(*args)
    else:
        h = rotate_concat_matmul_relu_op(*args)
    return F.linear(h, w2, b2)
