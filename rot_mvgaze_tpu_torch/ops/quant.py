"""Symmetric int8 quantization for the eval path (port of
``rot_mvgaze_tpu/ops/quant.py``).

- per-output-channel weight scales, computed from the float weights, so a
  float checkpoint serves both paths;
- a per-tensor activation scale: dynamic (one abs-max per call) or a given
  ``act_scale`` (calibrated static int8);
- ``q = clip(round(x / scale), -127, 127)``, round half to even as
  ``jnp.round``;
- int32 accumulation, rescaled in float32 and cast to the output dtype.

The int32 product is :func:`int8_matmul`. On a CUDA tensor it is
``torch._int_mm`` (cuBLASLt on the int8 tensor cores), with K and N
zero-padded to multiples of 8 and M to more than 16, as that call requires
(zeros add nothing to an integer sum, so the padding is exact). On a CPU
tensor it is :func:`int8_matmul_reference`: a float64 product of the int8
values, exact because every sum of products stays far below 2**53 (127² ·
4608 < 2**27 at R50's widest K), cast to int32. It never falls back: a CUDA
call runs the tensor-core product or raises. The JAX package computes this
in XLA, not in a Pallas kernel, so no TPU kernel is replaced here.

:func:`int8_conv` lowers a convolution to that product by im2col on NHWC
int8 values (a 1x1 stride-1 conv is a reshape), one product per group;
its plain twin for CPU tensors, :func:`int8_conv_accumulate_reference`, is
a float64 convolution of the int8 values. Weights use PyTorch's layouts,
``(O, C/groups, kh, kw)`` for a conv and ``(N, K)`` for a dense layer;
activations of a conv are NCHW (any memory format).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

_EPS = 1e-12


def quantize_symmetric(
    x: torch.Tensor, reduce_dims: Optional[Sequence[int]] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q int8, scale float32)`` with ``x ≈ q * scale``: one scale over the
    whole tensor for ``reduce_dims=None``, else one per slice, the reduced
    dims kept as size 1."""
    xf = x.float()
    if reduce_dims is None:
        amax = xf.abs().amax()
    else:
        amax = xf.abs().amax(dim=tuple(reduce_dims), keepdim=True)
    scale = scale_from_amax(amax)
    return quantize_with_scale(xf, scale), scale


def scale_from_amax(amax: torch.Tensor) -> torch.Tensor:
    """The symmetric scale of an abs-max: ``max(amax, eps) / 127``."""
    return torch.clamp(amax, min=_EPS) / 127.0


def quantize_with_scale(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``clip(round(x / scale), -127, 127)`` as int8, in float32."""
    return torch.clamp(torch.round(x.float() / scale), -127, 127).to(torch.int8)


def int8_matmul_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`int8_matmul`: exact int32 ``a @ b`` of int8
    (M, K) and (K, N) through a float64 product."""
    return (a.double() @ b.double()).to(torch.int32)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int32 ``a @ b`` of int8 ``a`` (M, K) and ``b`` (K, N). CUDA tensors
    run ``torch._int_mm`` on ``a`` row-major and ``b`` column-major (the
    layout cuBLASLt's int8 kernels take), zero-padded to K and N multiples
    of 8 and M > 16, counted in ``.launches``; CPU tensors run
    :func:`int8_matmul_reference`."""
    if a.dtype != torch.int8 or b.dtype != torch.int8 or a.dim() != 2 or b.dim() != 2:
        raise TypeError(f"int8_matmul takes 2-D int8 tensors, got {a.dtype} {tuple(a.shape)} and "
                        f"{b.dtype} {tuple(b.shape)}")
    if a.shape[1] != b.shape[0] or a.device != b.device:
        raise ValueError(f"int8_matmul: (M, K) x (K, N) on one device, got {tuple(a.shape)} on "
                         f"{a.device} and {tuple(b.shape)} on {b.device}")
    if a.device.type == "cpu":
        return int8_matmul_reference(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    m, k = a.shape
    n = b.shape[1]
    mp, kp, np_ = max(m, 17), _round_up(k, 8), _round_up(n, 8)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    bt = b.t()  # (N, K): b column-major once made contiguous
    if (np_, kp) != (n, k):
        bt = F.pad(bt, (0, kp - k, 0, np_ - n))
    out = torch._int_mm(a.contiguous(), bt.contiguous().t())
    int8_matmul.launches += 1
    if (mp, np_) != (m, n):
        out = out[:m, :n]
    return out


int8_matmul.launches = 0


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def int8_conv_accumulate_reference(
    x8: torch.Tensor, w8: torch.Tensor, stride=1, padding=0, groups: int = 1
) -> torch.Tensor:
    """Plain version of :func:`int8_conv_accumulate`: a float64 convolution
    of the int8 values, exact, cast to int32 (NCHW out). cuDNN is kept out
    on the card: its Winograd and FFT algorithms round; the native
    im2col-and-product convolution sums whole numbers exactly."""
    with torch.backends.cudnn.flags(enabled=False):
        y = F.conv2d(x8.double(), w8.double(), stride=stride, padding=padding, groups=groups)
    return y.to(torch.int32)


def int8_conv_accumulate_im2col(
    x8: torch.Tensor, w8: torch.Tensor, stride=1, padding=0, groups: int = 1
) -> torch.Tensor:
    """int32 convolution of int8 NCHW ``x8`` with int8 ``w8`` (O, C/groups,
    kh, kw) as :func:`int8_matmul` of its im2col rows: the NHWC values,
    zero-padded, each tap a strided slice, taps concatenated along channels
    ((kh, kw, c) order, the weight permuted to match); a 1x1 stride-1 conv
    is a reshape. One product per group. NCHW out with channels_last
    strides."""
    (sh, sw), (ph, pw) = _pair(stride), _pair(padding)
    o, cg, kh, kw = w8.shape
    n, c, h, w = x8.shape
    if c != cg * groups or o % groups:
        raise ValueError(f"int8 conv: x has {c} channels, weight {tuple(w8.shape)}, groups {groups}")
    ho, wo = (h + 2 * ph - kh) // sh + 1, (w + 2 * pw - kw) // sw + 1
    xh = x8.permute(0, 2, 3, 1)  # NHWC (a view of a channels_last x)
    if ph or pw:
        xh = F.pad(xh, (0, 0, pw, pw, ph, ph))
    og = o // groups
    outs = []
    for g in range(groups):
        xg = xh if groups == 1 else xh[..., g * cg:(g + 1) * cg]
        if (kh, kw, sh, sw) == (1, 1, 1, 1):
            cols = xg.reshape(n * ho * wo, cg)
        else:
            taps = [xg[:, i:i + sh * (ho - 1) + 1:sh, j:j + sw * (wo - 1) + 1:sw, :]
                    for i in range(kh) for j in range(kw)]
            cols = torch.cat(taps, dim=-1).reshape(n * ho * wo, kh * kw * cg)
        wg = w8[g * og:(g + 1) * og].permute(0, 2, 3, 1).reshape(og, kh * kw * cg)
        outs.append(int8_matmul(cols, wg.t()))
    y = outs[0] if groups == 1 else torch.cat(outs, dim=1)
    return y.reshape(n, ho, wo, o).permute(0, 3, 1, 2)


def int8_conv_accumulate(
    x8: torch.Tensor, w8: torch.Tensor, stride=1, padding=0, groups: int = 1
) -> torch.Tensor:
    """int32 convolution of int8 values: :func:`int8_conv_accumulate_im2col`
    (the tensor-core product) for CUDA tensors,
    :func:`int8_conv_accumulate_reference` for CPU tensors."""
    if x8.device.type == "cpu":
        return int8_conv_accumulate_reference(x8, w8, stride, padding, groups)
    return int8_conv_accumulate_im2col(x8, w8, stride, padding, groups)


def quantize_conv_weight(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel int8 weight and its (O,) float32 scales."""
    w8, sw = quantize_symmetric(weight, reduce_dims=(1, 2, 3))
    return w8, sw.reshape(-1)


def int8_conv(
    x: torch.Tensor,
    weight: torch.Tensor,
    stride=1,
    padding=0,
    groups: int = 1,
    out_dtype: Optional[torch.dtype] = None,
    act_scale: Optional[torch.Tensor] = None,
    quantized_weight: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """NCHW convolution with both operands quantized to int8: the weight per
    output channel (or ``quantized_weight``, :func:`quantize_conv_weight`'s
    result for this weight), ``x`` per tensor, dynamically or by
    ``act_scale``; the int32 sum rescaled in float32 and cast to
    ``out_dtype`` (``x``'s by default)."""
    w8, sw = quantize_conv_weight(weight) if quantized_weight is None else quantized_weight
    if act_scale is None:
        x8, sx = quantize_symmetric(x)
    else:
        sx = act_scale.float()
        x8 = quantize_with_scale(x, sx)
    y = int8_conv_accumulate(x8, w8, stride, padding, groups)
    rescale = sx * sw.reshape(1, -1, 1, 1)
    return (y.float() * rescale).to(out_dtype or x.dtype)


def int8_dense(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """(B, K) x ``weight`` (N, K) with int8 operands and int32 accumulation:
    per-output-row weight scales, a per-tensor dynamic activation scale,
    the bias added in float32."""
    w8, sw = quantize_symmetric(weight, reduce_dims=(1,))
    x8, sx = quantize_symmetric(x)
    y = int8_matmul(x8, w8.t())
    out = y.float() * (sx * sw.reshape(1, -1))
    if bias is not None:
        out = out + bias.float()
    return out.to(out_dtype)
