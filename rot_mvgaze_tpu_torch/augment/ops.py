"""Eval-time image preprocessing (port of the eval part of
``rot_mvgaze_tpu/augment/ops.py``).

Images stay NHWC here, as at the JAX package's public functions; the
backbone permutes them into an NCHW view with channels_last strides. The
train-time augmentation stack and the antialiased resize are not ported yet.
"""

from __future__ import annotations

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def to_float(img_u8: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 [0,255] -> float [0,1] (the ``1/255`` factor rounded to ``dtype``)."""
    return img_u8.to(dtype) * torch.tensor(1.0 / 255.0, dtype=dtype, device=img_u8.device)


def normalize(img: torch.Tensor) -> torch.Tensor:
    """ImageNet normalization over the trailing channel axis, written as
    ``img * (1/std) - mean/std`` with the constants folded in float32 and then
    cast to the image's dtype, as in the JAX package (where XLA fuses the two
    steps into one multiply-add: up to one ulp apart)."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=img.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=img.device)
    inv_std = (1.0 / std).to(img.dtype)
    shift = (mean / std).to(img.dtype)
    return img * inv_std - shift


def resize_bilinear(img: torch.Tensor, size: int) -> torch.Tensor:
    """Resize of (..., H, W, C) to (..., size, size, C): the identity when the
    input already has that size. Any other size raises, because
    ``F.interpolate(antialias=True)`` does not reproduce the JAX package's
    ``jax.image.resize`` (``tests/test_resize_parity.py``)."""
    if tuple(img.shape[-3:-1]) == (size, size):
        return img
    raise ValueError(
        f"images must be {size}x{size}, got {tuple(img.shape[-3:-1])}: the "
        f"antialiased resize is not ported yet"
    )


def eval_preprocess(img_u8: torch.Tensor, image_size: int = 224) -> torch.Tensor:
    """Deterministic eval stack: to-float -> resize -> normalize, (N,H,W,3)
    uint8 -> (N,size,size,3) float32."""
    return normalize(resize_bilinear(to_float(img_u8), image_size))
