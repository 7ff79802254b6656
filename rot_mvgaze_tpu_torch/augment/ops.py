"""Image preprocessing and train-time augmentation (port of
``rot_mvgaze_tpu/augment/ops.py``).

Images stay NHWC here, as at the JAX package's public functions; the
backbone permutes them into an NCHW view with channels_last strides. The
antialiased resize is not ported yet: only the identity resize runs.

The train stack draws each sample's parameters in bulk from an explicit
``torch.Generator`` on the images' device and applies them to the whole
batch at once. Each op is split into its draws and a deterministic core
(``jitter_blend``, ``affine_warp_nearest``, ``multi_erasing_mask``) that
equals the JAX package's given the same parameters. The JAX package's
one-hot selection matmuls, a TPU workaround for gathers, are plain gathers
here. The draws come from another generator than ``jax.random``, so they
match JAX's in distribution, not bit for bit.
"""

from __future__ import annotations

from typing import Tuple

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


# ---------------------------------------------------------------------------
# train-time augmentation
# ---------------------------------------------------------------------------

_GRAY_W = (0.299, 0.587, 0.114)  # ITU-R 601-2 luma
# hs = int(1/dot_size), dot_size in [0.05, 0.3] -> hs in [3, 20]
MAX_ERASE_GRID = 20


def _uniform(
    shape, lo: float, hi: float, generator: torch.Generator, device: torch.device
) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    return u * (hi - lo) + lo


def _gray(img: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) -> (B, H, W, 1) luma in the image's dtype."""
    w = torch.tensor(_GRAY_W, dtype=img.dtype, device=img.device)
    return (img * w).sum(-1, keepdim=True)


def jitter_blend(img: torch.Tensor, op: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """One jitter op per sample on (B, H, W, 3) images in [0, 1]: ``op`` (B,)
    in {0: brightness, 1: contrast, 2: saturation}, ``factor`` (B,).
    ``clip(f*x + (1-f)*base, 0, 1)`` with base 0, the mean luma, or the
    pixel's luma (torchvision's ColorJitter blends)."""
    f = factor.to(img.dtype).view(-1, 1, 1, 1)
    op = op.view(-1, 1, 1, 1)
    gray = _gray(img)
    mean_gray = gray.mean(dim=(1, 2, 3), keepdim=True)
    base = torch.where(op == 0, torch.zeros_like(gray), torch.where(op == 1, mean_gray, gray))
    return torch.clamp(f * img + (1 - f) * base, 0, 1)


def draw_color_jitter(
    n: int,
    generator: torch.Generator,
    device: torch.device,
    brightness: float = 1.0,
    contrast: float = 0.1,
    saturation: float = 0.1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(factors (n, 3) for brightness/contrast/saturation, each ~
    U[max(0, 1-x), 1+x]; order (n, 3), a random permutation of the ops)."""
    factors = torch.stack(
        [_uniform((n,), max(0.0, 1.0 - x), 1.0 + x, generator, device)
         for x in (brightness, contrast, saturation)],
        dim=1,
    )
    order = torch.argsort(torch.rand((n, 3), generator=generator, device=device), dim=1)
    return factors, order


def apply_color_jitter(img: torch.Tensor, factors: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """The three jitter ops in each sample's ``order``, with its ``factors``."""
    for i in range(3):
        op = order[:, i]
        img = jitter_blend(img, op, factors.gather(1, op[:, None])[:, 0])
    return img


def color_jitter(img: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """torchvision ColorJitter(1.0, 0.1, 0.1) per sample of (B, H, W, 3)."""
    return apply_color_jitter(img, *draw_color_jitter(img.shape[0], generator, img.device))


def affine_warp_nearest(
    img: torch.Tensor, scale: torch.Tensor, tx: torch.Tensor, ty: torch.Tensor
) -> torch.Tensor:
    """Warp each (H, W, C) image about its centre: ``out(p) = img(c + (p - c -
    t)/s)``, nearest source pixel (round half to even), zero outside."""
    b, h, w = img.shape[:3]
    cy, cx = (h - 1) * 0.5, (w - 1) * 0.5
    ys = torch.arange(h, dtype=torch.float32, device=img.device)
    xs = torch.arange(w, dtype=torch.float32, device=img.device)
    iy = torch.round(cy + (ys[None] - cy - ty[:, None]) / scale[:, None]).long()
    ix = torch.round(cx + (xs[None] - cx - tx[:, None]) / scale[:, None]).long()
    ok = ((iy >= 0) & (iy < h))[:, :, None] & ((ix >= 0) & (ix < w))[:, None, :]
    bidx = torch.arange(b, device=img.device)[:, None, None]
    out = img[bidx, iy.clamp(0, h - 1)[:, :, None], ix.clamp(0, w - 1)[:, None, :]]
    return out * ok[..., None].to(img.dtype)


def draw_affine(
    n: int,
    h: int,
    w: int,
    generator: torch.Generator,
    device: torch.device,
    scale_range: Tuple[float, float] = (0.99, 1.01),
    translate: Tuple[float, float] = (0.01, 0.01),
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(scale ~ U[scale_range], tx, ty): shifts ~ round(U[-t*W, t*W]) pixels,
    as torchvision's RandomAffine.get_params rounds them."""
    scale = _uniform((n,), scale_range[0], scale_range[1], generator, device)
    max_dx, max_dy = translate[0] * w, translate[1] * h
    tx = torch.round(_uniform((n,), -max_dx, max_dx, generator, device))
    ty = torch.round(_uniform((n,), -max_dy, max_dy, generator, device))
    return scale, tx, ty


def random_affine(img: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """torchvision RandomAffine(degrees=0, scale=(0.99, 1.01), translate=(0.01,
    0.01)) per sample, nearest interpolation, zero fill."""
    b, h, w = img.shape[:3]
    return affine_warp_nearest(img, *draw_affine(b, h, w, generator, img.device))


def multi_erasing_mask(
    dot: torch.Tensor, prop: torch.Tensor, grid_u: torch.Tensor, h: int, w: int
) -> torch.Tensor:
    """(B, H, W) coarse-dropout keep mask: ``hs = min(int(1/dot), MAX)``,
    cell (i, j) kept where ``grid_u[i, j] > prop``, pixel (y, x) reading cell
    ``(int(y*hs/H), int(x*hs/W))``. ``grid_u`` is (B, MAX, MAX) uniform."""
    g = grid_u.shape[-1]
    hs = torch.clamp(torch.floor(1.0 / dot), max=g).to(torch.int32).to(torch.float32)
    keep = grid_u > prop[:, None, None]
    ys = (torch.arange(h, dtype=torch.float32, device=dot.device)[None] * hs[:, None] / h).long()
    xs = (torch.arange(w, dtype=torch.float32, device=dot.device)[None] * hs[:, None] / w).long()
    bidx = torch.arange(dot.shape[0], device=dot.device)[:, None, None]
    return keep[bidx, ys[:, :, None], xs[:, None, :]]


def draw_multi_erasing(
    n: int,
    generator: torch.Generator,
    device: torch.device,
    p: float = 0.5,
    proportion: Tuple[float, float] = (0.5, 0.6),
    dot_size: Tuple[float, float] = (0.05, 0.3),
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(gate (n,) bool: erase with probability p, dot ~ U[dot_size], prop ~
    U[proportion], grid_u (n, MAX, MAX) uniform)."""
    gate = torch.rand((n,), generator=generator, device=device) <= p
    dot = _uniform((n,), dot_size[0], dot_size[1], generator, device)
    prop = _uniform((n,), proportion[0], proportion[1], generator, device)
    grid_u = torch.rand(
        (n, MAX_ERASE_GRID, MAX_ERASE_GRID), generator=generator, device=device
    )
    return gate, dot, prop, grid_u


def random_multi_erasing(
    img: torch.Tensor, generator: torch.Generator, p: float = 0.5
) -> torch.Tensor:
    """With probability ``p`` per sample, multiply in a coarse-dropout mask
    (an hs x hs Bernoulli keep grid, nearest-upsampled)."""
    b, h, w = img.shape[:3]
    gate, dot, prop, grid_u = draw_multi_erasing(b, generator, img.device, p)
    mask = multi_erasing_mask(dot, prop, grid_u, h, w) | ~gate[:, None, None]
    return img * mask[..., None].to(img.dtype)


def train_preprocess(
    img_u8: torch.Tensor,
    generator: torch.Generator,
    image_size: int = 224,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Train stack over a (B, H, W, 3) uint8 batch -> (B, S, S, 3) ``dtype``:
    to-float -> color jitter -> random affine -> resize -> normalize ->
    random multi-erasing, the reference's order. ``generator`` must live on
    the images' device."""
    x = to_float(img_u8, dtype)
    x = color_jitter(x, generator)
    x = random_affine(x, generator)
    x = resize_bilinear(x, image_size)
    x = normalize(x)
    return random_multi_erasing(x, generator)
