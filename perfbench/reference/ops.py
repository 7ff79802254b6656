"""Plain float32 versions of what the system derives from the benchmark's
inputs: head pose -> rotation, the eval image stack, the train-time
augmentation with its draws, the per-step seed, the loss, the learning-rate
schedule and Adam. Written from the reference repository's definitions
(torchvision's ColorJitter(1.0, 0.1, 0.1), RandomAffine(0, (0.01, 0.01),
(0.99, 1.01)) with nearest sampling, ImageNet normalisation, the
coarse-dropout "multi erasing", the angular loss summed over iterations);
it imports torch and numpy alone.

The augmentation draws follow one fixed order from a ``torch.Generator``
on the images' device (for each view in turn: the three jitter factors, the
jitter order, the affine scale and shifts, the erasing gate, dot size,
proportion and cell grid), so a generator seeded alike gives the same
draws on both sides of the comparison; the images are then transformed in
float32.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
GRAY = (0.299, 0.587, 0.114)
ERASE_GRID = 20  # cells per side at the smallest dot size (1 / 0.05)


def fold_seed(base: int, count: int) -> int:
    """The seed of update ``count`` of a run seeded with ``base``: numpy's
    ``SeedSequence([base, count])``, first 64-bit word."""
    return int(np.random.SeedSequence([base, count]).generate_state(1, np.uint64)[0])


def rotation(pitch_yaw: torch.Tensor) -> torch.Tensor:
    """Head pose (..., 2) -> R = Ry(yaw) @ Rx(-pitch), (..., 3, 3)."""
    p, y = -pitch_yaw[..., 0].double(), pitch_yaw[..., 1].double()
    one, zero = torch.ones_like(p), torch.zeros_like(p)
    ry = torch.stack([torch.cos(y), zero, torch.sin(y), zero, one, zero,
                      -torch.sin(y), zero, torch.cos(y)], -1).reshape(*p.shape, 3, 3)
    rx = torch.stack([one, zero, zero, zero, torch.cos(p), -torch.sin(p),
                      zero, torch.sin(p), torch.cos(p)], -1).reshape(*p.shape, 3, 3)
    return (ry @ rx).float()


def normalize(x: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)
    std = torch.tensor(IMAGENET_STD, device=x.device)
    return (x - mean) / std


def eval_images(img_u8: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC at the model's size -> normalised float32."""
    return normalize(img_u8.float() / 255.0)


def _uniform(n, lo, hi, g, device):
    return torch.rand(n, generator=g, device=device) * (hi - lo) + lo


def augment(img_u8: torch.Tensor, g: torch.Generator) -> torch.Tensor:
    """The train stack over one view's (B, S, S, 3) uint8 images at the
    model's size: jitter in a random order, affine (nearest, zero fill),
    normalise, multi erasing with probability 0.5."""
    b, h, w, _ = img_u8.shape
    dev = img_u8.device
    x = img_u8.float() / 255.0
    # ColorJitter(brightness=1.0, contrast=0.1, saturation=0.1)
    factors = torch.stack([_uniform(b, 0.0, 2.0, g, dev), _uniform(b, 0.9, 1.1, g, dev),
                           _uniform(b, 0.9, 1.1, g, dev)], 1)
    order = torch.argsort(torch.rand((b, 3), generator=g, device=dev), dim=1)
    gray_w = torch.tensor(GRAY, device=dev)
    for i in range(3):
        op = order[:, i]
        f = factors.gather(1, op[:, None])[:, 0].view(b, 1, 1, 1)
        gray = (x * gray_w).sum(-1, keepdim=True)
        base = torch.zeros_like(gray)
        base = torch.where((op == 1).view(b, 1, 1, 1), gray.mean(dim=(1, 2, 3), keepdim=True), base)
        base = torch.where((op == 2).view(b, 1, 1, 1), gray, base)
        x = (f * x + (1 - f) * base).clamp(0, 1)
    # RandomAffine(degrees=0, translate=(0.01, 0.01), scale=(0.99, 1.01)), nearest
    scale = _uniform(b, 0.99, 1.01, g, dev)
    tx = torch.round(_uniform(b, -0.01 * w, 0.01 * w, g, dev))
    ty = torch.round(_uniform(b, -0.01 * h, 0.01 * h, g, dev))
    cy, cx = (h - 1) / 2, (w - 1) / 2
    iy = torch.round(cy + (torch.arange(h, device=dev)[None] - cy - ty[:, None]) / scale[:, None]).long()
    ix = torch.round(cx + (torch.arange(w, device=dev)[None] - cx - tx[:, None]) / scale[:, None]).long()
    inside = ((iy >= 0) & (iy < h))[:, :, None] & ((ix >= 0) & (ix < w))[:, None, :]
    rows = torch.arange(b, device=dev)[:, None, None]
    x = x[rows, iy.clamp(0, h - 1)[:, :, None], ix.clamp(0, w - 1)[:, None, :]] * inside[..., None]
    x = normalize(x)
    # multi erasing: an hs x hs grid of cells, each dropped with probability prop
    gate = torch.rand(b, generator=g, device=dev) <= 0.5
    dot = _uniform(b, 0.05, 0.3, g, dev)
    prop = _uniform(b, 0.5, 0.6, g, dev)
    cells = torch.rand((b, ERASE_GRID, ERASE_GRID), generator=g, device=dev)
    hs = torch.clamp(torch.floor(1.0 / dot), max=ERASE_GRID)
    ys = (torch.arange(h, device=dev)[None] * hs[:, None] / h).long()
    xs = (torch.arange(w, device=dev)[None] * hs[:, None] / w).long()
    keep = (cells > prop[:, None, None])[rows, ys[:, :, None], xs[:, None, :]] | ~gate[:, None, None]
    return x * keep[..., None]


def _pitchyaw_to_vector(py: torch.Tensor) -> torch.Tensor:
    p, y = py[..., 0], py[..., 1]
    return torch.stack([torch.cos(p) * torch.sin(y), torch.sin(p), torch.cos(p) * torch.cos(y)], -1)


def angular_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Mean angle in degrees between two pitchyaw sets; the cosine is
    clamped 1e-6 inside [-1, 1] and the norms floored at 1e-6."""
    a, b = _pitchyaw_to_vector(gt), _pitchyaw_to_vector(pred)
    cos = (a * b).sum(-1) / (a.norm(dim=-1).clamp(min=1e-6) * b.norm(dim=-1).clamp(min=1e-6))
    return torch.rad2deg(torch.acos(cos.clamp(-1 + 1e-6, 1 - 1e-6))).mean()


def angle_deg(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Per-row angle in degrees between two pitchyaw arrays, float64."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)

    def vec(py):
        return np.stack([np.cos(py[:, 0]) * np.sin(py[:, 1]), np.sin(py[:, 0]),
                         np.cos(py[:, 0]) * np.cos(py[:, 1])], -1)

    return np.degrees(np.arccos(np.clip((vec(a) * vec(b)).sum(-1), -1.0, 1.0)))


def stereo_loss(gazes: List[Tuple[torch.Tensor, torch.Tensor]], gt_0: torch.Tensor, gt_1: torch.Tensor,
                rel_weight: float, iter_decay: float) -> torch.Tensor:
    """sum_i iter_decay^(n-1-i) * rel_weight * (L(g0_i, gt_0) + L(g1_i, gt_1))."""
    total = None
    for g0, g1 in gazes:
        term = (angular_loss(g0, gt_0) + angular_loss(g1, gt_1)) * rel_weight
        total = term if total is None else total * iter_decay + term
    return total


def triangular2(base_lr: float, max_lr: float, step_size_up: int, step_size_down: int) -> Callable[[int], float]:
    """CyclicLR mode 'triangular2' stepped per update: update ``count``'s rate."""
    total = step_size_up + step_size_down

    def lr(count: int) -> float:
        cycle = math.floor(count / total)
        x = count - cycle * total
        up = min(x / step_size_up, 1.0)
        down = max((x - step_size_up) / step_size_down, 0.0)
        return base_lr + (max_lr - base_lr) * 0.5 ** cycle * (up - down)

    return lr


class Adam:
    """Adam with coupled L2 decay (the decay added to the gradient before
    the moments), one tensor at a time."""

    def __init__(self, params: Dict[str, torch.nn.Parameter], betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=1e-6) -> None:
        self.params, self.betas, self.eps, self.wd = params, betas, eps, weight_decay
        self.state: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
        self.t = 0

    @torch.no_grad()
    def step(self, lr: float) -> Dict[str, torch.Tensor]:
        """One update; returns each updated leaf's gradient as the moments
        took it (decay included)."""
        self.t += 1
        b1, b2 = self.betas
        taken = {}
        for name, p in self.params.items():
            if p.grad is None:
                continue
            g = p.grad + self.wd * p
            m, v = self.state.get(name, (torch.zeros_like(p), torch.zeros_like(p)))
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            self.state[name] = (m, v)
            denom = (v.sqrt() / math.sqrt(1 - b2 ** self.t)).add_(self.eps)
            p.addcdiv_(m, denom, value=-lr / (1 - b1 ** self.t))
            taken[name] = g
        return taken
