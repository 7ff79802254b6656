"""Seeded weights for a configuration, made on the device in a few large
calls, and handed alike to the system under test and to the reference.

The leaves and their shapes are the reference model's (built on the meta
device, so nothing is allocated). Every value comes from two draws of one
``torch.Generator``: a normal buffer (convolution weights, He-normal over
the fan-in; BatchNorm shifts and running means, N(0, 0.05^2)) and a
uniform buffer (linear weights and biases, U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
PyTorch's default; BatchNorm scales and running variances, U(0.8, 1.2),
except the scales of each residual block's last BatchNorm, U(0.16, 0.24)).
The damped residual branches are those of a trained ResNet (and of
zero-init-residual training's start): with branch scales near 1 a seeded
ResNet-50 is chaotic, a bf16 rounding at the stem growing to 57% of the
last stage's activations (0.3%, 2.4%, 7.8%, 30%, 57% after the stem and
each stage, float32 reference against its bf16 copy, on the CPU), so no
comparison could tell one precision from another; at 0.2 the same reads
0.3%, 1.3%, 1.9%, 3.1%, 4.6%.
The leaves are views of the two buffers, each scaled in place. BatchNorm leaves lie after all others in each
buffer, so the others can be cast to the serving dtype in one call while
BatchNorm stays float32, as the predictor keeps it.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
from torch import nn

from perfbench.reference import model as reference
from perfbench.reference import ops

BN_SHIFT_STD = 0.05
BN_SCALE_RANGE = (0.8, 1.2)
# the last BatchNorm of a residual block: its branch enters the trunk damped
RESIDUAL_BN_SCALE_RANGE = (0.16, 0.24)


def leaves(config: Dict) -> List[Tuple[str, Tuple[int, ...], str, float, float]]:
    """``(name, shape, draw, a, b)`` for every floating leaf of the
    configuration's model: ``draw`` "normal" gives ``a + b * N(0, 1)``,
    "uniform" gives ``a + (b - a) * U(0, 1)``."""
    with torch.device("meta"):
        model = reference.build(config)
    out = []
    for mod_name, mod in model.named_modules():
        prefix = f"{mod_name}." if mod_name else ""
        if isinstance(mod, nn.Conv2d):
            fan_in = mod.in_channels // mod.groups * math.prod(mod.kernel_size)
            out.append((prefix + "weight", tuple(mod.weight.shape), "normal", 0.0, math.sqrt(2.0 / fan_in)))
        elif isinstance(mod, nn.Linear):
            bound = 1.0 / math.sqrt(mod.in_features)
            out.append((prefix + "weight", tuple(mod.weight.shape), "uniform", -bound, bound))
            out.append((prefix + "bias", tuple(mod.bias.shape), "uniform", -bound, bound))
        elif isinstance(mod, nn.BatchNorm2d):
            c = (mod.num_features,)
            scale = RESIDUAL_BN_SCALE_RANGE if mod_name.endswith("bn3") else BN_SCALE_RANGE
            out += [(prefix + "weight", c, "uniform", *scale),
                    (prefix + "bias", c, "normal", 0.0, BN_SHIFT_STD),
                    (prefix + "running_mean", c, "normal", 0.0, BN_SHIFT_STD),
                    (prefix + "running_var", c, "uniform", *BN_SCALE_RANGE)]
    return out


def is_bn(name: str) -> bool:
    return name.endswith(("running_mean", "running_var")) or ".bn" in name or "downsample.1." in name


def make_state(config: Dict, seed: int, device: torch.device,
               dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """The state dict of the configuration's model from ``seed``: every
    leaf but BatchNorm's in ``dtype``, BatchNorm float32, the BatchNorm
    counts 0. Where the configuration's ``weights.bn_running_stats`` is
    "calibrated", :func:`calibrate_running_stats` sets the running
    statistics."""
    spec = leaves(config)
    g = torch.Generator(device=device).manual_seed(seed)
    state: Dict[str, torch.Tensor] = {}
    for draw in ("normal", "uniform"):
        items = [s for s in spec if s[2] == draw]
        items.sort(key=lambda s: is_bn(s[0]))  # stable: BatchNorm leaves last
        sizes = [math.prod(s[1]) for s in items]
        n = sum(sizes)
        draw_fn = torch.randn if draw == "normal" else torch.rand
        buf = draw_fn(sum(sizes), generator=g, device=device)
        for s, view in zip(items, buf.split(sizes)):
            if draw == "normal":
                view.mul_(s[4]).add_(s[3])
            else:
                view.mul_(s[4] - s[3]).add_(s[3])
        k = sum(not is_bn(s[0]) for s in items)
        cut = sum(sizes[:k])
        views = buf[:cut].to(dtype).split(sizes[:k]) + buf[cut:].split(sizes[k:])
        for s, view in zip(items, views):
            state[s[0]] = view.view(s[1])
    with torch.device("meta"):
        model = reference.build(config)
    for name, buf in model.named_buffers():
        if name.endswith("num_batches_tracked"):
            state[name] = torch.zeros((), dtype=torch.long, device=device)
    state = {name: state[name] for name in model.state_dict()}
    if config.get("weights", {}).get("bn_running_stats") == "calibrated":
        calibrate_running_stats(config, state, g)
    return state


@torch.no_grad()
def calibrate_running_stats(config: Dict, state: Dict[str, torch.Tensor], g: torch.Generator,
                            images: int = 32) -> None:
    """Set every BatchNorm's running mean and variance, in place, to the
    batch statistics of ``images`` seeded uniform uint8 images through the
    float32 reference in train mode, as a trained network's eval-mode
    BatchNorm normalises its inputs; without it, eval-mode activations of
    seeded weights grow through the residual stream by orders of
    magnitude."""
    device = g.device
    model = reference.build_on(config, device, state)
    for m in model.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.momentum = 1.0
    size = config["model"]["image_size"]
    x = torch.randint(0, 256, (images, size, size, 3), generator=g, device=device, dtype=torch.uint8)
    model.train()
    with reference.exact_float32():
        model.backbone(ops.eval_images(x))
    for name, buf in model.state_dict().items():
        if name.endswith(("running_mean", "running_var")):
            state[name].copy_(buf)
