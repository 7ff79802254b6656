"""Stacked-block library (port of ``rot_mvgaze_tpu/models/blocks.py``):
``Mlp`` (the fusion model's lifter, fusers and gaze heads), ``Conv2dNet``,
``Conv2dTransposeNet`` and ``weight_copy``, the reference's block library.
Each block is ``Sequential(layer[, norm][, activation])`` under
``blocks.{i}``, the reference checkpoints' key anatomy, and the last block
is the bare layer. PyTorch's default inits are the JAX package's
``torch_linear_init`` bounds."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn


class Mlp(nn.Module):
    """Linear layers with a ReLU between all but the last.

    ``Mlp(in_features, [h0, ..., out])``. The module tree follows the
    reference checkpoints' key anatomy, ``blocks.{i}.0.{weight,bias}``: each
    block is ``Sequential(Linear[, ReLU])``. ``nn.Linear``'s default init is
    the JAX package's ``torch_linear_init``.
    """

    def __init__(self, in_features: int, features: Sequence[int]) -> None:
        super().__init__()
        blocks = []
        for i, out_features in enumerate(features):
            layers = [nn.Linear(in_features, out_features)]
            if i < len(features) - 1:
                layers.append(nn.ReLU())
            blocks.append(nn.Sequential(*layers))
            in_features = out_features
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x = block(x)
        return x


def _conv_blocks(make_layer, make_act, in_channels: int, features: Sequence[int],
                 kernels: Sequence[int], strides: Optional[Sequence[int]],
                 paddings: Optional[Sequence[int]]) -> nn.ModuleList:
    blocks = []
    for i, out_channels in enumerate(features):
        s = strides[i] if strides is not None else 1
        p = paddings[i] if paddings is not None else 0
        layers = [make_layer(in_channels, out_channels, kernels[i], stride=s, padding=p)]
        if i < len(features) - 1:
            # torch's momentum 0.1 is the JAX package's (flax) 0.9
            layers += [nn.BatchNorm2d(out_channels, eps=1e-5, momentum=0.1), make_act()]
        blocks.append(nn.Sequential(*layers))
        in_channels = out_channels
    return nn.ModuleList(blocks)


class Conv2dNet(nn.Module):
    """Conv2d + BatchNorm2d + ReLU blocks, the last a bare Conv2d (NCHW).

    ``Conv2dNet(in_channels, [c0, ..., out], kernels, strides, paddings)``;
    strides default to 1, paddings to 0."""

    def __init__(self, in_channels: int, features: Sequence[int], kernels: Sequence[int],
                 strides: Optional[Sequence[int]] = None,
                 paddings: Optional[Sequence[int]] = None) -> None:
        super().__init__()
        self.blocks = _conv_blocks(nn.Conv2d, nn.ReLU, in_channels, features, kernels, strides, paddings)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x = block(x)
        return x


class Conv2dTransposeNet(nn.Module):
    """ConvTranspose2d + BatchNorm2d + LeakyReLU(0.01) blocks, the last a
    bare ConvTranspose2d (NCHW). ``paddings`` are ConvTranspose2d's own:
    the output side is ``(in - 1) * s - 2p + k``."""

    def __init__(self, in_channels: int, features: Sequence[int], kernels: Sequence[int],
                 strides: Optional[Sequence[int]] = None,
                 paddings: Optional[Sequence[int]] = None) -> None:
        super().__init__()
        self.blocks = _conv_blocks(nn.ConvTranspose2d, lambda: nn.LeakyReLU(0.01), in_channels,
                                   features, kernels, strides, paddings)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x = block(x)
        return x


def weight_copy(dst: nn.Module, src: nn.Module) -> nn.Module:
    """Copy ``src``'s parameters into ``dst``'s, in place, and return
    ``dst``. The two must have the same parameter names (``ValueError``:
    "parameter names differ") and shapes (``ValueError``: "shape
    mismatch"); nothing is copied unless all match."""
    dst_params, src_params = dict(dst.named_parameters()), dict(src.named_parameters())
    if list(dst_params) != list(src_params):
        raise ValueError("parameter names differ")
    for name, d in dst_params.items():
        if d.shape != src_params[name].shape:
            raise ValueError(f"{name}: shape mismatch: dst {tuple(d.shape)} vs src "
                             f"{tuple(src_params[name].shape)}")
    with torch.no_grad():
        for name, d in dst_params.items():
            d.copy_(src_params[name])
    return dst
