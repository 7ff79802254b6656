"""Stacked Linear blocks (port of ``Mlp`` in ``rot_mvgaze_tpu/models/blocks.py``)."""

from __future__ import annotations

from typing import Sequence

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
