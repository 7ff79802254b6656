"""BatchNorm for the backbone (counterpart of ``rot_mvgaze_tpu/models/norm.py``).

The JAX package's ``TorchBatchNorm`` reproduces torch ``BatchNorm2d``: biased
batch variance for normalisation, unbiased variance in the running estimate,
running update ``running*0.9 + stat*0.1`` (flax momentum 0.9 == torch
momentum 0.1), eps 1e-5. In eval it is the affine ``x*a + b`` from the
running statistics, which is what ``nn.BatchNorm2d`` computes in eval. So
the port uses ``nn.BatchNorm2d`` itself, with those settings fixed here.
"""

from __future__ import annotations

from torch import nn


def batch_norm(channels: int) -> nn.BatchNorm2d:
    """``nn.BatchNorm2d`` with the JAX package's eps and momentum."""
    return nn.BatchNorm2d(channels, eps=1e-5, momentum=0.1)
