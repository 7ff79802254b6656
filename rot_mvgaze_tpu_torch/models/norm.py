"""BatchNorm for the backbone (counterpart of ``rot_mvgaze_tpu/models/norm.py``).

The JAX package's BN reproduces torch ``BatchNorm2d``: biased batch variance
for normalisation, unbiased variance (``n/max(n-1, 1)``, n = N·H·W) in the
running estimate, running update ``running*0.9 + stat*0.1`` (flax momentum
0.9 == torch momentum 0.1), eps 1e-5. :class:`BatchNormAct` is an
``nn.BatchNorm2d`` with those settings, so its state-dict keys are
``BatchNorm2d``'s and reference checkpoints load strictly, plus an optional
fused residual add and ReLU:

- train: :func:`rot_mvgaze_tpu_torch.ops.batchnorm.fused_batchnorm_act` (the
  hand-written CUDA kernels on the card), then the running-statistics
  update;
- eval: ``nn.BatchNorm2d``'s own eval forward, then the add, then ReLU.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from rot_mvgaze_tpu_torch.ops.batchnorm import fused_batchnorm_act


class BatchNormAct(nn.BatchNorm2d):
    """``nn.BatchNorm2d(eps=1e-5, momentum=0.1)`` with ``forward(x,
    residual=None)`` computing ``act(bn(x) [+ residual])``."""

    def __init__(self, channels: int, relu: bool = False) -> None:
        super().__init__(channels, eps=1e-5, momentum=0.1)
        self.relu = relu

    def forward(
        self, x: torch.Tensor, residual: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        if not self.training:
            out = super().forward(x)
            if residual is not None:
                out = out + residual
            return F.relu(out) if self.relu else out
        n = x.numel() // x.shape[1]
        if residual is not None:
            residual = residual.to(x.dtype)
        y, mean, var = fused_batchnorm_act(
            x, self.weight, self.bias, residual, self.eps, self.relu
        )
        with torch.no_grad():
            self.num_batches_tracked.add_(1)
            # momentum None: cumulative average, as nn.BatchNorm2d
            factor = (
                self.momentum if self.momentum is not None
                else 1.0 / float(self.num_batches_tracked)
            )
            self.running_mean.lerp_(mean, factor)
            # n / max(n - 1, 1), as the JAX package: one value per channel
            # (batch variance 0) blends a running variance of 0, where
            # nn.BatchNorm2d would raise
            self.running_var.lerp_(var * (n / max(n - 1, 1)), factor)
        return y
