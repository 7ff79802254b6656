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

:class:`IntensityBatchNorm` is the ``share_feature`` fuser's normaliser of
rotatable features (counterpart of ``IntensityBatchNorm`` in
``rot_mvgaze_tpu/models/rot_mv.py``), plain PyTorch as in the JAX package.
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


class IntensityBatchNorm(nn.Module):
    """Divides rotatable features (B, 3, C) by a running std of their
    per-vector intensity ``||x||_2`` over the rotation axis.

    The buffer is ``running_mean`` (1, 1, C), initialised to ones, as the
    reference names it, though it tracks a std. In train mode the batch's
    biased std of the intensities (taken in float32, without gradient,
    floored at ``eps`` before the square root) moves the buffer by
    ``momentum`` *before* the division, which uses the new value; in eval
    the buffer as it is. The divisor is ``running + eps`` in ``x``'s dtype.
    """

    def __init__(self, n_channels: int, momentum: float = 0.05, eps: float = 1e-4) -> None:
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.register_buffer("running_mean", torch.ones(1, 1, n_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            with torch.no_grad():
                intensity = torch.linalg.vector_norm(x.float(), dim=-2, keepdim=True)
                mean = intensity.mean(dim=0, keepdim=True)
                mean_sq = intensity.square().mean(dim=0, keepdim=True)
                std = torch.sqrt(torch.clamp(mean_sq - mean.square(), min=self.eps))
                self.running_mean.copy_(
                    self.running_mean * (1 - self.momentum) + std * self.momentum
                )
        return x / (self.running_mean + self.eps).to(x.dtype)
