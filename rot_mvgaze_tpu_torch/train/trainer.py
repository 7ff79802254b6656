"""Optimizer of the training runtime (the ``make_optimizer`` part of
``rot_mvgaze_tpu/train/trainer.py``). The Trainer class, checkpoints and the
CLI are not ported yet (ROADMAP A9)."""

from __future__ import annotations

from typing import Iterable

import torch


def make_optimizer(
    params: Iterable[torch.nn.Parameter], weight_decay: float = 1e-6, lr: float = 0.0
) -> torch.optim.Adam:
    """``torch.optim.Adam`` with coupled L2 (the decay is added to the gradient
    before the moments), the reference's optimizer and what the JAX
    package's ``add_decayed_weights -> scale_by_adam -> scale_by_learning_rate``
    chain computes. The train step sets ``lr`` from its schedule before each
    update."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)
