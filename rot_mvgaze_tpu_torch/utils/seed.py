"""Global determinism (port of ``rot_mvgaze_tpu/utils/seed.py``)."""

from __future__ import annotations

import os
import random
from typing import Any

import numpy as np
import torch

from rot_mvgaze_tpu_torch.utils.device import resolve_device


def set_seed(seed: int = 0, device: Any = "cuda") -> torch.Generator:
    """Seed ``random``, numpy and PyTorch's default generators, set
    ``PYTHONHASHSEED`` for child processes (this interpreter's hash salt is
    fixed at start), and return a ``torch.Generator`` on ``device`` seeded
    with ``seed``: the source of the train step's augmentation draws.

    It also sets ``torch.backends.cudnn.deterministic = True`` and
    ``torch.backends.cudnn.benchmark = False``, as the reference's
    ``set_seed`` does: cuDNN then takes only deterministic algorithms, and
    picks them by heuristics rather than by timing, so a seeded training
    run on the card repeats bit for bit, as the JAX package's does given
    its keys. The flags are process-wide."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    os.environ["PYTHONHASHSEED"] = str(seed)
    return torch.Generator(device=resolve_device(device)).manual_seed(seed)
