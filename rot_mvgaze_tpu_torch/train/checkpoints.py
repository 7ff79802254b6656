"""Checkpoint files of the port's training runtime (counterpart of
``rot_mvgaze_tpu/train/checkpoints.py``).

A checkpoint is one ``torch.save`` file, ``<name>.pth.tar``, holding a dict:

- ``state_dict``: the model's, under the reference's key names, so that
  ``GazePredictor`` and the reference load it with ``strict=True``;
- ``optimizer``: Adam's state dict;
- ``ema``: the parameters' moving average by state-dict key, when the run
  keeps one;
- ``step``: the updates made;
- ``epoch_meta``: ``epochs_done``, ``epoch_step`` and ``steps_per_epoch``,
  for a step-exact resume.

:func:`rot_mvgaze_tpu_torch.compat.read_checkpoint` reads it (and a bare
reference state dict), telling the format from the contents.
"""

from __future__ import annotations

import glob
import os
from typing import Any, Dict, Optional

import torch

#: the pattern of the port's checkpoint names (a temporary file never matches it)
CHECKPOINT_GLOB = "*.pth.tar"
#: the names ``find_latest_checkpoint`` takes: the port's and the JAX
#: package's ``.msgpack`` (whose writer's temporary ``<name>.tmp.<pid>``
#: matches neither)
RESUME_GLOBS = (CHECKPOINT_GLOB, "*.msgpack")


def save_state(path: str, payload: Dict[str, Any]) -> str:
    """``torch.save`` ``payload`` to ``path`` atomically: written to a
    temporary name in the same directory, flushed to disk, then renamed over
    ``path``. A save cut short leaves the previous file whole and no file
    that :func:`find_latest_checkpoint` would pick."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            torch.save(payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def find_latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The most recently written checkpoint in ``ckpt_dir`` (the port's
    ``.pth.tar`` or the JAX package's ``.msgpack``, newest by mtime over
    both), or None."""
    candidates = [p for pattern in RESUME_GLOBS for p in glob.glob(os.path.join(ckpt_dir, pattern))]
    return max(candidates, key=os.path.getmtime) if candidates else None


def is_full_state(ckpt: Any) -> bool:
    """Whether a read checkpoint holds a training state (optimizer and
    step), as the Trainer saves, rather than weights alone."""
    return isinstance(ckpt, dict) and "optimizer" in ckpt and "state_dict" in ckpt
