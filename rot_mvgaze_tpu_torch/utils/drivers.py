"""Synthetic batches, the workload wiring and the card tag shared by the
benchmark commands (port of ``rot_mvgaze_tpu/utils/drivers.py``).

``bench``, ``bench_eval``, ``bench_sweep`` and ``dryrun`` build their
model, loss, steps and synthetic data through :class:`Workload`, the one
owner of the stereo-or-V-view choice. The host batches are numpy and bit for
bit the JAX package's from the same ``np.random.default_rng`` (the same
draws in the same order); :func:`to_device` puts one on a device.

The JAX module's ``honor_cpu_platform_env`` and
``enable_compile_cache_unless_cpu`` have no counterpart here: the first
selects JAX's platform, which the port's commands take as ``--device``; the
second enables XLA's persistent compile cache, which PyTorch's eager
execution has no use for.
"""

from __future__ import annotations

import subprocess
from typing import Any, Dict, Optional

import numpy as np
import torch

#: options the stereo model takes that the V-view model has not (the JAX
#: package's names, whatever the port does with them)
PALLAS_OPTIONS = ("use_pallas_fusion", "use_pallas_bn")


def make_host_batch(rng: np.random.Generator, batch: int, size: int) -> Dict[str, np.ndarray]:
    """Synthetic host-side two-view training batch (uint8 pixels and
    labels), the input contract of ``train.make_train_step``'s augmentation
    front."""
    return {
        "img_0": rng.integers(0, 256, (batch, size, size, 3), dtype=np.uint8),
        "img_1": rng.integers(0, 256, (batch, size, size, 3), dtype=np.uint8),
        "gt_gaze": rng.uniform(-1, 1, (batch, 2)).astype(np.float32),
        "gt_gaze_1": rng.uniform(-1, 1, (batch, 2)).astype(np.float32),
        "head_pose_0": rng.uniform(-0.8, 0.8, (batch, 2)).astype(np.float32),
        "head_pose_1": rng.uniform(-0.8, 0.8, (batch, 2)).astype(np.float32),
    }


def make_multiview_host_batch(
    rng: np.random.Generator, batch: int, size: int, num_views: int
) -> Dict[str, np.ndarray]:
    """Synthetic host-side V-view training batch (stacked uint8 pixels and
    labels), the input contract of ``train.make_multiview_train_step``."""
    v = num_views
    return {
        "imgs": rng.integers(0, 256, (batch, v, size, size, 3), dtype=np.uint8),
        "gt_gazes": rng.uniform(-1, 1, (batch, v, 2)).astype(np.float32),
        "head_poses": rng.uniform(-0.8, 0.8, (batch, v, 2)).astype(np.float32),
    }


def make_init_data(size: int, batch: int = 2, device: Any = "cpu") -> Dict[str, torch.Tensor]:
    """A small already-preprocessed two-view batch (zero images, identity
    rotations): the model's example input."""
    eye = torch.eye(3, device=device).expand(batch, 3, 3).contiguous()
    zeros = torch.zeros(batch, size, size, 3, device=device)
    return {"img_0": zeros, "img_1": zeros.clone(), "rot_0": eye, "rot_1": eye.clone()}


def make_multiview_init_data(size: int, num_views: int, batch: int = 2,
                             device: Any = "cpu") -> Dict[str, torch.Tensor]:
    """A small already-preprocessed V-view batch (zero images, identity
    rotations)."""
    return {
        "imgs": torch.zeros(batch, num_views, size, size, 3, device=device),
        "rots": torch.eye(3, device=device).expand(batch, num_views, 3, 3).contiguous(),
    }


def to_device(batch: Dict[str, np.ndarray], device: Any) -> Dict[str, torch.Tensor]:
    """A host batch as tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}


def card_of(device: Any) -> Dict[str, Optional[str]]:
    """The card behind ``device``: its name and power limit as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
    them (the name from PyTorch and the limit unread where ``nvidia-smi``
    cannot be run); ``{"name": "cpu", "power_limit": None}`` for the CPU.
    Every record of the benchmark commands carries it."""
    device = torch.device(device)
    if device.type != "cuda":
        return {"name": device.type, "power_limit": None}
    index = device.index if device.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", str(index)],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip()
        name, power = (s.strip() for s in out.splitlines()[0].split(",", 1))
        return {"name": name, "power_limit": power}
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return {"name": torch.cuda.get_device_name(index), "power_limit": None}


class Workload:
    """Model, loss, step factories and synthetic data of the stereo (V=2)
    or V-view (V>2) training workload.

    ``dtype`` is the compute dtype of the train step (float32 by default;
    bfloat16 runs it under bf16 autocast), the port's counterpart of the JAX
    model's ``dtype``. ``stereo_kwargs`` are ``FeatRotationSymm``'s options
    (``fuse_views``, ``bn_stat_subsample``, the ablations) and the JAX
    package's ``use_pallas_fusion`` / ``use_pallas_bn``, which are accepted
    as the port's command line accepts them and change nothing: on the card
    the kernels are the path. ``use_pallas_bn="residual"`` is refused. At
    V > 2 every stereo option is refused by name, as in the JAX package: a
    record made "with" one would name a path that did not run.
    """

    def __init__(self, num_views: int = 2, backbone_depth: Any = 50, num_iter: int = 3,
                 dtype: Optional[torch.dtype] = None, remat: bool = False, int8_backbone: Any = False,
                 **stereo_kwargs: Any) -> None:
        from rot_mvgaze_tpu_torch.losses import IterationLoss, MultiViewL1Loss, StereoL1Loss
        from rot_mvgaze_tpu_torch.models import FeatRotationMultiView, FeatRotationSymm

        if num_views < 2:
            raise ValueError(f"num_views must be >= 2 (got {num_views}); the model is defined over at "
                             "least one view pair")
        self.num_views = num_views
        self.multiview = num_views > 2
        self.dtype = torch.float32 if dtype is None else dtype
        common = dict(backbone_depth=backbone_depth, num_iter=num_iter, remat=remat,
                      int8_backbone=int8_backbone)
        if self.multiview:
            if stereo_kwargs:
                raise ValueError(f"stereo-only model options at num_views={num_views}: "
                                 f"{sorted(stereo_kwargs)}")
            self.model = FeatRotationMultiView(**common)
            loss = MultiViewL1Loss(rel_weight=0.01, reference_decay=1.0)
        else:
            if stereo_kwargs.get("use_pallas_bn") == "residual":
                raise ValueError("use_pallas_bn='residual' is refused: on the card every train-mode "
                                 "BatchNorm runs the port's kernels")
            model_kwargs = {k: v for k, v in stereo_kwargs.items() if k not in PALLAS_OPTIONS}
            self.model = FeatRotationSymm(**common, **model_kwargs)
            loss = StereoL1Loss(rel_weight=0.01, reference_decay=1.0)
        self.metrics = IterationLoss(loss=loss, iter_decay=0.5)

    # -- step factories (extra keywords go to the port's factory, which
    #    checks its own)
    def make_train_step(self, optimizer: torch.optim.Optimizer, image_size: int, **kw: Any):
        """The train step of this workload's model (``train.make_train_step``
        or ``train.make_multiview_train_step``), in the workload's compute
        dtype unless ``compute_dtype`` is given; ``mesh`` (a data mesh) and
        the other keywords go to either factory."""
        from rot_mvgaze_tpu_torch.train import make_multiview_train_step, make_train_step

        kw.setdefault("compute_dtype", self.dtype)
        factory = make_multiview_train_step if self.multiview else make_train_step
        return factory(self.model, self.metrics, optimizer, image_size=image_size, **kw)

    def make_eval_step(self, image_size: int, **kw: Any):
        """The eval step of this workload's model (``train.make_eval_step``
        or ``train.make_multiview_eval_step``; ``mesh`` to either)."""
        from rot_mvgaze_tpu_torch.train import make_eval_step, make_multiview_eval_step

        factory = make_multiview_eval_step if self.multiview else make_eval_step
        return factory(self.model, image_size=image_size, **kw)

    # -- synthetic data
    def host_batch(self, rng: np.random.Generator, batch: int, size: int) -> Dict[str, np.ndarray]:
        if self.multiview:
            return make_multiview_host_batch(rng, batch, size, self.num_views)
        return make_host_batch(rng, batch, size)

    def init_data(self, size: int, batch: int = 2, device: Any = "cpu") -> Dict[str, torch.Tensor]:
        if self.multiview:
            return make_multiview_init_data(size, self.num_views, batch, device)
        return make_init_data(size, batch, device)

    def images_per_sample(self) -> int:
        return self.num_views
