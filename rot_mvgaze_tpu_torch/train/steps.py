"""The train step factory (port of ``make_train_step`` and its helpers in
``rot_mvgaze_tpu/train/steps.py``).

One step is the whole per-update pipeline on the device: augmentation of
both uint8 views, head pose -> SO(3), the train forward (backbone and lifter
once per view, so BatchNorm statistics stay per view), the loss, backward,
and an Adam update with the learning rate set from the schedule. Parameters
and buffers live in the ``nn.Module``, moments in the ``torch.optim.Adam``:
there is no state tree to thread through. The step runs under autocast in
the compute dtype (bf16 for the JAX CLI's ``--bf16``) with float32
parameters; the custom ops cast at their own boundaries.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from rot_mvgaze_tpu_torch.augment.ops import train_preprocess
from rot_mvgaze_tpu_torch.geometry.gaze import angular_error, rotation_matrix_2d


def prepare_rotations(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Head poses -> rotation matrices, and float32 labels."""
    return {
        "rot_0": rotation_matrix_2d(batch["head_pose_0"].float()),
        "rot_1": rotation_matrix_2d(batch["head_pose_1"].float()),
        "gt_gaze": batch["gt_gaze"].float(),
        "gt_gaze_1": batch["gt_gaze_1"].float(),
    }


def augment_views(
    generator: torch.Generator,
    batch: Dict[str, torch.Tensor],
    image_size: int,
    dtype: torch.dtype = torch.float32,
) -> Dict[str, torch.Tensor]:
    """The train stack on both uint8 views, view 0's draws first."""
    return {
        view: train_preprocess(batch[view], generator, image_size, dtype)
        for view in ("img_0", "img_1")
    }


def _float_predictions(out: Dict[str, Any]) -> Dict[str, Any]:
    """The output dict with every ``pred_gaze*`` in float32, so the loss is
    taken in float32 whatever the compute dtype."""
    def cast(d):
        return {
            k: (v.float() if k.startswith("pred_gaze") else v) for k, v in d.items()
        }

    return {k: (cast(v) if k.startswith("iter_") else v) for k, v in cast(out).items()}


def make_train_step(
    model: torch.nn.Module,
    metrics: Callable[[Dict[str, Any]], torch.Tensor],
    optimizer: torch.optim.Optimizer,
    image_size: int = 224,
    schedule: Optional[Callable[[int], float]] = None,
    compute_dtype: torch.dtype = torch.float32,
    augment: bool = True,
    grad_accum: int = 1,
    ema_decay: float = 0.0,
    freeze_bn: bool = False,
    with_images: bool = False,
    fold_key_by_step: bool = False,
) -> Callable[[Dict[str, torch.Tensor], Optional[torch.Generator]], Dict[str, Any]]:
    """Returns ``train_step(batch, generator) -> stats``.

    ``batch`` holds uint8 ``img_0``/``img_1`` (B, H, W, 3), or float views
    already augmented when ``augment=False``, and float ``head_pose_0``,
    ``head_pose_1``, ``gt_gaze``, ``gt_gaze_1`` (B, 2), on the model's
    device. ``generator`` is a ``torch.Generator`` on that device, the source
    of every augmentation draw (unused when ``augment=False``). ``stats``
    holds ``loss_gaze`` and ``error_gaze`` (mean angular error of
    ``pred_gaze`` in degrees) as 0-d float32 tensors on the device, and
    ``lr``, the rate of this update, ``schedule(count)`` with ``count`` the
    updates made before it (the optimizer's own step count), and the step's
    ``pred_gaze`` (B, 2), detached.

    ``compute_dtype`` bfloat16 runs the forward under bf16 autocast and the
    augmentation in bf16, as the JAX CLI's bf16 model does; float32 runs
    everything in float32.
    """
    for name, on in (
        ("grad_accum > 1", grad_accum != 1),
        ("ema_decay", bool(ema_decay)),
        ("freeze_bn", freeze_bn),
        ("with_images", with_images),
        ("fold_key_by_step", fold_key_by_step),
    ):
        if on:
            raise NotImplementedError(f"{name} is not ported yet (ROADMAP A7)")
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype}")
    first = next(iter(model.parameters()))

    def update_count() -> int:
        state = optimizer.state.get(optimizer.param_groups[0]["params"][0], {})
        return int(state["step"]) if "step" in state else 0

    def train_step(
        batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None
    ) -> Dict[str, Any]:
        device = first.device
        if augment:
            if generator is None:
                raise ValueError("augment=True needs a torch.Generator on the model's device")
            imgs = augment_views(generator, batch, image_size, compute_dtype)
        else:
            imgs = {"img_0": batch["img_0"], "img_1": batch["img_1"]}
        data = {**imgs, **prepare_rotations(batch)}

        model.train()
        with torch.autocast(
            device.type, dtype=compute_dtype, enabled=compute_dtype != torch.float32
        ):
            out = model(data)
        loss = metrics(_float_predictions(out))
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if schedule is not None:
            lr = schedule(update_count())
            for group in optimizer.param_groups:
                group["lr"] = lr
        lr = optimizer.param_groups[0]["lr"]
        optimizer.step()
        with torch.no_grad():
            error = angular_error(out["pred_gaze"].float(), data["gt_gaze"]).mean()
        return {
            "loss_gaze": loss.detach(), "error_gaze": error, "lr": lr,
            "pred_gaze": out["pred_gaze"].detach(),
        }

    return train_step
