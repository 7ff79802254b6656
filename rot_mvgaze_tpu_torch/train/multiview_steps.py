"""Train and eval steps of the V-view model (port of
``rot_mvgaze_tpu/train/multiview_steps.py``).

The contract and the options are the stereo steps' (``train/steps.py``),
over batches of ``data.multiview.MultiViewGazeDataset``::

    {"imgs": (B,V,H,W,3) uint8, "gt_gazes": (B,V,2), "head_poses": (B,V,2)}

All B·V views are augmented in one call, each row drawing its own
parameters from the step's ``torch.Generator``. The error is taken on view
0 (the reference's metric), and the previews ``img_0``/``img_1`` are views
0 and 1. ``grad_accum`` is not offered, as in the JAX package.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
from torch import nn

from rot_mvgaze_tpu_torch.augment.ops import eval_preprocess, train_preprocess
from rot_mvgaze_tpu_torch.geometry.gaze import rotation_matrix_2d
from rot_mvgaze_tpu_torch.train.steps import build_train_step, check_step_options, dp_shard, eval_forward


def prepare_multiview_rotations(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``head_poses`` (B,V,2) -> ``rots`` (B,V,3,3), and float32 labels."""
    return {
        "rots": rotation_matrix_2d(batch["head_poses"].float()),
        "gt_gazes": batch["gt_gazes"].float(),
    }


def _per_view(fn: Callable[[torch.Tensor], torch.Tensor], imgs: torch.Tensor) -> torch.Tensor:
    """``fn`` over the (B·V, H, W, 3) rows of (B, V, H, W, 3) ``imgs``,
    reshaped back to (B, V, ...)."""
    b, v = imgs.shape[0], imgs.shape[1]
    out = fn(imgs.reshape((b * v,) + tuple(imgs.shape[2:])))
    return out.reshape((b, v) + tuple(out.shape[1:]))


def make_multiview_train_step(
    model: nn.Module,
    metrics: Callable[[Dict[str, Any]], torch.Tensor],
    optimizer: torch.optim.Optimizer,
    image_size: int = 224,
    schedule: Optional[Callable[[int], float]] = None,
    compute_dtype: torch.dtype = torch.float32,
    augment: bool = True,
    ema_decay: float = 0.0,
    ema: Optional[Dict[str, torch.Tensor]] = None,
    freeze_bn: bool = False,
    with_images: bool = False,
    fold_key_by_step: bool = False,
    group: Any = None,
) -> Callable[..., Dict[str, Any]]:
    """Returns ``train_step(batch, generator=None, *, step) -> stats``, the
    stereo :func:`~rot_mvgaze_tpu_torch.train.steps.make_train_step`'s
    contract and options (``compute_dtype``, ``augment``, ``ema_decay``,
    ``freeze_bn``, ``with_images``, ``fold_key_by_step``, ``group``) over
    V-view batches (``imgs`` uint8, or float views already augmented when
    ``augment=False``, ``head_poses`` and ``gt_gazes``)."""
    check_step_options(compute_dtype, 1, ema_decay, ema)

    def prepare(mb, generator):
        views = mb["imgs"]
        if augment:
            shard = dp_shard(views.shape[0] * views.shape[1], group)
            views = _per_view(
                lambda x: train_preprocess(x, generator, image_size, compute_dtype, shard), views
            )
        data = {"imgs": views, **prepare_multiview_rotations(mb)}
        return data, {"img_0": views[:, 0], "img_1": views[:, 1]}, data["gt_gazes"][:, 0]

    return build_train_step(
        model, metrics, optimizer, prepare, "imgs", schedule=schedule,
        compute_dtype=compute_dtype, augment=augment, grad_accum=1, ema_decay=ema_decay,
        ema=ema, freeze_bn=freeze_bn, with_images=with_images, fold_key_by_step=fold_key_by_step,
        group=group,
    )


def make_multiview_eval_step(
    model: nn.Module, image_size: int = 224
) -> Callable[..., Dict[str, torch.Tensor]]:
    """Returns ``eval_step(batch, params=None) -> {pred_gaze, img_0,
    img_1}``, the stereo eval step's contract (float32, eval-mode BN,
    ``params`` in place of the module's) over V-view batches (``imgs``
    uint8, ``head_poses``); ``img_0``/``img_1`` are the first 8 rows of
    views 0 and 1."""

    @torch.inference_mode()
    def eval_step(
        batch: Dict[str, torch.Tensor], params: Optional[Dict[str, torch.Tensor]] = None
    ) -> Dict[str, torch.Tensor]:
        views = _per_view(lambda x: eval_preprocess(x, image_size), batch["imgs"])
        data = {"imgs": views, "rots": rotation_matrix_2d(batch["head_poses"].float())}
        out = eval_forward(model, data, params)
        return {"pred_gaze": out["pred_gaze"].float(), "img_0": views[:8, 0], "img_1": views[:8, 1]}

    return eval_step
