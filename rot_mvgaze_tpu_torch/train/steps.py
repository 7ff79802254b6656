"""The train and eval step factories (port of ``rot_mvgaze_tpu/train/steps.py``).

One train step is the whole per-update pipeline on the device: augmentation
of both uint8 views, head pose -> SO(3), the train forward (backbone and
lifter once per view, so BatchNorm statistics stay per view), the loss,
backward, an Adam update with the learning rate set from the schedule, and
the parameters' moving average. Parameters and buffers live in the
``nn.Module``, moments in the ``torch.optim.Adam``; the update count (the
JAX package's ``state.step``) is the caller's and is passed in. The step
runs under autocast in the compute dtype (bf16 for the JAX CLI's
``--bf16``) with float32 parameters; the custom ops cast at their own
boundaries.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from rot_mvgaze_tpu_torch.augment.ops import eval_preprocess, train_preprocess
from rot_mvgaze_tpu_torch.geometry.gaze import angular_error, rotation_matrix_2d
from rot_mvgaze_tpu_torch.parallel.mesh import Mesh, dp_size, shard_batch


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
    group: Any = None,
) -> Dict[str, torch.Tensor]:
    """The train stack on both uint8 views, view 0's draws first. Under a
    process ``group`` the draws are the global batch's and this rank's rows
    of them are applied (:func:`dp_shard`)."""
    return {
        view: train_preprocess(batch[view], generator, image_size, dtype,
                               dp_shard(batch[view].shape[0], group))
        for view in ("img_0", "img_1")
    }


def dp_shard(rows: int, group: Any) -> Optional[tuple]:
    """``(offset, total)`` of this rank's ``rows`` in the global batch of a
    process ``group`` (every rank holding as many), or None without one."""
    if group is None:
        return None
    return group.rank() * rows, group.size() * rows


def fold_seed(base: int, count: int) -> int:
    """A 64-bit seed that is a function of ``(base, count)`` alone: the
    counterpart of ``jax.random.fold_in(key, count)``, through numpy's
    ``SeedSequence`` hash."""
    return int(np.random.SeedSequence([base, count]).generate_state(1, np.uint64)[0])


def init_ema(model: nn.Module) -> Dict[str, torch.Tensor]:
    """A copy of the model's parameters (by ``named_parameters`` name), the
    moving average's starting point."""
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def update_ema(
    ema: Optional[Dict[str, torch.Tensor]], model: nn.Module, ema_decay: float
) -> None:
    """One moving-average step in place, ``ema <- ema*d + params*(1-d)``
    over the parameters (nothing when ``ema_decay`` is 0; otherwise ``ema``
    is a dict from :func:`init_ema`, as :func:`make_train_step` checks)."""
    if not ema_decay:
        return
    params = dict(model.named_parameters())
    avg = list(ema.values())
    torch._foreach_mul_(avg, ema_decay)
    torch._foreach_add_(avg, torch._foreach_mul([params[n].detach() for n in ema], 1.0 - ema_decay))


def _float_predictions(out: Dict[str, Any]) -> Dict[str, Any]:
    """The output dict with every ``pred_gaze*`` in float32, so the loss is
    taken in float32 whatever the compute dtype."""
    def cast(d):
        return {
            k: (v.float() if k.startswith("pred_gaze") else v) for k, v in d.items()
        }

    return {k: (cast(v) if k.startswith("iter_") else v) for k, v in cast(out).items()}


def make_train_step(
    model: nn.Module,
    metrics: Callable[[Dict[str, Any]], torch.Tensor],
    optimizer: torch.optim.Optimizer,
    image_size: int = 224,
    schedule: Optional[Callable[[int], float]] = None,
    compute_dtype: torch.dtype = torch.float32,
    augment: bool = True,
    grad_accum: int = 1,
    ema_decay: float = 0.0,
    ema: Optional[Dict[str, torch.Tensor]] = None,
    freeze_bn: bool = False,
    with_images: bool = False,
    fold_key_by_step: bool = False,
    group: Any = None,
    mesh: Optional[Mesh] = None,
) -> Callable[..., Dict[str, Any]]:
    """Returns ``train_step(batch, generator=None, *, step) -> stats``.

    ``batch`` holds uint8 ``img_0``/``img_1`` (B, H, W, 3), or float views
    already augmented when ``augment=False``, and float ``head_pose_0``,
    ``head_pose_1``, ``gt_gaze``, ``gt_gaze_1`` (B, 2), on the model's
    device. ``generator`` is a ``torch.Generator`` on that device, the source
    of every augmentation draw (unused when ``augment=False``). ``step`` is
    the number of updates made before this one: the schedule's count. The
    returned ``stats`` hold ``loss_gaze`` and ``error_gaze`` (mean angular
    error of ``pred_gaze`` in degrees) as 0-d float32 tensors on the device,
    ``lr``, the rate of this update, and the step's ``pred_gaze`` (B, 2),
    detached.

    ``compute_dtype`` bfloat16 runs the forward under bf16 autocast and the
    augmentation in bf16, as the JAX CLI's bf16 model does; float32 runs
    everything in float32.

    Options, as the JAX step's:

    - ``grad_accum=A``: micro-batch ``a`` takes rows ``a::A``; each
      normalises with its own statistics and moves the running statistics
      once, in order; the gradients are summed, then divided by A, before
      one update; loss and error are the micro-batches' mean.
    - ``ema_decay=d``: after the update, ``ema <- ema*d + params*(1-d)`` in
      place over ``ema`` (a dict from :func:`init_ema`, owned by the caller).
    - ``freeze_bn``: the model runs in eval mode inside the step, so every
      BatchNorm normalises with its running statistics and leaves them (and
      ``num_batches_tracked``) as they are; its affine parameters still
      learn. No train-mode BatchNorm kernel runs.
    - ``with_images``: ``stats`` also hold the first 8 rows of both
      augmented views, float32 (micro-batch 0's under ``grad_accum``).
    - ``fold_key_by_step``: the draws come from a generator reseeded every
      step with ``fold_seed(generator.initial_seed(), step)``, so they are a
      function of the base seed and the update count, and a resumed run
      draws what the uninterrupted run drew; ``generator`` itself is not
      advanced.
    - ``group``: data parallelism over a ``torch.distributed`` process
      group. ``batch`` is this rank's share of the global batch (the ranks'
      batches concatenated in rank order, each as large). The augmentation
      draws are the global batch's (every rank's generator holds the same
      seed) and this rank applies its rows of them; every BatchNorm takes
      the global batch's statistics (the caller sets the model's group:
      ``parallel.set_batchnorm_group``); after the backward the gradients
      are averaged over the ranks by one all-reduce of their flattened
      concatenation, and ``loss_gaze`` / ``error_gaze`` are the global
      means. Under ``grad_accum`` micro-batch ``a`` is rows ``a::A`` of
      each rank's batch, which together are rows ``a::A`` of the global
      batch.
    - ``mesh``: a device mesh of this process (``parallel.make_mesh``),
      whose first device holds the model and the batch. The augmentation
      runs there, once, at full height, with the draws it takes without a
      mesh; then each view's rows split over the data replicas and each
      replica's height into strips over its group (``parallel.shard_batch``,
      the counterpart of JAX's ``pin_images``), each micro-batch under
      ``grad_accum``. The model needs its spatial floor on a 2-D mesh
      (``parallel.with_spatial_floor``). The previews are full height.
    """
    check_step_options(compute_dtype, grad_accum, ema_decay, ema)

    def prepare(mb, generator):
        if augment:
            imgs = augment_views(generator, mb, image_size, compute_dtype, group)
        else:
            imgs = {"img_0": mb["img_0"], "img_1": mb["img_1"]}
        data = {**shard_batch(imgs, mesh), **prepare_rotations(mb)}
        return data, imgs, data["gt_gaze"]

    return build_train_step(
        model, metrics, optimizer, prepare, "img_0", schedule=schedule,
        compute_dtype=compute_dtype, augment=augment, grad_accum=grad_accum,
        ema_decay=ema_decay, ema=ema, freeze_bn=freeze_bn, with_images=with_images,
        fold_key_by_step=fold_key_by_step, group=group,
    )


def check_step_options(compute_dtype, grad_accum, ema_decay, ema) -> None:
    """The checks shared by the step factories: ``ValueError`` on a bad
    option."""
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype}")
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    if not 0.0 <= ema_decay < 1.0:
        raise ValueError(f"ema_decay must be in [0, 1), got {ema_decay}")
    if ema_decay and ema is None:
        raise ValueError("ema_decay > 0 needs an EMA dict (init_ema) to update")


def build_train_step(
    model: nn.Module,
    metrics: Callable[[Dict[str, Any]], torch.Tensor],
    optimizer: torch.optim.Optimizer,
    prepare: Callable[..., Any],
    rows_key: str,
    *,
    schedule: Optional[Callable[[int], float]],
    compute_dtype: torch.dtype,
    augment: bool,
    grad_accum: int,
    ema_decay: float,
    ema: Optional[Dict[str, torch.Tensor]],
    freeze_bn: bool,
    with_images: bool,
    fold_key_by_step: bool,
    group: Any = None,
) -> Callable[..., Dict[str, Any]]:
    """The step of :func:`make_train_step` over any model input:
    ``prepare(micro_batch, generator)`` returns the model's input dict, the
    two preview views ``{"img_0", "img_1"}`` (B, S, S, 3) and the view-0
    labels the error is taken against; ``batch[rows_key]`` counts the
    batch's rows. ``group``: data parallelism (:func:`make_train_step`)."""
    first = next(iter(model.parameters()))
    folded: Dict[torch.device, torch.Generator] = {}

    def micro_step(mb, generator):
        """Forward and backward of one micro-batch: (loss, error, pred_gaze,
        preview views)."""
        data, imgs, gt = prepare(mb, generator)
        with torch.autocast(
            first.device.type, dtype=compute_dtype, enabled=compute_dtype != torch.float32
        ):
            out = model(data)
        loss = metrics(_float_predictions(out))
        loss.backward()
        with torch.no_grad():
            error = angular_error(out["pred_gaze"].float(), gt).mean()
        return loss.detach(), error, out["pred_gaze"].detach(), imgs

    def train_step(
        batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None, *, step: int
    ) -> Dict[str, Any]:
        if augment and generator is None:
            raise ValueError("augment=True needs a torch.Generator on the model's device")
        if augment and fold_key_by_step:
            base, device = generator.initial_seed(), generator.device
            if device not in folded:
                folded[device] = torch.Generator(device)
            generator = folded[device]
            generator.manual_seed(fold_seed(base, step))
        rows = batch[rows_key].shape[0]
        if rows % grad_accum:
            raise ValueError(f"batch of {rows} rows does not split into {grad_accum} micro-batches")
        model.train(not freeze_bn)
        optimizer.zero_grad(set_to_none=True)
        pred = None
        for a in range(grad_accum):
            mb = batch if grad_accum == 1 else {k: v[a::grad_accum] for k, v in batch.items()}
            loss_a, error_a, pred_a, imgs = micro_step(mb, generator)
            if a == 0:
                loss, error = loss_a, error_a
                if with_images:
                    images = {v: imgs[v][:8].float() for v in ("img_0", "img_1")}
                pred = pred_a if grad_accum == 1 else pred_a.new_empty((rows, 2))
            else:
                loss, error = loss + loss_a, error + error_a
            if grad_accum > 1:
                pred[a::grad_accum] = pred_a
        if grad_accum > 1:
            # sum, then divide, as the JAX step does
            torch._foreach_div_([p.grad for p in model.parameters() if p.grad is not None], grad_accum)
            loss, error = loss / grad_accum, error / grad_accum
        if group is not None:
            loss, error = average_over_ranks(model, loss, error, rows, group)
        if schedule is not None:
            lr = schedule(step)
            for param_group in optimizer.param_groups:
                param_group["lr"] = lr
        lr = optimizer.param_groups[0]["lr"]
        optimizer.step()
        update_ema(ema, model, ema_decay)
        stats = {"loss_gaze": loss, "error_gaze": error, "lr": lr, "pred_gaze": pred}
        if with_images:
            stats.update(images)
        return stats

    return train_step


def average_over_ranks(model: nn.Module, loss: torch.Tensor, error: torch.Tensor, rows: int,
                       group: Any) -> tuple:
    """Data parallelism's end of the backward: every gradient averaged over
    the ranks of ``group`` in place, by one all-reduce of their flattened
    concatenation, and the global means of ``loss`` and ``error``. One flat
    all-reduce rather than DDP: it runs after the whole backward, so it
    composes with ``grad_accum`` (no ``no_sync``), with ``remat``'s
    recompute and with parameters shared across iterations, and its sum
    order is fixed. A parameter without a gradient (the backbone's unused
    ``fc``) keeps none, as in one process, so that Adam leaves it alone; the
    ranks run one graph, so they lay the buffer out alike. Asserts (on the
    device) that every rank's batch has ``rows`` rows, which the global
    statistics and augmentation take for granted."""
    world = group.size()
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    flat = torch.cat([g.reshape(-1).float() for g in grads]
                     + [torch.stack([loss.float(), error.float(),
                                     torch.tensor(float(rows), device=loss.device)])])
    torch.distributed.all_reduce(flat, group=group)
    offset = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[offset:offset + n].view_as(g) / world)
        offset += n
    loss_sum, error_sum, total_rows = flat[offset:]
    # checked on the device, without a wait for the host
    torch._assert_async(total_rows == world * rows)
    return loss_sum / world, error_sum / world


def make_eval_step(model: nn.Module, image_size: int = 224,
                   mesh: Optional[Mesh] = None) -> Callable[..., Dict[str, torch.Tensor]]:
    """Returns ``eval_step(batch, params=None) -> {pred_gaze, img_0, img_1}``.

    ``batch`` holds uint8 ``img_0``/``img_1`` and float head poses on the
    model's device. The model runs in eval mode (BatchNorm on its running
    statistics, both views in one backbone batch) in float32 with autocast
    off, whatever the training compute dtype, so the metric does not absorb
    bf16 rounding. ``params`` (by ``named_parameters`` name, e.g. the
    moving average) replace the module's own parameters for this call.
    ``img_0``/``img_1`` are the first 8 preprocessed rows, for previews.
    ``mesh``: the preprocessed views are cut over it as in
    :func:`make_train_step` (a batch that does not split over the data
    replicas is padded by repeating its last row, and the padding's
    predictions dropped)."""

    @torch.inference_mode()
    def eval_step(
        batch: Dict[str, torch.Tensor], params: Optional[Dict[str, torch.Tensor]] = None
    ) -> Dict[str, torch.Tensor]:
        imgs = {v: eval_preprocess(batch[v], image_size) for v in ("img_0", "img_1")}
        rots = {"rot_0": rotation_matrix_2d(batch["head_pose_0"].float()),
                "rot_1": rotation_matrix_2d(batch["head_pose_1"].float())}
        rows = imgs["img_0"].shape[0]
        previews = {v: imgs[v][:8] for v in ("img_0", "img_1")}
        imgs, rots = pad_to_replicas(imgs, mesh), pad_to_replicas(rots, mesh)
        out = eval_forward(model, {**shard_batch(imgs, mesh), **rots}, params)
        return {"pred_gaze": out["pred_gaze"][:rows].float(), **previews}

    return eval_step


def pad_to_replicas(tensors: Dict[str, torch.Tensor], mesh: Optional[Mesh]) -> Dict[str, torch.Tensor]:
    """``tensors`` (leading axis: samples) padded by repeating the last
    sample to a multiple of the mesh's data replicas; unchanged where they
    already split. The eval steps drop the padding's predictions."""
    rows = next(iter(tensors.values())).shape[0]
    pad = -rows % dp_size(mesh)
    if not pad:
        return tensors
    return {k: torch.cat([v, v[-1:].expand(pad, *v.shape[1:])]) for k, v in tensors.items()}


def make_single_view_eval_step(
    model: nn.Module, image_size: int = 224
) -> Callable[..., Dict[str, torch.Tensor]]:
    """Returns ``eval_step(batch, params=None) -> {pred_gaze}`` of a
    ``SingleViewGazeNet``: ``img_0`` alone, through the eval stack and the
    float32 eval-mode forward."""

    @torch.inference_mode()
    def eval_step(batch, params=None):
        data = {"img_0": eval_preprocess(batch["img_0"], image_size)}
        return {"pred_gaze": eval_forward(model, data, params)["pred_gaze"].float()}

    return eval_step


def eval_forward(
    model: nn.Module, data: Dict[str, torch.Tensor], params: Optional[Dict[str, torch.Tensor]] = None
) -> Dict[str, Any]:
    """The model's eval-mode forward in float32 with autocast off, with
    ``params`` (by ``named_parameters`` name) in place of its own when
    given."""
    model.eval()
    device = next(v for v in data.values() if isinstance(v, torch.Tensor)).device
    with torch.autocast(device.type, enabled=False):
        if params is None:
            return model(data)
        return torch.func.functional_call(model, params, (data,))
