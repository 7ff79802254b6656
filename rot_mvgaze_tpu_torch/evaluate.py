"""Evaluation (port of the two-view part of ``rot_mvgaze_tpu/evaluate.py``).

The reference's protocol: the eval forward over a test loader (eval
preprocessing, BatchNorm on running statistics, float32), then the mean
angular error in degrees, computed on the host in float64 against the
loader's own labels. A ragged last batch runs as it is. The breakdown
groups the per-sample errors by camera (``idx_0 % 18``) and by subject
(``dataset.idx_to_kv``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from rot_mvgaze_tpu_torch.data.pairing import NUM_CAMERAS
from rot_mvgaze_tpu_torch.geometry.gaze import angular_error_numpy

#: the batch keys the eval forward reads
EVAL_KEYS = ("img_0", "img_1", "head_pose_0", "head_pose_1")


def eval_predictions(
    eval_step: Callable[..., Dict[str, torch.Tensor]],
    loader: Iterable,
    device: torch.device,
    params: Optional[Dict[str, torch.Tensor]] = None,
    on_batch: Optional[Callable[[int, Dict[str, torch.Tensor]], None]] = None,
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """One pass of ``eval_step`` (``make_eval_step``) over ``loader``'s numpy
    batches: ``(pred, gt, idx_0)``, predictions and the loader's labels in
    float64, and the ``idx_0`` column (None when a batch lacks it).
    ``on_batch(i, out)`` sees each batch's eval output."""
    preds, gts, idxs = [], [], []
    for i, batch in enumerate(loader):
        out = eval_step(
            {k: torch.from_numpy(np.asarray(batch[k])).to(device) for k in EVAL_KEYS}, params
        )
        preds.append(out["pred_gaze"].cpu().numpy().astype(np.float64))
        gts.append(np.asarray(batch["gt_gaze"], dtype=np.float64))
        if "idx_0" in batch:
            idxs.append(np.asarray(batch["idx_0"]).reshape(-1))
        if on_batch is not None:
            on_batch(i, out)
    if not preds:
        raise ValueError("the eval loader yielded no batches")
    idx_0 = np.concatenate(idxs).astype(np.int64) if len(idxs) == len(preds) else None
    return np.concatenate(preds), np.concatenate(gts), idx_0


def evaluate_gaze(
    model: nn.Module,
    loader: Iterable,
    image_size: int = 224,
    params: Optional[Dict[str, torch.Tensor]] = None,
) -> float:
    """Mean angular error (degrees, float64 on the host) over a test loader."""
    return evaluate_gaze_detailed(model, loader, image_size=image_size, params=params)["mean_error"]


def evaluate_gaze_detailed(
    model: nn.Module,
    loader: Iterable,
    *,
    dataset: Any = None,
    image_size: int = 224,
    params: Optional[Dict[str, torch.Tensor]] = None,
) -> Dict[str, Any]:
    """The eval protocol and its breakdown (:func:`breakdown_from_errors`)
    over ``loader``, on the model's device and with its parameters (or
    ``params``, e.g. a moving average, by ``named_parameters`` name).
    ``per_subject`` needs ``dataset`` and a loader that yields it in order."""
    from rot_mvgaze_tpu_torch.train.steps import make_eval_step  # train imports this module

    device = next(model.parameters()).device
    pred, gt, idx_0 = eval_predictions(make_eval_step(model, image_size), loader, device, params)
    return breakdown_from_errors(angular_error_numpy(pred, gt), idx_0=idx_0, dataset=dataset)


def breakdown_from_errors(
    errors: np.ndarray,
    idx_0: "np.ndarray | None" = None,
    dataset: Any = None,
    rows: "np.ndarray | None" = None,
) -> Dict[str, Any]:
    """``{"mean_error", "n", "per_camera", "per_subject"}`` of per-sample
    angular errors. ``per_camera`` groups by ``idx_0 % 18``; ``per_subject``
    by ``dataset.idx_to_kv[row][0]``, where ``rows`` are the dataset rows of
    the errors in order, or, without ``rows``, a full pass in dataset order
    is assumed. Each group is ``{"error": mean degrees, "n": count}``."""

    def group_stats(labels):
        out = {}
        for lab in sorted(set(labels.tolist())):
            m = labels == lab
            out[lab] = {"error": float(np.mean(errors[m])), "n": int(np.sum(m))}
        return out

    result: Dict[str, Any] = {
        "mean_error": float(np.mean(errors)),
        "n": int(errors.shape[0]),
        "per_camera": None,
        "per_subject": None,
    }
    if idx_0 is not None and idx_0.shape[0] == errors.shape[0]:
        result["per_camera"] = group_stats(np.asarray(idx_0).reshape(-1) % NUM_CAMERAS)
    if dataset is not None and hasattr(dataset, "idx_to_kv"):
        if rows is not None and rows.shape[0] == errors.shape[0]:
            subjects = np.asarray([dataset.idx_to_kv[int(r)][0] for r in rows])
            result["per_subject"] = group_stats(subjects)
        elif len(dataset.idx_to_kv) == errors.shape[0]:
            subjects = np.asarray([kv[0] for kv in dataset.idx_to_kv[: errors.shape[0]]])
            result["per_subject"] = group_stats(subjects)
    return result


def format_breakdown(detail: Dict[str, Any]) -> str:
    """The breakdown as the text block appended to ``test_results.txt``."""
    lines = [f"mean error: {detail['mean_error']:.4f} deg over {detail['n']} samples"]
    for group in ("per_camera", "per_subject"):
        stats = detail.get(group)
        if not stats:
            continue
        lines.append(f"{group}:")
        for lab, s in stats.items():
            lines.append(f"  {lab}: {s['error']:.4f} deg (n={s['n']})")
    return "\n".join(lines) + "\n"
