"""Ahead-of-time serving artifacts on ``torch.export`` (port of
``rot_mvgaze_tpu/export.py``).

- :func:`export_serving_artifact` traces the serving forward that the live
  predictors run (``serving.make_serving_forward`` or
  ``make_multiview_serving_forward``: uint8 views -> preprocessing -> model
  -> float32 pitchyaw) at a fixed micro-batch and image size, and saves the
  ``ExportedProgram`` (``torch.export.save``) with a JSON sidecar
  (``<path>.json``: the model's configuration keys, ``micro_batch``,
  ``image_size``, ``num_views`` for a V-view artifact, the state's names,
  shapes and dtypes in the program's order, and the model's state-dict
  keys).
- :class:`AotGazePredictor` serves an artifact with a checkpoint, in the
  artifact's fixed micro-batches (the last one padded), like the live
  predictors.

As in the JAX package, the artifact holds no weights: the program takes the
model's parameters and buffers as its first input (the forward runs under
``torch.func.functional_call``), so one artifact serves every checkpoint of
its architecture and the file stays small. The fuser is one node, the
operator ``mvgaze::rotate_concat_matmul_relu`` (``ops/fusion.py``), which
runs the fuser's CUDA kernel when the program runs on the card: loading an
artifact needs that module imported (this one imports it), but not the
model's code. Static int8 is refused: its calibrated ranges are live
serving state. Dynamic int8, bf16 and float32 export. A program traced on
one device type runs on that device type.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

import rot_mvgaze_tpu_torch.ops.fusion  # noqa: F401  (registers mvgaze::rotate_concat_matmul_relu)
from rot_mvgaze_tpu_torch.compat.convert import load_checkpoint
from rot_mvgaze_tpu_torch.models.multiview import FeatRotationMultiView
from rot_mvgaze_tpu_torch.serving import (
    MODEL_CONFIG_KEYS,
    _validate_stacked_views,
    _validate_views,
    make_multiview_serving_forward,
    make_serving_forward,
)
from rot_mvgaze_tpu_torch.utils.device import resolve_device
from rot_mvgaze_tpu_torch.utils.padding import iter_padded_microbatches


class _StatelessForward(nn.Module):
    """Root module of the export: holds no parameters (the forward's model
    is reached through a closure), so every weight is an input."""

    def __init__(self, forward) -> None:
        super().__init__()
        self._forward = forward

    def forward(self, state: Dict[str, torch.Tensor], *request: torch.Tensor) -> torch.Tensor:
        return self._forward(state, *request)


def model_state(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's state-dict entries, one per distinct tensor (an aliased
    module's, as under ``share_weights``, by its first name: the aliases
    are the same module, so replacing one replaces all), detached."""
    keys = set(model.state_dict().keys())
    named = list(model.named_parameters()) + list(model.named_buffers())
    return {k: v.detach() for k, v in named if k in keys}


def _example_request(micro_batch: int, image_size: int, num_views: Optional[int], device) -> Tuple[torch.Tensor, ...]:
    s = image_size
    if num_views is not None:
        return (torch.zeros((micro_batch, num_views, s, s, 3), dtype=torch.uint8, device=device),
                torch.zeros((micro_batch, num_views, 2), dtype=torch.float32, device=device))
    img = torch.zeros((micro_batch, s, s, 3), dtype=torch.uint8, device=device)
    pose = torch.zeros((micro_batch, 2), dtype=torch.float32, device=device)
    return img, img.clone(), pose, pose.clone()


def export_serving_artifact(
    model: nn.Module,
    path: str,
    micro_batch: int = 64,
    image_size: int = 224,
    num_views: Optional[int] = None,
) -> torch.export.ExportedProgram:
    """Trace and save the serving forward of ``model`` (in eval mode, on its
    device and in its dtype: its state gives the program's input shapes and
    dtypes, not values); returns the ``ExportedProgram``. A
    ``FeatRotationMultiView`` exports the stacked V-view forward and needs
    ``num_views`` >= 2, which is part of the artifact's fixed shape."""
    if getattr(model, "int8_backbone", False) == "static":
        raise ValueError(
            "static-int8 models cannot be exported: the calibrated activation ranges are "
            "live-serving state that checkpoint loaders do not reconstruct. Export the "
            "dynamic int8 graph (int8=True) or bf16/f32 instead."
        )
    is_multiview = isinstance(model, FeatRotationMultiView)
    if is_multiview:
        if num_views is None or num_views < 2:
            raise ValueError("exporting a FeatRotationMultiView needs num_views >= 2 (V is part of "
                             "the artifact's fixed request shape)")
        forward = make_multiview_serving_forward(model, image_size)
    elif num_views is not None:
        raise ValueError("num_views applies only to FeatRotationMultiView exports; the two-view "
                         "model's request shape is fixed")
    else:
        forward = make_serving_forward(model, image_size)
    if model.training:
        raise ValueError("export a model in eval mode (serving runs eval BatchNorm)")
    state = model_state(model)
    device = next(iter(state.values())).device
    request = _example_request(micro_batch, image_size, num_views, device)
    with torch.no_grad():
        program = torch.export.export(_StatelessForward(forward), (state, *request), strict=False)
    program.example_inputs = None  # they hold the weights; the artifact must not
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.export.save(program, path)
    meta: Dict[str, Any] = {k: getattr(model, k) for k in MODEL_CONFIG_KEYS if hasattr(model, k)}
    meta.update(
        micro_batch=micro_batch,
        image_size=image_size,
        device=device.type,
        state=[[k, list(v.shape), str(v.dtype).removeprefix("torch.")] for k, v in state.items()],
        state_dict_keys=list(model.state_dict().keys()),
    )
    if is_multiview:
        meta["num_views"] = num_views
    with open(path + ".json", "w") as f:
        json.dump(meta, f, indent=1)
    return program


def load_serving_artifact(path: str) -> torch.export.ExportedProgram:
    """The saved ``ExportedProgram`` (needs ``ops/fusion.py``'s operator,
    which importing this module registers)."""
    return torch.export.load(path)


class AotGazePredictor:
    """Serves an exported artifact with a checkpoint.

    The checkpoint (a reference ``.pth.tar``, the port's, or a JAX
    ``.msgpack``, converted with the sidecar's configuration) must hold
    exactly the model's state-dict keys and every tensor of the artifact's
    state at its shape; each is cast to the artifact's dtype. Requests are the live predictor's: stereo
    ``predict(img_0, img_1, head_pose_0, head_pose_1)``, V-view
    ``predict(imgs, head_poses)``, at the artifact's image size, any N in
    its fixed micro-batches."""

    def __init__(self, artifact_path: str, checkpoint: str, device: Any = "cuda") -> None:
        self.device = resolve_device(device)
        sidecar = artifact_path + ".json"
        if not os.path.exists(sidecar):
            raise FileNotFoundError(f"an artifact needs its {sidecar} sidecar, written by "
                                    "export_serving_artifact")
        with open(sidecar) as f:
            self.meta = meta = json.load(f)
        if meta["device"] != self.device.type:
            raise ValueError(f"the artifact was traced on {meta['device']}; it cannot serve on "
                             f"{self.device.type}")
        self.micro_batch = int(meta["micro_batch"])
        self.image_size = int(meta["image_size"])
        self.num_views = meta.get("num_views")
        self.request_fields = (("imgs", "head_poses") if self.num_views
                               else ("img_0", "img_1", "head_pose_0", "head_pose_1"))
        config = {k: meta[k] for k in MODEL_CONFIG_KEYS if k in meta}
        loaded = load_checkpoint(checkpoint, **config)
        missing = set(meta["state_dict_keys"]) - set(loaded)
        unexpected = set(loaded) - set(meta["state_dict_keys"])
        if missing or unexpected:
            raise ValueError(f"checkpoint lacks {len(missing)} of the artifact's keys and has {len(unexpected)} "
                             f"it does not take (e.g. {sorted(missing or unexpected)[0]!r}): wrong "
                             "checkpoint for this artifact?")
        state: Dict[str, torch.Tensor] = {}
        for key, shape, dtype in meta["state"]:
            value = loaded[key]
            if list(value.shape) != shape:
                raise ValueError(f"checkpoint {key!r} has shape {list(value.shape)}, the artifact "
                                 f"takes {shape}: wrong checkpoint for this artifact?")
            # dense, 4-D weights channels_last, as the live predictor holds them
            fmt = torch.channels_last if value.dim() == 4 else torch.contiguous_format
            state[key] = value.to(device=self.device, dtype=getattr(torch, dtype)).contiguous(memory_format=fmt)
        self.state = state
        self.program = load_serving_artifact(artifact_path).module()

    def validate_request(self, *args: np.ndarray, image_size: "int | None" = None) -> int:
        if self.num_views:
            return _validate_stacked_views(*args, num_views=self.num_views, image_size=self.image_size)
        return _validate_views(*args, image_size=self.image_size)

    def predict(self, *args: np.ndarray) -> np.ndarray:
        if len(args) != len(self.request_fields):
            raise ValueError(f"this artifact serves ({', '.join(self.request_fields)}) requests: "
                             f"predict takes {len(self.request_fields)} arrays, got {len(args)}")
        n = self.validate_request(*args)
        if n == 0:
            return np.zeros((0, 2), np.float32)
        outs: List[np.ndarray] = []
        for padded, rows in iter_padded_microbatches(args, self.micro_batch):
            outs.append(self._run(padded)[:rows])
        return np.concatenate(outs, axis=0)

    @torch.no_grad()
    def _run(self, request: Tuple[np.ndarray, ...]) -> np.ndarray:
        tensors = tuple(
            torch.from_numpy(np.ascontiguousarray(a, np.uint8 if a.ndim >= 4 else np.float32)).to(self.device)
            for a in map(np.asarray, request)
        )
        return self.program(self.state, *tensors).cpu().numpy()
