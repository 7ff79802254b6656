"""Batch inference / serving API (port of ``rot_mvgaze_tpu/serving.py``,
single card).

- :class:`GazePredictor` serves the two-view ``FeatRotationSymm`` with
  every ablation: a reference ``.pth.tar``, the port's checkpoint or a JAX
  ``.msgpack`` (``compat.load_checkpoint``), any request size in fixed
  micro-batches (the last one padded by repeating its last row), bf16 by
  default, pitchyaw out in float32. Images at another resolution than
  ``image_size`` are resized on the device (the antialiased resize).
- :class:`MultiViewGazePredictor` serves the V-view
  ``FeatRotationMultiView`` on stacked ``(N, V, H, W, 3)`` requests; any
  stereo checkpoint loads at any V.
- ``int8=True`` runs the backbone's convs on the int8 path with dynamic
  activation scales, ``int8="static"`` with calibrated ones
  (``models/resnet.py::QuantConv2d``): calibrated by :meth:`calibrate`, or
  on the first request, and kept in a calibration file in the JAX package's
  format (``{"quant": {<conv path>: {"act_amax": ...}}}``), so a file that
  either package wrote loads in the other.
- :class:`BatchingPredictor` coalesces concurrent callers' requests into
  shared micro-batches on one dispatcher thread.

:func:`make_serving_forward` and :func:`make_multiview_serving_forward` are
the pure forwards that the predictors run and that ``export.py`` traces.
Requests are NHWC uint8 images and head poses, as in the JAX package. The
predictors run on the card (``device="cuda"``) unless the caller asks for
the CPU; with no card, the default raises.

``mesh=`` (``parallel.make_mesh``) serves over a device mesh, as the JAX
predictors do: the micro-batch rounds up to a multiple of the data axis,
each micro-batch's rows split over the data replicas (one copy of the model
per distinct device, one host thread per replica where the replicas' cards
differ), and on a 2-D mesh each replica's views are cut into height strips
over its spatial group (the backbone's floor set, ``image_size`` divisible
by the spatial axis). ``MultiViewGazePredictor`` takes data-parallel meshes
only, and int8 under a mesh is not ported (ROADMAP A13), as the JAX
package's dynamic scale is one abs-max over the global array.
"""

from __future__ import annotations

import copy
import os
import threading
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from rot_mvgaze_tpu_torch.augment.ops import eval_preprocess
from rot_mvgaze_tpu_torch.compat import msgpack
from rot_mvgaze_tpu_torch.compat.convert import conv_entries, load_checkpoint, model_config, read_checkpoint
from rot_mvgaze_tpu_torch.geometry.gaze import rotation_matrix_2d
from rot_mvgaze_tpu_torch.models.multiview import FeatRotationMultiView
from rot_mvgaze_tpu_torch.models.resnet import INT8_MODES, calibrating
from rot_mvgaze_tpu_torch.models.rot_mv import FeatRotationSymm
from rot_mvgaze_tpu_torch.parallel.mesh import Mesh, dp_size, spatial_size, with_spatial_floor
from rot_mvgaze_tpu_torch.parallel.spatial import shard_images
from rot_mvgaze_tpu_torch.utils.device import resolve_device
from rot_mvgaze_tpu_torch.utils.padding import iter_padded_microbatches

# below this many samples, static-int8 auto-calibration warns that its
# frozen activation ranges come from too small a probe
MIN_CALIBRATION_SAMPLES = 64

MODEL_CONFIG_KEYS = (
    "backbone_depth",
    "num_iter",
    "share_weights",
    "encode_rotmat",
    "share_feature",
    "ignore_rotmat",
)


def _validate_views(
    img_0: np.ndarray,
    img_1: np.ndarray,
    head_pose_0: np.ndarray,
    head_pose_1: np.ndarray,
    image_size: "int | None" = None,
) -> int:
    """Validate a two-view request; returns the batch size N.

    Pixels are divided by 255 on the device, so float inputs (already in
    [0,1]) would be normalised twice: only uint8 is accepted. Batch dims
    must agree across all four fields. When ``image_size`` is given, H and W
    must equal it.
    """
    n = int(np.shape(img_0)[0]) if np.ndim(img_0) >= 1 else -1
    for name, a in (("img_0", img_0), ("img_1", img_1)):
        a = np.asarray(a)
        if a.ndim != 4 or a.shape[-1] != 3:
            raise ValueError(f"{name} must be (N, H, W, 3) uint8, got {a.shape}")
        if a.dtype != np.uint8:
            raise ValueError(
                f"{name} must be uint8 (raw pixels; normalization runs on "
                f"device — float input would be /255'd a second time), got "
                f"{a.dtype}"
            )
        if a.shape[0] != n:
            raise ValueError("all fields must share the batch dimension")
        if image_size is not None and a.shape[1:3] != (image_size, image_size):
            raise ValueError(
                f"{name} must be (N, {image_size}, {image_size}, 3), got {a.shape}"
            )
    for name, a in (("head_pose_0", head_pose_0), ("head_pose_1", head_pose_1)):
        if np.shape(a) != (n, 2):
            raise ValueError(f"{name} must be ({n}, 2), got {np.shape(a)}")
    return n


def _validate_stacked_views(
    imgs: np.ndarray,
    head_poses: np.ndarray,
    num_views: int,
    image_size: "int | None" = None,
) -> int:
    """Validate a stacked V-view request (``imgs (N, V, H, W, 3)`` uint8,
    ``head_poses (N, V, 2)``) under :func:`_validate_views`' contract;
    returns N. V must be the predictor's."""
    a = np.asarray(imgs)
    if a.ndim != 5 or a.shape[-1] != 3:
        raise ValueError(f"imgs must be (N, {num_views}, H, W, 3) uint8, got {a.shape}")
    if a.shape[1] != num_views:
        raise ValueError(
            f"this server runs a {num_views}-view model; imgs has {a.shape[1]} views "
            f"(shape {a.shape})"
        )
    if a.dtype != np.uint8:
        raise ValueError(
            f"imgs must be uint8 (raw pixels; normalization runs on device — float input "
            f"would be /255'd a second time), got {a.dtype}"
        )
    n = int(a.shape[0])
    if image_size is not None and a.shape[2:4] != (image_size, image_size):
        raise ValueError(
            f"imgs must be (N, {num_views}, {image_size}, {image_size}, 3), got {a.shape}"
        )
    if np.shape(head_poses) != (n, num_views, 2):
        raise ValueError(
            f"head_poses must be ({n}, {num_views}, 2), got {np.shape(head_poses)}"
        )
    return n


def _apply(model: nn.Module, state: Optional[Mapping[str, torch.Tensor]], data: Dict[str, Any]):
    """``model(data)``, with ``state`` (by state-dict name) in place of the
    module's own parameters and buffers when given. An aliased module (the
    ``share_weights`` fusers and heads) is one module under several names,
    so one name's entry replaces it for all: ``tie_weights=False``, whose
    tying would restore the other names to the replacements on exit."""
    if state is None:
        return model(data)
    return torch.func.functional_call(model, dict(state), (data,), tie_weights=False)


def make_serving_forward(
    model: nn.Module, image_size: int = 224, strips: Optional[Sequence[torch.device]] = None
) -> Callable[..., torch.Tensor]:
    """Pure two-view serving forward: ``(state, img_0, img_1, head_pose_0,
    head_pose_1) -> (N, 2) float32 pitchyaw``, with uint8 images and float32
    poses on the model's device. ``state`` replaces the model's parameters
    and buffers (``torch.func.functional_call``), or is None for the
    model's own. Shared by :class:`GazePredictor` and the exporter.
    ``strips``: a spatial group's devices; the preprocessed views are cut
    into height strips over them (the counterpart of JAX's ``pin_images``),
    which the model's backbone needs its floor for
    (``parallel.with_spatial_floor``)."""

    def views(img):
        x = eval_preprocess(img, image_size)
        return x if strips is None or len(strips) < 2 else shard_images(x, [list(strips)])

    def forward(state, img_0, img_1, head_pose_0, head_pose_1):
        data = {
            "img_0": views(img_0),
            "img_1": views(img_1),
            "rot_0": rotation_matrix_2d(head_pose_0),
            "rot_1": rotation_matrix_2d(head_pose_1),
        }
        return _apply(model, state, data)["pred_gaze"].float()

    return forward


def _multiview_data(imgs: torch.Tensor, head_poses: torch.Tensor, image_size: int) -> Dict[str, torch.Tensor]:
    """Stacked uint8 views -> normalised float views and SO(3) rotations:
    all N·V images preprocess as one batch."""
    b, v = imgs.shape[0], imgs.shape[1]
    proc = eval_preprocess(imgs.reshape((b * v,) + tuple(imgs.shape[2:])), image_size)
    return {
        "imgs": proc.reshape((b, v) + tuple(proc.shape[1:])),
        "rots": rotation_matrix_2d(head_poses.float()),
    }


def make_multiview_serving_forward(model: nn.Module, image_size: int = 224) -> Callable[..., torch.Tensor]:
    """Pure V-view serving forward: ``(state, imgs (N,V,H,W,3) uint8,
    head_poses (N,V,2)) -> (N, 2)`` float32 pitchyaw (view 0 of the last
    iteration); ``state`` as in :func:`make_serving_forward`."""

    def forward(state, imgs, head_poses):
        return _apply(model, state, _multiview_data(imgs, head_poses, image_size))["pred_gaze"].float()

    return forward


class GazePredictor:
    """Two-view gaze predictor over a ``FeatRotationSymm`` checkpoint of the
    given configuration (the ablation flags must match the checkpoint).

    ``predict`` takes (N,H,W,3) uint8 views and (N,2) head poses and returns
    (N,2) float32 pitchyaw. ``micro_batches_run`` counts the micro-batches
    the model has run. ``dtype`` is the compute dtype; the backbone's
    BatchNorms keep float32 parameters and statistics.
    ``int8`` is False, True (dynamic activation scales) or ``"static"``
    (calibrated scales; ``calibration_path`` is then loaded if it exists
    and written after the first calibration).

    The per-model pieces (model, forward, validation, warm-up request) are
    hooks that :class:`MultiViewGazePredictor` overrides.
    """

    #: request field names, in ``predict``'s positional order
    request_fields = ("img_0", "img_1", "head_pose_0", "head_pose_1")

    def __init__(
        self,
        checkpoint: str,
        backbone_depth: Any = 50,
        num_iter: int = 3,
        share_weights: bool = False,
        encode_rotmat: bool = False,
        share_feature: bool = False,
        ignore_rotmat: bool = False,
        micro_batch: int = 64,
        image_size: int = 224,
        dtype: torch.dtype = torch.bfloat16,
        int8: Any = False,
        calibration_path: Optional[str] = None,
        device: Any = "cuda",
        mesh: Optional[Mesh] = None,
    ) -> None:
        self.device = resolve_device(device if mesh is None else mesh.first_device)
        with self.device:  # built in place: the checkpoint replaces every tensor
            model = FeatRotationSymm(
                backbone_depth=backbone_depth,
                num_iter=num_iter,
                share_weights=share_weights,
                encode_rotmat=encode_rotmat,
                share_feature=share_feature,
                ignore_rotmat=ignore_rotmat,
                int8_backbone=int8,
            )
        self._init_serving(model, checkpoint, micro_batch, image_size, dtype, int8, calibration_path, mesh)

    # -------------------------------------------------- per-model hooks
    def _apply_mesh_model(self, mesh: Mesh, image_size: int) -> None:
        """Adapt ``self.model`` to the mesh: the backbone's spatial floor on
        a 2-D mesh, whose spatial axis must divide the image height."""
        sp = spatial_size(mesh)
        if sp > 1 and image_size % sp:
            # uneven strips start at the stem and reach the < 2-row regime
            # the floor exists to forbid
            raise ValueError(
                f"image_size {image_size} is not divisible by the mesh's spatial axis ({sp}); "
                f"pick an even split"
            )
        self.model = with_spatial_floor(self.model, mesh)

    def _make_forward(self, model: nn.Module, strips: Optional[Sequence[torch.device]] = None
                      ) -> Callable[..., torch.Tensor]:
        return make_serving_forward(model, self.image_size, strips)

    def _noise_request(self) -> Tuple[np.ndarray, ...]:
        """One throwaway request (N=1) for :meth:`warmup`."""
        rng = np.random.default_rng(0)
        s = self.image_size
        return (
            rng.integers(0, 256, (1, s, s, 3), dtype=np.uint8),
            rng.integers(0, 256, (1, s, s, 3), dtype=np.uint8),
            np.zeros((1, 2), np.float32),
            np.zeros((1, 2), np.float32),
        )

    def validate_request(self, *args: np.ndarray, image_size: "int | None" = None) -> int:
        """Validate a request tuple (``request_fields`` order); returns N."""
        return _validate_views(*args, image_size=image_size)

    # -------------------------------------------------- shared machinery
    def _init_serving(
        self,
        model: nn.Module,
        checkpoint: str,
        micro_batch: int,
        image_size: int,
        dtype: torch.dtype,
        int8: Any,
        calibration_path: Optional[str],
        mesh: Optional[Mesh] = None,
    ) -> None:
        if int8 not in INT8_MODES:
            raise ValueError(f"int8 must be one of {INT8_MODES}, got {int8!r}")
        if mesh is not None and int8:
            # JAX's dynamic scale is one abs-max over the global array: under
            # a mesh, a max across replicas and strips at every conv
            raise ValueError(f"int8={int8!r} under a mesh is not ported (ROADMAP A13: int8 under a "
                             f"mesh); serve int8 without a mesh")
        self._int8_static = int8 == "static"
        if calibration_path is not None and not self._int8_static:
            # only the static path reads or writes it; accepting it elsewhere
            # would let a user believe ranges are persisted
            raise ValueError(
                "calibration_path requires int8='static' (dynamic int8 and bf16 "
                "serving have no persistent activation ranges)"
            )
        # a JAX checkpoint is converted with the model's flags
        model.load_state_dict(load_checkpoint(checkpoint, **model_config(model)), strict=True)
        self.model = model.to(device=self.device, memory_format=torch.channels_last).eval()
        # every module but BatchNorm computes in ``dtype``; BatchNorm keeps
        # float32 parameters and statistics, as the JAX package folds them in
        # float32 before it casts
        for m in self.model.modules():
            if not isinstance(m, nn.BatchNorm2d):
                m._apply(lambda t: t.to(dtype) if t.is_floating_point() else t, recurse=False)
        self.image_size = image_size
        self.mesh = mesh
        self._replicas: List[Tuple[torch.device, Callable[..., torch.Tensor]]] = []
        self._threaded = False
        if mesh is not None:
            self._apply_mesh_model(mesh, image_size)
            # the micro-batch rounds up to a multiple of the data axis (the
            # spatial axis splits height, not rows)
            dp = dp_size(mesh)
            micro_batch = -(-micro_batch // dp) * dp
            # one copy of the model per distinct device that runs a
            # replica's heads (its group's first); a strip's other devices
            # take the parameters they need from spatial.on's cache
            models = {self.device: self.model}
            for group in mesh.grid:
                if group[0] not in models:
                    models[group[0]] = copy.deepcopy(self.model).to(group[0])
            self._replicas = [(group[0], self._make_forward(models[group[0]], group)) for group in mesh.grid]
            self._threaded = len(models) > 1  # replicas on distinct cards: one host thread each
        self.micro_batch = micro_batch
        self.micro_batches_run = 0
        self._count_lock = threading.Lock()
        self._forward = self._make_forward(self.model)
        self._calibrated = False
        # calibration mutates the ranges; concurrent first requests must not
        # interleave the read-modify-write
        self._calib_lock = threading.Lock()
        self._calibration_path = calibration_path
        if self._int8_static:
            # (JAX calibration path, conv) of every backbone conv
            self._quant_convs = [(e.jax_path, self.model.get_submodule(e.torch_key))
                                 for e in conv_entries(model.backbone_depth)]
            if calibration_path is not None and os.path.exists(calibration_path):
                self.load_calibration(calibration_path)

    def predict(
        self,
        img_0: np.ndarray,
        img_1: np.ndarray,
        head_pose_0: np.ndarray,
        head_pose_1: np.ndarray,
    ) -> np.ndarray:
        """(N,H,W,3) uint8 x2 views + (N,2) head poses -> (N,2) pitchyaw.
        Any N, in fixed micro-batches; any H, W (resized on the device)."""
        n = self.validate_request(img_0, img_1, head_pose_0, head_pose_1)
        return self._predict_request((img_0, img_1, head_pose_0, head_pose_1), n)

    def _predict_request(self, args: Tuple[np.ndarray, ...], n: int) -> np.ndarray:
        """The post-validation predict path: static int8 calibrates on the
        first real request (and saves the ranges to ``calibration_path``)."""
        if n == 0:
            return np.zeros((0, 2), np.float32)
        ran_calib = self._int8_static and not self._calibrated
        if ran_calib and n < MIN_CALIBRATION_SAMPLES:
            warnings.warn(
                f"static-int8 auto-calibration is freezing activation ranges from only {n} "
                f"sample(s); later out-of-range activations will be silently clipped. Call "
                f"calibrate() with >= {MIN_CALIBRATION_SAMPLES} representative samples for "
                f"stable scales.",
                stacklevel=3,
            )
        out = self._predict(*args, force_calib=ran_calib)
        # persist real-data calibration only (warmup's noise pass goes
        # through _predict directly and is never saved)
        if ran_calib and self._calibration_path is not None:
            self.save_calibration(self._calibration_path)
        return out

    def _predict(self, *request: np.ndarray, force_calib: bool = False) -> np.ndarray:
        if int(np.shape(request[0])[0]) == 0:
            # no micro-batch would run: never mark the predictor calibrated
            # off an empty pass (all-zero frozen scales)
            return np.zeros((0, 2), np.float32)
        outs = []
        for padded, rows in iter_padded_microbatches(request, self.micro_batch):
            if not self._int8_static:
                outs.append(self._run(padded)[:rows])
                continue
            # static int8: every pass reads the ranges that calibration
            # passes write, so all of them hold the lock
            with self._calib_lock:
                if force_calib:
                    with calibrating(self.model):
                        outs.append(self._run(padded)[:rows])
                else:
                    outs.append(self._run(padded)[:rows])
        if force_calib:
            with self._calib_lock:
                self._calibrated = True
        return np.concatenate(outs, axis=0)

    def _run(self, request: Tuple[np.ndarray, ...]) -> np.ndarray:
        """One micro-batch: pixels stay uint8 (the rank >= 4 fields), every
        other field goes as float32, whatever its incoming dtype. Under a
        mesh its rows split evenly over the data replicas, each run on its
        own devices (from one host thread each where they are distinct
        cards), and the replicas' predictions are concatenated in order."""
        request = tuple(map(np.asarray, request))
        if self.mesh is None:
            pred = self._run_on(self.device, self._forward, request)
        else:
            n = request[0].shape[0] // len(self._replicas)
            parts = [(device, forward, tuple(a[i * n:(i + 1) * n] for a in request))
                     for i, (device, forward) in enumerate(self._replicas)]
            if self._threaded:
                with ThreadPoolExecutor(max_workers=len(parts)) as pool:
                    outs = list(pool.map(lambda part: self._run_on(*part), parts))
            else:
                outs = [self._run_on(*part) for part in parts]
            pred = np.concatenate(outs, axis=0)
        with self._count_lock:
            self.micro_batches_run += 1
        return pred

    @staticmethod
    @torch.inference_mode()
    def _run_on(device: torch.device, forward: Callable[..., torch.Tensor],
                request: Tuple[np.ndarray, ...]) -> np.ndarray:
        tensors = tuple(
            torch.from_numpy(np.ascontiguousarray(a, np.uint8 if a.ndim >= 4 else np.float32)).to(device)
            for a in request
        )
        return forward(None, *tensors).cpu().numpy()

    def calibrate(
        self,
        img_0: np.ndarray,
        img_1: np.ndarray,
        head_pose_0: np.ndarray,
        head_pose_1: np.ndarray,
    ) -> np.ndarray:
        """Static int8: record activation ranges from representative data (a
        running max: repeated calls extend it); returns the dynamically
        quantized predictions of that data."""
        return self._calibrate_request((img_0, img_1, head_pose_0, head_pose_1))

    def _calibrate_request(self, args: Tuple[np.ndarray, ...]) -> np.ndarray:
        if not self._int8_static:
            raise RuntimeError("calibrate() requires int8='static'")
        n = self.validate_request(*args)
        if n == 0:
            # zero samples record zero ranges; marking the predictor
            # calibrated would freeze all-zero scales
            raise ValueError("calibrate() needs at least 1 sample (got an empty batch)")
        out = self._predict(*args, force_calib=True)
        if self._calibration_path is not None:
            self.save_calibration(self._calibration_path)
        return out

    def warmup(self) -> None:
        """Run throwaway noise through every path this predictor will use
        (kernel builds, cuDNN set-up, allocator growth), without touching the
        calibration: static int8 not yet calibrated runs a calibration pass
        and a frozen pass, then discards the noise's ranges."""
        noise = self._noise_request()
        if self._int8_static and not self._calibrated:
            self._predict(*noise, force_calib=True)
            self._predict(*noise, force_calib=False)
            self.reset_calibration()
        else:
            self.predict(*noise)

    def save_calibration(self, path: str) -> str:
        """Static int8: write the activation ranges in the JAX package's
        calibration format (msgpack ``{"quant": {...}}``); returns the
        path."""
        if not self._int8_static:
            raise RuntimeError("save_calibration() requires int8='static'")
        tree: Dict[str, Any] = {}
        with self._calib_lock:
            for jax_path, conv in self._quant_convs:
                node = tree
                for key in jax_path:
                    node = node.setdefault(key, {})
                node["act_amax"] = conv.act_amax.detach().float().cpu().numpy()
        return msgpack.dump(path, {"quant": tree})

    def load_calibration(self, path: str) -> None:
        """Static int8: restore ranges saved by :meth:`save_calibration` (or
        by the JAX package's); the predictor starts frozen."""
        if not self._int8_static:
            raise RuntimeError("load_calibration() requires int8='static'")
        tree = read_checkpoint(path)
        if not isinstance(tree, dict) or "quant" not in tree:
            raise ValueError(f"{path} is not a calibration file (no 'quant')")
        leaves = {}

        def walk(node: Any, prefix: Tuple[str, ...]) -> None:
            if isinstance(node, dict):
                for k, v in node.items():
                    walk(v, prefix + (k,))
            else:
                leaves[prefix] = node

        walk(tree["quant"], ())
        want = {jax_path + ("act_amax",) for jax_path, _ in self._quant_convs}
        if set(leaves) != want or any(np.shape(v) != () for v in leaves.values()):
            raise ValueError(f"calibration at {path} does not match this architecture")
        with self._calib_lock:
            for jax_path, conv in self._quant_convs:
                value = torch.tensor(np.asarray(leaves[jax_path + ("act_amax",)], np.float32))
                conv.act_amax.copy_(value)
            self._calibrated = True

    def reset_calibration(self) -> None:
        """Static int8: zero the activation ranges (after a warm-up on
        unrepresentative data), so the next request or :meth:`calibrate`
        records them from scratch."""
        if not self._int8_static:
            return
        with self._calib_lock:
            for _, conv in self._quant_convs:
                conv.act_amax.zero_()
            self._calibrated = False


class MultiViewGazePredictor(GazePredictor):
    """V-view gaze predictor (``FeatRotationMultiView``).

    Requests are stacked: ``imgs (N, V, H, W, 3)`` uint8 + ``head_poses (N,
    V, 2)`` -> ``(N, 2)`` float32 pitchyaw (view 0 of the last iteration). V
    is fixed per predictor. Any stereo checkpoint loads at any V. The
    serving machinery is :class:`GazePredictor`'s (micro-batching,
    bf16/f32/int8 dynamic and static). ``encode_rotmat`` and
    ``share_feature`` have no V-view counterpart, as in the JAX package:
    there are no such arguments.
    """

    request_fields = ("imgs", "head_poses")

    def __init__(
        self,
        checkpoint: str,
        num_views: int,
        backbone_depth: Any = 50,
        num_iter: int = 3,
        share_weights: bool = False,
        ignore_rotmat: bool = False,
        micro_batch: int = 64,
        image_size: int = 224,
        dtype: torch.dtype = torch.bfloat16,
        int8: Any = False,
        calibration_path: Optional[str] = None,
        device: Any = "cuda",
        mesh: Optional[Mesh] = None,
    ) -> None:
        self.device = resolve_device(device if mesh is None else mesh.first_device)
        if num_views < 2:
            raise ValueError(f"num_views must be >= 2, got {num_views}")
        self.num_views = num_views
        with self.device:
            model = FeatRotationMultiView(
                backbone_depth=backbone_depth,
                num_iter=num_iter,
                share_weights=share_weights,
                ignore_rotmat=ignore_rotmat,
                int8_backbone=int8,
            )
        self._init_serving(model, checkpoint, micro_batch, image_size, dtype, int8, calibration_path, mesh)

    def _apply_mesh_model(self, mesh: Mesh, image_size: int) -> None:
        if spatial_size(mesh) > 1:
            raise ValueError(
                "MultiViewGazePredictor does not support spatial meshes (the V-view path is DP-only, "
                "matching the training CLI); use a 1-D data mesh"
            )

    def _make_forward(self, model: nn.Module, strips: Optional[Sequence[torch.device]] = None
                      ) -> Callable[..., torch.Tensor]:
        return make_multiview_serving_forward(model, self.image_size)

    def _noise_request(self) -> Tuple[np.ndarray, ...]:
        rng = np.random.default_rng(0)
        s, v = self.image_size, self.num_views
        return (
            rng.integers(0, 256, (1, v, s, s, 3), dtype=np.uint8),
            np.zeros((1, v, 2), np.float32),
        )

    def validate_request(self, *args: np.ndarray, image_size: "int | None" = None) -> int:
        return _validate_stacked_views(*args, num_views=self.num_views, image_size=image_size)

    def predict(self, imgs: np.ndarray, head_poses: np.ndarray) -> np.ndarray:
        """(N,V,H,W,3) uint8 + (N,V,2) head poses -> (N,2) pitchyaw."""
        n = self.validate_request(imgs, head_poses)
        return self._predict_request((imgs, head_poses), n)

    def calibrate(self, imgs: np.ndarray, head_poses: np.ndarray) -> np.ndarray:
        """Static int8 calibration on stacked V-view data
        (:meth:`GazePredictor.calibrate`)."""
        return self._calibrate_request((imgs, head_poses))


class BatchingPredictor:
    """Dynamic request coalescing in front of a predictor
    (:class:`GazePredictor`, :class:`MultiViewGazePredictor`, or any object
    with ``request_fields``, ``validate_request``, ``micro_batch``,
    ``image_size`` and ``predict``).

    Concurrent callers' samples are merged into shared micro-batches by one
    dispatcher thread, so under load the model runs full batches instead of
    one padded batch per request; callers block until their own rows are
    ready. ``max_delay_ms`` bounds how long the dispatcher waits to fill a
    batch. Requests are validated at the predictor's resolution, so every
    queued request has the same trailing shapes. A failed batch raises its
    error in every caller it held.
    """

    def __init__(self, predictor: Any, max_delay_ms: float = 2.0):
        self.predictor = predictor
        self.request_fields = predictor.request_fields
        self.max_delay = max_delay_ms / 1e3
        self._cv = threading.Condition(threading.Lock())
        self._queue: List[Tuple[tuple, threading.Event, dict, int]] = []
        self._closed = False
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def predict(self, *args: np.ndarray) -> np.ndarray:
        if len(args) != len(self.request_fields):
            raise ValueError(
                f"predict takes {len(self.request_fields)} arrays "
                f"({', '.join(self.request_fields)}), got {len(args)}"
            )
        # validate in the caller's thread, before enqueueing: one malformed
        # request fails alone and never poisons a coalesced batch; the
        # resolution is pinned to the predictor's
        raw = tuple(map(np.asarray, args))
        n = self.predictor.validate_request(*raw, image_size=self.predictor.image_size)
        req = tuple(a if a.ndim >= 4 else np.asarray(a, np.float32) for a in raw)
        if n == 0:
            return np.zeros((0, 2), np.float32)
        done = threading.Event()
        out: dict = {}
        with self._cv:
            if self._closed:
                raise RuntimeError("BatchingPredictor is closed")
            self._queue.append((req, done, out, n))
            self._cv.notify()
        done.wait()
        if "error" in out:
            raise out["error"]
        return out["pred"]

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify()
        self._worker.join(timeout=5)

    def _run(self) -> None:
        mb = self.predictor.micro_batch
        while True:
            with self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait()
                if self._closed and not self._queue:
                    return
                # collect until a full micro-batch is queued or the delay
                # budget is spent
                deadline = time.monotonic() + self.max_delay
                while sum(r[3] for r in self._queue) < mb and not self._closed:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cv.wait(timeout=remaining)
                batch, self._queue = self._queue, []
            try:
                pred = self.predictor.predict(
                    *(
                        np.concatenate([r[0][i] for r in batch])
                        for i in range(len(self.request_fields))
                    )
                )
                start = 0
                for _, done, out, n in batch:
                    out["pred"] = pred[start : start + n]
                    start += n
                    done.set()
            except Exception as e:  # propagate to every waiting caller
                for _, done, out, _ in batch:
                    out["error"] = e
                    done.set()
