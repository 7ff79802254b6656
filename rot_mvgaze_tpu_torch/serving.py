"""Batch inference / serving API (port of the two-view part of
``rot_mvgaze_tpu/serving.py``).

- :class:`GazePredictor` loads a reference ``.pth.tar`` into
  ``FeatRotationSymm`` and serves any request size in fixed micro-batches
  (the last one padded by repeating its last row), bf16 by default,
  pitchyaw out in float32.
- :class:`BatchingPredictor` coalesces concurrent callers' requests into
  shared micro-batches on one dispatcher thread.

Requests are NHWC uint8 images and ``(N, 2)`` head poses, as in the JAX
package. The predictor runs on the card (``device="cuda"``) unless the
caller asks for the CPU; with no card, the default raises.
"""

from __future__ import annotations

import threading
import time
from typing import Any, List, Tuple

import numpy as np
import torch

from rot_mvgaze_tpu_torch.augment.ops import eval_preprocess
from rot_mvgaze_tpu_torch.compat.convert import load_checkpoint
from rot_mvgaze_tpu_torch.geometry.gaze import rotation_matrix_2d
from rot_mvgaze_tpu_torch.models.rot_mv import FeatRotationSymm
from rot_mvgaze_tpu_torch.utils.device import resolve_device
from rot_mvgaze_tpu_torch.utils.padding import iter_padded_microbatches


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


class GazePredictor:
    """Two-view gaze predictor over a ``FeatRotationSymm`` checkpoint.

    ``predict`` takes (N,H,W,3) uint8 views and (N,2) head poses and
    returns (N,2) float32 pitchyaw. ``micro_batches_run`` counts the
    micro-batches the model has run.
    """

    #: request field names, in ``predict``'s positional order
    request_fields = ("img_0", "img_1", "head_pose_0", "head_pose_1")

    def __init__(
        self,
        checkpoint: str,
        backbone_depth: Any = 50,
        num_iter: int = 3,
        share_weights: bool = False,
        micro_batch: int = 64,
        image_size: int = 224,
        dtype: torch.dtype = torch.bfloat16,
        device: Any = "cuda",
    ) -> None:
        self.device = resolve_device(device)
        self.micro_batch = micro_batch
        self.image_size = image_size
        model = FeatRotationSymm(
            backbone_depth=backbone_depth,
            num_iter=num_iter,
            share_weights=share_weights,
        )
        model.load_state_dict(
            load_checkpoint(checkpoint, backbone_depth, num_iter, share_weights), strict=True
        )
        self.model = model.to(
            device=self.device, dtype=dtype, memory_format=torch.channels_last
        ).eval()
        self.micro_batches_run = 0
        self._count_lock = threading.Lock()

    def validate_request(
        self, *args: np.ndarray, image_size: "int | None" = None
    ) -> int:
        """Validate a request tuple (``request_fields`` order); returns N."""
        return _validate_views(*args, image_size=image_size)

    def predict(
        self,
        img_0: np.ndarray,
        img_1: np.ndarray,
        head_pose_0: np.ndarray,
        head_pose_1: np.ndarray,
    ) -> np.ndarray:
        """(N,H,W,3) uint8 x2 views + (N,2) head poses -> (N,2) pitchyaw."""
        request = (img_0, img_1, head_pose_0, head_pose_1)
        n = self.validate_request(*request)
        if n == 0:
            return np.zeros((0, 2), np.float32)
        outs = []
        for padded, rows in iter_padded_microbatches(request, self.micro_batch):
            outs.append(self._forward(*padded)[:rows])
        return np.concatenate(outs, axis=0)

    @torch.inference_mode()
    def _forward(
        self,
        img_0: np.ndarray,
        img_1: np.ndarray,
        head_pose_0: np.ndarray,
        head_pose_1: np.ndarray,
    ) -> np.ndarray:
        def to_device(a: np.ndarray, dtype: Any) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(self.device)

        data = {
            "img_0": eval_preprocess(to_device(img_0, np.uint8), self.image_size),
            "img_1": eval_preprocess(to_device(img_1, np.uint8), self.image_size),
            "rot_0": rotation_matrix_2d(to_device(head_pose_0, np.float32)),
            "rot_1": rotation_matrix_2d(to_device(head_pose_1, np.float32)),
        }
        pred = self.model(data)["pred_gaze"].float().cpu().numpy()
        with self._count_lock:
            self.micro_batches_run += 1
        return pred

    def warmup(self) -> None:
        """Run one throwaway micro-batch of noise, so the first request does
        not pay for kernel builds, cuDNN set-up and allocator growth."""
        rng = np.random.default_rng(0)
        s = self.image_size
        self.predict(
            rng.integers(0, 256, (1, s, s, 3), dtype=np.uint8),
            rng.integers(0, 256, (1, s, s, 3), dtype=np.uint8),
            np.zeros((1, 2), np.float32),
            np.zeros((1, 2), np.float32),
        )


class BatchingPredictor:
    """Dynamic request coalescing in front of a :class:`GazePredictor`.

    Concurrent callers' samples are merged into shared micro-batches by one
    dispatcher thread, so under load the model runs full batches instead of
    one padded batch per request; callers block until their own rows are
    ready. ``max_delay_ms`` bounds how long the dispatcher waits to fill a
    batch. A failed batch raises its error in every caller it held.
    """

    def __init__(self, predictor: GazePredictor, max_delay_ms: float = 2.0):
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
