"""HTTP inference server for the gaze models on the card (port of
``scripts/serve.py``).

    python -m rot_mvgaze_tpu_torch.serve --ckpt model.pth.tar [--port 8347] \
        [--backbone_depth 50 --num_iter 3 --micro_batch 64 --f32] \
        [--share_weights | --ignore_rotmat | --encode_rotmat | --share_feature] \
        [--num_views V] [--int8 | --int8_static [--calibration ranges.msgpack]] \
        [--dp] [--spatial_partition N] [--device cuda | cpu | DEVICE,DEVICE,...]

API:
  GET  /healthz   -> {"status": "ok", "requests": ..., "samples": ..., ...}
  POST /predict   body: npz with img_0, img_1 (N,H,W,3 uint8),
                  head_pose_0, head_pose_1 (N,2 float32)
                  -> npz with pred_gaze (N,2 float32 pitchyaw)

With ``--num_views V`` (V > 2) the server runs the V-view model and
/predict takes ``imgs`` (N,V,H,W,3 uint8) and ``head_poses`` (N,V,2); a
stereo checkpoint loads at any V. ``--int8`` runs the backbone's convs on
int8 with dynamic activation scales, ``--int8_static`` with calibrated ones
(calibrated on the first request, or loaded from ``--calibration`` and
saved there after the first calibration).

``--dp`` serves each micro-batch over every visible device (data-parallel
replicas), and ``--spatial_partition N`` splits each image's height over
groups of N devices (halo rows between strips), with data parallelism over
the groups: a ``(data, spatial)`` mesh (``parallel.make_mesh``), as the JAX
package's server builds it. The visible devices are every card with
``--device cuda``, one CPU with ``--device cpu``, or the comma-separated
list given (a device may repeat: ``--device cuda:0,cuda:0`` is a logical
mesh on one card). With one visible device ``--dp`` serves on it, and
``--spatial_partition N > 1`` is refused. N must divide ``--image_size``;
the V-view server (``--num_views > 2``) and int8 (ROADMAP A13: int8 under a
mesh) take no mesh. Refusals exit before anything loads.

A malformed request gets 400, a body over the size cap 413, a failure of
the server 500.
"""

from __future__ import annotations

import argparse
import io
import json
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

import numpy as np

# request-body cap per view pair: generous for batch-256 224^2 two-view
# uint8 (~80 MB); a V-view server scales it by ceil(V/2)
MAX_BODY_BYTES = 256 * 1024 * 1024


def build_handler(predictor, stats, max_body_bytes=MAX_BODY_BYTES):
    """Request handler class over ``predictor`` (a thread-safe
    :class:`~rot_mvgaze_tpu_torch.serving.BatchingPredictor`); ``stats`` is
    a dict with ``requests``, ``samples`` and ``time`` that the handler
    updates under a lock."""
    lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet default access log
            pass

        def _reply(self, code, payload, ctype="application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def do_GET(self):
            if self.path != "/healthz":
                self._reply(404, b'{"error": "not found"}')
                return
            with lock:
                snap = dict(stats)
            body = json.dumps(
                {
                    "status": "ok",
                    "requests": snap["requests"],
                    "samples": snap["samples"],
                    "avg_latency_ms": round(
                        1e3 * snap["time"] / max(snap["requests"], 1), 2
                    ),
                }
            ).encode()
            self._reply(200, body)

        def do_POST(self):
            if self.path != "/predict":
                self._reply(404, b'{"error": "not found"}')
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                # cap the body BEFORE reading: np.load decompresses in full
                if length > max_body_bytes:
                    self._reply(
                        413,
                        json.dumps({
                            "error": f"request body {length} bytes exceeds "
                                     f"limit {max_body_bytes}"
                        }).encode(),
                    )
                    return
                data = np.load(io.BytesIO(self.rfile.read(length)))
                t0 = time.perf_counter()
                pred = predictor.predict(*(data[f] for f in predictor.request_fields))
                dt = time.perf_counter() - t0
                with lock:
                    stats["requests"] += 1
                    stats["samples"] += int(pred.shape[0])
                    stats["time"] += dt
                buf = io.BytesIO()
                np.savez(buf, pred_gaze=pred)
                self._reply(200, buf.getvalue(), "application/octet-stream")
            except KeyError as e:
                self._reply(400, json.dumps({"error": f"missing field {e}"}).encode())
            except ValueError as e:
                # shape/dtype validation: the CLIENT is at fault
                self._reply(400, json.dumps({"error": f"bad request: {e}"}).encode())
            except Exception as e:  # surface the error to the client
                self._reply(
                    500, json.dumps({"error": f"{type(e).__name__}: {e}"}).encode()
                )

    return Handler


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ckpt", required=True,
                   help="a reference .pth.tar, the port's checkpoint or a JAX .msgpack")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8347)
    p.add_argument("--backbone_depth", default="50",
                   help="ResNet depth or a variant name (resnext50_32x4d, ...)")
    p.add_argument("--num_iter", type=int, default=3)
    p.add_argument("--micro_batch", type=int, default=64)
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--num_views", type=int, default=2,
                   help="serve the V-view model (V > 2): /predict takes stacked imgs "
                        "(N,V,H,W,3) + head_poses (N,V,2); stereo checkpoints load at any V")
    p.add_argument("--share_weights", action="store_true",
                   help="one fuser/head reused across iterations; must match the checkpoint")
    p.add_argument("--ignore_rotmat", action="store_true",
                   help="the ignore_rotmat ablation; must match the checkpoint")
    p.add_argument("--encode_rotmat", action="store_true",
                   help="the encode_rotmat ablation; must match the checkpoint (two-view only)")
    p.add_argument("--share_feature", action="store_true",
                   help="the share_feature ablation; must match the checkpoint (two-view only)")
    p.add_argument("--f32", action="store_true", help="float32 compute")
    p.add_argument("--int8", action="store_true",
                   help="int8 backbone convs with dynamic activation scales")
    p.add_argument("--int8_static", action="store_true",
                   help="int8 backbone convs with calibrated activation scales "
                        "(calibrated on the first request)")
    p.add_argument("--calibration", default=None,
                   help="with --int8_static: the calibration file to load if present and "
                        "to save after the first calibration")
    p.add_argument("--dp", action="store_true",
                   help="split each micro-batch over every visible device (data-parallel serving; "
                        "the model copied to each)")
    p.add_argument("--spatial_partition", type=int, default=1,
                   help="split each image's height over groups of N devices (halo rows between "
                        "strips); combines with --dp over the device count / N groups")
    p.add_argument("--device", default="cuda",
                   help="cuda (every card visible), cpu, or a comma-separated list of the devices "
                        "to serve on (repeats allowed: cuda:0,cuda:0 is a logical mesh on one card)")
    p.add_argument("--coalesce_ms", type=float, default=2.0,
                   help="max wait to fill a shared micro-batch from concurrent requests")
    return p


def serves_on_a_mesh(args: argparse.Namespace) -> bool:
    """Whether the flags build a mesh: ``--dp`` or ``--spatial_partition >
    1``, and more than one visible device, as in the JAX package's server."""
    from rot_mvgaze_tpu_torch.parallel.mesh import visible_devices

    return (args.dp or args.spatial_partition > 1) and len(visible_devices(args.device)) > 1


def refused(args: argparse.Namespace) -> List[str]:
    """What this server refuses of the parsed flags, before it loads
    anything, in the JAX package's server's words: for V > 2 spatial
    partitioning and the stereo-only ablations, a spatial partition without
    more than one visible device or that does not divide the image size;
    and int8 under a mesh (not ported)."""
    from rot_mvgaze_tpu_torch.parallel.mesh import visible_devices

    bad = []
    sp = max(args.spatial_partition, 1)
    if args.num_views < 2:
        bad.append(f"--num_views {args.num_views} (must be >= 2)")
    if args.num_views > 2:
        bad += [f"--num_views {args.num_views} with {flag}" for flag, on in (
            ("--spatial_partition > 1", sp > 1),
            ("--encode_rotmat", args.encode_rotmat),
            ("--share_feature", args.share_feature),
        ) if on]
    n_devices = len(visible_devices(args.device))
    if sp > 1 and n_devices <= 1:
        bad.append(f"--spatial_partition {sp} needs >1 visible device (have {n_devices})")
    elif sp > 1 and args.image_size % sp:
        bad.append(f"--spatial_partition {sp} must divide --image_size {args.image_size}")
    if serves_on_a_mesh(args) and (args.int8 or args.int8_static):
        bad.append("--int8/--int8_static under a mesh (ROADMAP A13: int8 under a mesh)")
    return bad


def build_predictor(args: argparse.Namespace):
    """The predictor of the parsed flags (which :func:`refused` passed): on
    a ``(data, spatial)`` mesh of the visible devices where the flags ask
    for one (:func:`serves_on_a_mesh`), else on ``--device``."""
    import torch

    from rot_mvgaze_tpu_torch.parallel.mesh import dp_size, make_mesh, visible_devices
    from rot_mvgaze_tpu_torch.serving import GazePredictor, MultiViewGazePredictor

    mesh = None
    sp = max(args.spatial_partition, 1)
    if serves_on_a_mesh(args):
        mesh = make_mesh(visible_devices(args.device), spatial=sp)
        print(f"serving over {mesh.devices.size} devices"
              + (f" (spatial partition {sp}, dp {dp_size(mesh)})" if sp > 1 else " (data-parallel)"),
              flush=True)
    depth = int(args.backbone_depth) if args.backbone_depth.isdigit() else args.backbone_depth
    common = dict(
        backbone_depth=depth,
        num_iter=args.num_iter,
        share_weights=args.share_weights,
        ignore_rotmat=args.ignore_rotmat,
        micro_batch=args.micro_batch,
        image_size=args.image_size,
        dtype=torch.float32 if args.f32 else torch.bfloat16,
        int8="static" if args.int8_static else args.int8,
        calibration_path=args.calibration,
        device=args.device.split(",")[0],
        mesh=mesh,
    )
    if args.num_views > 2:
        return MultiViewGazePredictor(args.ckpt, num_views=args.num_views, **common)
    return GazePredictor(args.ckpt, encode_rotmat=args.encode_rotmat, share_feature=args.share_feature, **common)


def main(argv: Optional[List[str]] = None) -> int:
    args = get_parser().parse_args(argv)
    bad = refused(args)
    if bad:
        raise SystemExit(f"not supported: {', '.join(bad)}")

    from rot_mvgaze_tpu_torch.serving import BatchingPredictor

    predictor = build_predictor(args)
    # every path before traffic (static int8: the calibration and the frozen
    # pass, the noise's ranges discarded)
    predictor.warmup()
    batching = BatchingPredictor(predictor, max_delay_ms=args.coalesce_ms)
    stats = {"requests": 0, "samples": 0, "time": 0.0}
    max_body = MAX_BODY_BYTES * max(1, (args.num_views + 1) // 2)
    server = ThreadingHTTPServer(
        (args.host, args.port), build_handler(batching, stats, max_body_bytes=max_body)
    )
    print(f"serving on {args.host}:{args.port} (micro_batch={predictor.micro_batch})", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        batching.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
