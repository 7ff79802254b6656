"""Export a serving artifact (``torch.export``) from a checkpoint (port of
``scripts/export_model.py``).

    python -m rot_mvgaze_tpu_torch.export_model --ckpt model.pth.tar \\
        --out artifacts/serving.pt2 --micro_batch 64 \\
        [--device cuda] [--backbone_depth 50] [--num_iter 3] [--num_views 3] \\
        [--share_weights ...] [--f32] [--int8]

The artifact (``<out>`` and its ``<out>.json`` sidecar) holds no weights;
``rot_mvgaze_tpu_torch.export.AotGazePredictor`` serves it with any
checkpoint of the same architecture, on the device type it was exported on
(``--device``, which replaces the JAX script's ``--platforms``). Loading it
needs ``rot_mvgaze_tpu_torch.ops.fusion`` imported (the fuser's operator),
not the model's code.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ckpt", required=True,
                   help="a reference .pth.tar, the port's checkpoint or a JAX .msgpack")
    p.add_argument("--out", required=True, help="artifact output path")
    p.add_argument("--micro_batch", type=int, default=64)
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--device", default="cuda",
                   help="the device type the artifact is traced for and runs on")
    p.add_argument("--backbone_depth", default="50",
                   help="ResNet depth or a variant name (resnext50_32x4d, ...)")
    p.add_argument("--num_iter", type=int, default=3)
    p.add_argument("--num_views", type=int, default=2,
                   help="export the V-view model (V > 2): the artifact's request is stacked "
                        "imgs (B,V,H,W,3) + head_poses (B,V,2); stereo checkpoints load at any V")
    p.add_argument("--share_weights", action="store_true")
    p.add_argument("--encode_rotmat", action="store_true")
    p.add_argument("--share_feature", action="store_true")
    p.add_argument("--ignore_rotmat", action="store_true")
    p.add_argument("--f32", action="store_true", help="export float32 compute (default bfloat16)")
    p.add_argument("--int8", action="store_true",
                   help="export the int8 backbone with dynamic activation scales (calibrated "
                        "scales are live-serving state and do not export)")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = get_parser().parse_args(argv)
    if args.num_views < 2:
        raise SystemExit(f"--num_views must be >= 2, got {args.num_views}")
    if args.num_views > 2 and (args.encode_rotmat or args.share_feature):
        raise SystemExit(f"--num_views {args.num_views} does not support --encode_rotmat / "
                         "--share_feature (stereo-only ablations)")

    import torch

    from rot_mvgaze_tpu_torch.export import export_serving_artifact
    from rot_mvgaze_tpu_torch.serving import GazePredictor, MultiViewGazePredictor

    depth = int(args.backbone_depth) if args.backbone_depth.isdigit() else args.backbone_depth
    common = dict(
        backbone_depth=depth,
        num_iter=args.num_iter,
        share_weights=args.share_weights,
        ignore_rotmat=args.ignore_rotmat,
        micro_batch=args.micro_batch,
        image_size=args.image_size,
        dtype=torch.float32 if args.f32 else torch.bfloat16,
        int8=args.int8,
        device=args.device,
    )
    if args.num_views > 2:
        predictor = MultiViewGazePredictor(args.ckpt, num_views=args.num_views, **common)
    else:
        predictor = GazePredictor(
            args.ckpt, encode_rotmat=args.encode_rotmat, share_feature=args.share_feature, **common
        )
    export_serving_artifact(
        predictor.model, args.out, micro_batch=args.micro_batch, image_size=args.image_size,
        num_views=args.num_views if args.num_views > 2 else None,
    )
    print(f"exported {args.out} ({os.path.getsize(args.out)} bytes), device={predictor.device.type}, "
          f"batch={args.micro_batch}x{args.image_size}^2")
    return 0


if __name__ == "__main__":
    sys.exit(main())
