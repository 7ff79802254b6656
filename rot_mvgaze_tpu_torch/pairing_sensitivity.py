"""How far the eval's mean angular error moves with the stereo pairing
(port of ``scripts/pairing_sensitivity.py``).

The reference's eval protocol is a mean over its frozen pair index: each
row is scored beside one partner view. This experiment trains a model
briefly on a synthetic corpus, freezes it, and evaluates the same weights
over the same rows with the partner of each row drawn under N seeds
(``pairing="rng"``), and under the reference's index. The spread of the
per-seed means bounds how much the metric depends on the pairing (the
command line defaults to the reference's index, so protocol evals do not
depend on it)::

    python -m rot_mvgaze_tpu_torch.pairing_sensitivity [--out PATH] [--seeds 8]
        [--epochs 4] [--backbone 18] [--image_size 64] [--device cpu]

One JSON record with the per-seed means and their spread, standard
deviation and mean. It runs on the card unless ``--device cpu`` is given;
the corpus is written as packs and read by ``PackedGazeDataset`` (numpy
gathers) on every machine.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from types import SimpleNamespace
from typing import Any, Dict, Iterable, Tuple

import numpy as np


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default="docs/pairing_sensitivity_torch.json")
    p.add_argument("--seeds", type=int, default=8)
    p.add_argument("--epochs", type=int, default=4)
    p.add_argument("--backbone", type=int, default=18)
    p.add_argument("--image_size", type=int, default=64)
    p.add_argument("--n_frames", type=int, default=6)
    p.add_argument("--batch_size", type=int, default=18)
    p.add_argument("--device", default="cuda", help="cuda (the default; raises without a card) or cpu")
    return p


def pairing_errors(
    model: Any,
    root: str,
    subjects: list,
    seeds: Iterable[int],
    image_size: int,
    batch_size: int,
) -> Tuple[Dict[int, float], float]:
    """The frozen ``model``'s mean error over the xgaze corpus (packs, as
    :func:`run` writes it) at ``root`` with each row's partner drawn under
    each of ``seeds``, and under the reference's pair index: ``({seed:
    degrees}, reference degrees)``. Only the partners change between
    evaluations; the rows and their labels stay."""
    from rot_mvgaze_tpu_torch.data.native import PackedGazeDataset
    from rot_mvgaze_tpu_torch.data.pipeline import BatchLoader
    from rot_mvgaze_tpu_torch.evaluate import evaluate_gaze

    def error(**pairing) -> float:
        ds = PackedGazeDataset("xgaze", root, "bgr", subjects, camera_tag="all", use_native=False, **pairing)
        return evaluate_gaze(model, BatchLoader(ds, batch_size=batch_size), image_size=image_size)

    per_seed = {}
    for s in seeds:
        per_seed[s] = error(pairing="rng", seed=s)
        print(f"pairing seed {s}: mean error {per_seed[s]:.4f} deg", flush=True)
    return per_seed, error(pairing="reference", seed=0)


def train_model(root: str, subjects: list, args: argparse.Namespace, device: Any) -> Tuple[Any, int]:
    """``FeatRotationSymm(args.backbone, 3 iterations)`` trained by the
    port's Trainer for ``args.epochs`` epochs on the corpus (float32, the
    Trainer's defaults otherwise). Returns the model and the corpus's pairs."""
    import torch

    from rot_mvgaze_tpu_torch.data.native import PackedGazeDataset
    from rot_mvgaze_tpu_torch.data.pipeline import BatchLoader
    from rot_mvgaze_tpu_torch.losses import IterationLoss, StereoL1Loss
    from rot_mvgaze_tpu_torch.models import FeatRotationSymm
    from rot_mvgaze_tpu_torch.train import Trainer

    train_ds = PackedGazeDataset("xgaze", root, "bgr", subjects, seed=0, use_native=False)
    cfg = SimpleNamespace(
        mode="train", exp_name="pairing_sensitivity", output_dir=os.path.join(root, "_logs"),
        ckpt_resume=None, print_freq=10**9, seed=0, batch_size=args.batch_size,
        test_batch_size=args.batch_size, epochs=args.epochs, save_epoch=10**9,
        image_size=args.image_size, scheduler_step="epoch",
    )
    torch.manual_seed(0)
    trainer = Trainer(cfg, FeatRotationSymm(backbone_depth=args.backbone, num_iter=3),
                      IterationLoss(StereoL1Loss(rel_weight=0.01), iter_decay=0.5),
                      BatchLoader(train_ds, batch_size=args.batch_size, shuffle=True, drop_last=True),
                      None, device=device)
    for epoch in range(args.epochs):
        trainer.train_one_epoch(epoch)
    return trainer.model, len(train_ds)


def run(args: argparse.Namespace, root: str) -> Tuple[Dict[str, Any], Any, list]:
    """The experiment in ``root`` (the corpus is written there): ``(record,
    trained model, subjects)``."""
    from rot_mvgaze_tpu_torch.data.synthetic import write_synthetic_corpus
    from rot_mvgaze_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    subjects = write_synthetic_corpus(root, ["s00.h5", "s01.h5"], n_frames=args.n_frames,
                                      image_size=args.image_size)
    model, n_samples = train_model(root, subjects, args, device)
    per_seed, ref_error = pairing_errors(model, root, subjects, range(args.seeds), args.image_size,
                                         args.batch_size)
    errs = np.array(list(per_seed.values()))
    record = {
        "experiment": "pairing_sensitivity",
        "setup": {"backbone": args.backbone, "image_size": args.image_size, "n_samples": n_samples,
                  "train_epochs": args.epochs, "n_pairing_seeds": args.seeds, "device": str(device)},
        "per_seed_mean_error_deg": {str(k): float(v) for k, v in per_seed.items()},
        "reference_pairing_mean_error_deg": float(ref_error),
        "spread_deg": float(errs.max() - errs.min()),
        "std_deg": float(errs.std()),
        "mean_deg": float(errs.mean()),
    }
    return record, model, subjects


def main(argv=None) -> int:
    args = get_parser().parse_args(argv)
    with tempfile.TemporaryDirectory() as root:
        record, _, _ = run(args, root)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=2)
    print(json.dumps({k: record[k] for k in ("spread_deg", "std_deg", "mean_deg",
                                             "reference_pairing_mean_error_deg")}))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
