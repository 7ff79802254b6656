"""Does ``--ema_decay`` help? The moving average's eval error against the raw
weights' (port of ``scripts/probe_ema_benefit.py``).

R18 (one fusion iteration) trains at 32x32 on a learnable synthetic corpus
(labels readable from the pixels, so the eval error can fall) through the
port's ``make_train_step(ema_decay=...)``, at a constant learning rate, and
after every epoch both weight sets are scored on a held-out split. Early on
the average lags (it carries the initial weights); once the raw weights
oscillate around a basin it should match or beat them. The record says which::

    python -m rot_mvgaze_tpu_torch.probe_ema_benefit [--epochs 8] [--decay 0.98] [--out PATH]
        [--device cpu]

It runs on the card unless ``--device cpu`` is given; the corpus is written
as packs and read by ``PackedGazeDataset`` (numpy gathers) on every machine.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from typing import Any, Dict, List, Tuple

import torch


def get_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--decay", type=float, default=0.98)
    ap.add_argument("--image-size", type=int, default=32)
    ap.add_argument("--frames", type=int, default=8, help="frames/subject; 2 train subjects + 1 eval")
    ap.add_argument("--batch", type=int, default=24)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (the default; raises without a card) or cpu")
    return ap


def check_args(ap: argparse.ArgumentParser, args: argparse.Namespace) -> None:
    """The decay must lie in (0, 1): the step's own bound, [0, 1), and not 0,
    where the average is the raw weights and its score means nothing."""
    if not 0.0 < args.decay < 1.0:
        ap.error(f"--decay must be in (0, 1); got {args.decay}")
    if args.epochs < 1:
        ap.error(f"--epochs must be >= 1; got {args.epochs}")


def write_corpus(work: str, args: argparse.Namespace) -> Tuple[list, list]:
    """Learnable synthetic subjects: two to train on (seed 10), one held out
    (seed 77, half the frames, at least 2)."""
    from rot_mvgaze_tpu_torch.data.synthetic import write_synthetic_corpus

    train = write_synthetic_corpus(work, ["t0.h5", "t1.h5"], n_frames=args.frames,
                                   image_size=args.image_size, learnable=True, seed=10)
    held_out = write_synthetic_corpus(work, ["e0.h5"], n_frames=max(args.frames // 2, 2),
                                      image_size=args.image_size, learnable=True, seed=77)
    return train, held_out


def train_and_score(
    model: torch.nn.Module,
    train_loader: Any,
    eval_loader: Any,
    *,
    epochs: int,
    decay: float,
    lr: float,
    image_size: int,
    seed: int,
    augment: bool = True,
    log=None,
) -> Tuple[List[Dict[str, float]], Dict[str, torch.Tensor]]:
    """``epochs`` epochs of the port's train step (Adam at the constant
    ``lr``, the moving average at ``decay``) on ``model``, where it lives;
    after each, the mean eval error of the raw weights and of the average.
    ``augment=False``: the loader's batches are the step's inputs as they
    are (float views). Returns the unrounded history (``epoch``,
    ``raw_deg``, ``ema_deg``) and the average, by parameter name."""
    from rot_mvgaze_tpu_torch.data.pipeline import device_prefetch
    from rot_mvgaze_tpu_torch.evaluate import evaluate_gaze
    from rot_mvgaze_tpu_torch.losses import IterationLoss, StereoL1Loss
    from rot_mvgaze_tpu_torch.train import init_ema, make_optimizer, make_train_step

    device = next(model.parameters()).device
    ema = init_ema(model)
    step = make_train_step(model, IterationLoss(StereoL1Loss(rel_weight=0.01), iter_decay=0.5),
                           make_optimizer(model.parameters(), lr=lr), image_size=image_size,
                           augment=augment, ema_decay=decay, ema=ema, fold_key_by_step=True)
    generator = torch.Generator(device).manual_seed(seed)
    history, n = [], 0
    t0 = time.perf_counter()
    for epoch in range(epochs):
        for batch in device_prefetch(iter(train_loader), device):
            step(batch, generator, step=n)
            n += 1
        raw = evaluate_gaze(model, eval_loader, image_size=image_size)
        avg = evaluate_gaze(model, eval_loader, image_size=image_size, params=ema)
        history.append({"epoch": epoch + 1, "raw_deg": raw, "ema_deg": avg})
        if log is not None:
            log(f"epoch {epoch + 1}: raw={raw:.3f} ema={avg:.3f} [{time.perf_counter() - t0:.0f}s]")
    return history, ema


def make_record(args: argparse.Namespace, history: list, train_rows: int, eval_rows: int,
                device: Any) -> Dict[str, Any]:
    """The JAX script's record (errors rounded to 3 decimals), and the
    device it ran on."""
    rounded = [{"epoch": h["epoch"], "raw_deg": round(h["raw_deg"], 3), "ema_deg": round(h["ema_deg"], 3)}
               for h in history]
    last = rounded[-1]
    return {
        "decay": args.decay,
        "epochs": args.epochs,
        "train_rows": train_rows,
        "eval_rows": eval_rows,
        "history": rounded,
        "final_raw_deg": last["raw_deg"],
        "final_ema_deg": last["ema_deg"],
        "ema_better_final": last["ema_deg"] < last["raw_deg"],
        "ema_better_best": min(h["ema_deg"] for h in rounded) < min(h["raw_deg"] for h in rounded),
        "device": str(device),
    }


def run(args: argparse.Namespace, work: str) -> Dict[str, Any]:
    """The probe in ``work`` (the corpus is written there): the record, and
    under ``"state"`` what a caller may score again: the model, the average,
    the eval loader and the unrounded history."""
    from rot_mvgaze_tpu_torch.data.native import PackedGazeDataset
    from rot_mvgaze_tpu_torch.data.pipeline import BatchLoader
    from rot_mvgaze_tpu_torch.models import FeatRotationSymm
    from rot_mvgaze_tpu_torch.utils.device import resolve_device
    from rot_mvgaze_tpu_torch.utils.seed import set_seed

    device = resolve_device(args.device)
    train_names, eval_names = write_corpus(work, args)
    train_ds = PackedGazeDataset("xgaze", work, "bgr", train_names, seed=args.seed, use_native=False)
    eval_ds = PackedGazeDataset("xgaze", work, "bgr", eval_names, seed=args.seed, use_native=False)
    set_seed(args.seed, device)  # the weights' draws, and cuDNN's deterministic algorithms
    model = FeatRotationSymm(backbone_depth=18, num_iter=1).to(device=device, memory_format=torch.channels_last)
    eval_loader = BatchLoader(eval_ds, batch_size=args.batch)
    history, ema = train_and_score(
        model, BatchLoader(train_ds, batch_size=args.batch, shuffle=True, drop_last=True), eval_loader,
        epochs=args.epochs, decay=args.decay, lr=args.lr, image_size=args.image_size, seed=args.seed,
        log=lambda msg: print(msg, file=sys.stderr, flush=True),
    )
    record = make_record(args, history, len(train_ds), len(eval_ds), device)
    return {"record": record, "state": {"model": model, "ema": ema, "eval_loader": eval_loader,
                                        "history": history}}


def main(argv=None) -> int:
    ap = get_parser()
    args = ap.parse_args(argv)
    check_args(ap, args)
    with tempfile.TemporaryDirectory(prefix="ema_probe_") as work:
        record = run(args, work)["record"]
    print(json.dumps(record))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=2)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
