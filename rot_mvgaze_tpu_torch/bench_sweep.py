"""Where the training step's time goes: the step split into its parts on the
card (port of ``scripts/bench_sweep.py``).

``FeatRotationSymm(backbone_depth=50, num_iter=3)``, bf16 autocast, 224x224,
batches of ``--batch`` pairs made once from a seeded generator and kept on
the device; each variant runs 3 warm-up calls, then ``--steps`` timed calls
between two ``torch.cuda.synchronize()`` calls:

  full       the whole step of ``bench`` (augmentation, forward, loss,
             backward, Adam)
  noaug      the step on views augmented once beforehand (float32):
             forward, loss, backward, Adam
  augonly    the augmentation of both views alone (float32)
  bf16aug    the same augmentation computed in bfloat16
  fwdonly    the eval forward alone (eval preprocessing, eval-mode
             BatchNorm, bf16 autocast)

::

    python -m rot_mvgaze_tpu_torch.bench_sweep full noaug augonly bf16aug fwdonly [--batch 128]
        [--steps 20] [--device cpu]

One JSON line per variant: ``variant``, ``batch``, ``ms_per_step``,
``imgs_per_sec`` (2 images per pair) and ``device`` (the card's name and
power limit). The JAX script chains each call on the previous one's output
to defeat its remote backend's short-circuiting; the card needs no chain.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

VARIANTS = ("full", "noaug", "augonly", "bf16aug", "fwdonly")


def variant_calls(workload, data: Dict[str, torch.Tensor], size: int, generator: torch.Generator
                  ) -> Dict[str, Callable[[int], Any]]:
    """``{variant: call(i)}`` over one model; call ``i`` is the i-th of its
    variant (the update count of the steps)."""
    from rot_mvgaze_tpu_torch.augment.ops import eval_preprocess
    from rot_mvgaze_tpu_torch.geometry.gaze import rotation_matrix_2d
    from rot_mvgaze_tpu_torch.train import augment_views, cyclic_triangular2, make_optimizer

    model = workload.model
    schedule = cyclic_triangular2(1e-6, 1e-3, 1000, 1000)

    def step_of(**kw):
        return workload.make_train_step(make_optimizer(model.parameters()), image_size=size,
                                        schedule=schedule, **kw)

    full = step_of(fold_key_by_step=True)
    noaug = step_of(augment=False)
    pre = None

    def noaug_call(i):
        nonlocal pre
        if pre is None:
            with torch.no_grad():
                pre = {**data, **augment_views(generator, data, size, torch.float32)}
        return noaug(pre, step=i)

    @torch.no_grad()
    def fwdonly(i):
        model.eval()
        batch = {"img_0": eval_preprocess(data["img_0"], size), "img_1": eval_preprocess(data["img_1"], size),
                 "rot_0": rotation_matrix_2d(data["head_pose_0"]),
                 "rot_1": rotation_matrix_2d(data["head_pose_1"])}
        with torch.autocast(data["img_0"].device.type, dtype=torch.bfloat16):
            return model(batch)["pred_gaze"]

    return {
        "full": lambda i: full(data, generator, step=i),
        "noaug": noaug_call,
        "augonly": lambda i: augment_views(generator, data, size, torch.float32),
        "bf16aug": lambda i: augment_views(generator, data, size, torch.bfloat16),
        "fwdonly": fwdonly,
    }


def run(variants: List[str], batch: int = 128, steps: int = 20, device: str = "cuda", depth: int = 50,
        size: int = 224, num_iter: int = 3, log=None) -> List[Dict[str, Any]]:
    """One record per variant, in the order given."""
    from rot_mvgaze_tpu_torch.utils.device import resolve_device
    from rot_mvgaze_tpu_torch.utils.drivers import Workload, card_of, make_host_batch, to_device
    from rot_mvgaze_tpu_torch.utils.seed import set_seed

    unknown = [v for v in variants if v not in VARIANTS]
    if unknown:
        raise SystemExit(f"unknown variant(s) {unknown}; choose from {list(VARIANTS)}")
    dev = resolve_device(device)
    generator = set_seed(0, dev)
    workload = Workload(backbone_depth=depth, num_iter=num_iter, dtype=torch.bfloat16)
    workload.model.to(device=dev, memory_format=torch.channels_last)
    data = to_device(make_host_batch(np.random.default_rng(0), batch, size), dev)
    calls = variant_calls(workload, data, size, generator)
    card = card_of(dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    records = []
    for v in variants:
        call = calls[v]
        for i in range(3):
            call(i)
        sync()
        t0 = time.perf_counter()
        for i in range(3, 3 + steps):
            call(i)
        sync()
        dt = (time.perf_counter() - t0) / steps
        rec = {"variant": v, "batch": batch, "ms_per_step": dt * 1e3, "imgs_per_sec": 2 * batch / dt,
               "device": card}
        records.append(rec)
        if log is not None:
            log(json.dumps(rec))
    return records


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="+", help=f"any of {', '.join(VARIANTS)}")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--device", default="cuda", help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    run(args.variants, args.batch, args.steps, args.device, log=lambda line: print(line, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
