"""Micro-probes of the training step's cost on the card (port of
``scripts/bench_probes.py``):

  conv1       the 7x7/s2 3->64 stem conv at 224x224, forward and weight
              gradient (bf16, channels_last: cuDNN)
  conv1_s2d   the same math after space-to-depth: 112x112x12 -> 4x4/s1
              (the TPU's rewrite of a 3-channel conv, measured here, not
              adopted)
  bb_train    the R50 backbone forward and backward with train-mode
              BatchNorm, through the port's BN kernels (53 launches of each
              per call)
  bb_eval     the same with eval-mode BatchNorm (affine only): the gap
              bounds what fusing the statistics could win

::

    python -m rot_mvgaze_tpu_torch.bench_probes conv1 conv1_s2d bb_train bb_eval [--batch 256]
        [--steps 30] [--device cpu]

Each probe runs 3 warm-up calls, then ``--steps`` timed calls between two
``torch.cuda.synchronize()`` calls; each call updates its weights by
``-1e-12 * grad``. One JSON line per probe: ``probe``, ``batch_imgs``,
``ms``, ``imgs_per_sec`` and ``device`` (the card's name and power limit).
``--batch`` 256 is both views of 128 pairs.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

PROBES = ("conv1", "conv1_s2d", "bb_train", "bb_eval")


def probe_call(name: str, batch: int, size: int, depth: int, device: torch.device) -> Callable[[], None]:
    """One call of probe ``name`` on seeded inputs: forward, backward and the
    weights' update."""
    g = torch.Generator(device="cpu").manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(device)

    if name in ("conv1", "conv1_s2d"):
        if name == "conv1":
            # NHWC images as an NCHW view with channels_last strides, as the backbone runs them
            x = randn(batch, size, size, 3).to(torch.bfloat16).permute(0, 3, 1, 2)
            w = randn(64, 3, 7, 7, scale=0.1).to(torch.bfloat16).requires_grad_()

            def conv(w):
                return F.conv2d(x, w, stride=2, padding=3)
        else:
            half = size // 2
            x = randn(batch, half, half, 12).to(torch.bfloat16).permute(0, 3, 1, 2)
            x = F.pad(x, (1, 2, 1, 2))  # JAX's [(1, 2), (1, 2)]: the same 112x112 out
            w = randn(64, 12, 4, 4, scale=0.1).to(torch.bfloat16).requires_grad_()

            def conv(w):
                return F.conv2d(x, w)

        def call():
            y = conv(w)
            (gw,) = torch.autograd.grad((y.float() ** 2).sum(), w)
            with torch.no_grad():
                w.sub_(1e-12 * gw)

        return call
    from rot_mvgaze_tpu_torch.models.resnet import BACKBONES

    torch.manual_seed(0)
    backbone = BACKBONES[depth]().to(device=device, memory_format=torch.channels_last)
    backbone.train(name == "bb_train")
    x = randn(batch, size, size, 3).to(torch.bfloat16)
    params = [p for n, p in backbone.named_parameters() if not n.startswith("fc.")]

    def call():
        with torch.autocast(device.type, dtype=torch.bfloat16):
            y = backbone(x)
        grads = torch.autograd.grad((y.float() ** 2).sum(), params)
        with torch.no_grad():
            torch._foreach_add_(params, grads, alpha=-1e-12)

    return call


def run(probes: List[str], batch: int = 256, steps: int = 30, device: str = "cuda", size: int = 224,
        depth: int = 50, log=None) -> List[Dict[str, Any]]:
    from rot_mvgaze_tpu_torch.utils.device import resolve_device
    from rot_mvgaze_tpu_torch.utils.drivers import card_of

    unknown = [p for p in probes if p not in PROBES]
    if unknown:
        raise SystemExit(f"unknown probe(s) {unknown}; choose from {list(PROBES)}")
    dev = resolve_device(device)
    card = card_of(dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    records = []
    for name in probes:
        call = probe_call(name, batch, size, depth, dev)
        for _ in range(3):
            call()
        sync()
        t0 = time.perf_counter()
        for _ in range(steps):
            call()
        sync()
        dt = (time.perf_counter() - t0) / steps
        rec = {"probe": name, "batch_imgs": batch, "ms": dt * 1e3, "imgs_per_sec": batch / dt, "device": card}
        records.append(rec)
        if log is not None:
            log(json.dumps(rec))
        del call
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return records


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("probes", nargs="+", help=f"any of {', '.join(PROBES)}")
    ap.add_argument("--batch", type=int, default=256, help="images (128 samples x 2 views)")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--device", default="cuda", help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    run(args.probes, args.batch, args.steps, args.device, log=lambda line: print(line, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
