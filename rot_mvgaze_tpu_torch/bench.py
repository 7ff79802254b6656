"""The training-step benchmark: images/s of the whole step on the card (port
of the repository's ``bench.py``).

The step is ``train.make_train_step``'s, the flagship configuration by
default: ``FeatRotationSymm(backbone_depth=50, num_iter=3)`` over two-view
224x224 batches of 128 pairs per card, augmentation, forward, loss,
backward and Adam, in bf16 autocast with float32 parameters, the
augmentation draws folded by the update count. The batch is made once from
a seeded generator and stays on the device. 3 warm-up steps, then 20 timed
steps between two ``torch.cuda.synchronize()`` calls; CUDA events around
the same 20 steps give the device's reading beside the host's. The first
warm-up step runs under ``torch.utils.flop_counter.FlopCounterMode``, with
a formula for the fuser's custom op ``mvgaze::rotate_concat_matmul_relu``
(2·B·K·N per call; its backward is counted from the products it runs),
which gives ``flops_per_step``::

    python -m rot_mvgaze_tpu_torch.bench [--device cpu]

Settings are the JAX benchmark's environment variables, with its defaults
and refusals: ``BENCH_BATCH`` (pairs per card, 128), ``BENCH_SIZE`` (224),
``BENCH_DEPTH`` (50), ``BENCH_ITERS`` (3), ``BENCH_NUM_VIEWS`` (2; V > 2 is
the V-view model, V images per sample), ``BENCH_BN_STAT_SUBSAMPLE``,
``BENCH_FUSE_VIEWS``, ``BENCH_REMAT`` and ``BENCH_FREEZE_BN`` (which
refuses the train-mode BatchNorm options it would make inert).
``BENCH_PALLAS_FUSION`` and ``BENCH_PALLAS_BN`` are taken as the command
line takes ``--use_pallas_*``: on the card the kernels are the path, and
``BENCH_PALLAS_BN=residual`` is refused. ``BENCH_COMPILER_OPTIONS`` (XLA
compiler options) and ``BENCH_PEAK_TFLOPS`` / ``BENCH_PEAK_GBPS`` (a TPU's
peaks) have no counterpart and are refused.

With more than one visible card the step runs over a data mesh of them
(``parallel.make_mesh``; the model on the first, each card 128 pairs, or
with V > 2 128 frames of V views, of the global batch), and the record adds
``n_chips`` and ``total_imgs_per_sec``. ``--device cuda:0,cuda:0`` is a
logical mesh of two replicas on one card.

Prints one JSON line: the JAX record's ``metric``, ``value`` (images/s per
card), ``unit`` and, for a workload other than the default, ``config``;
``device`` (the card's name and power limit); ``flops_per_step``; ``mfu``,
``flops_per_step`` x steps/s over 989e12 FLOP/s per card, the H100 SXM's
published dense bf16 rate (at its 700 W limit; ``device`` says the card's
own), null on the CPU; and ``value_by_cuda_events``. Left out: JAX's
``hbm_bw_util`` (PyTorch has no counterpart of XLA's bytes-accessed count)
and ``vs_baseline`` (an estimate for another card from an earlier round;
no speed number carries over).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict, Mapping, Optional

import torch

#: the H100 SXM's published dense bf16 tensor-core rate, FLOP/s
H100_BF16_FLOPS = 989e12
DEFAULT_WORKLOAD = (50, 3, 224, 2)  # depth, fusion iterations, image size, views
WARMUP = 3  # warm-up steps, the first under FlopCounterMode


def read_settings(env: Mapping[str, str] = os.environ) -> Dict[str, Any]:
    """The benchmark's settings from ``env``; ``SystemExit`` on a refused
    one, as the JAX benchmark exits."""
    for name, why in (("BENCH_COMPILER_OPTIONS", "XLA compiler options"),
                      ("BENCH_PEAK_TFLOPS", "a TPU's peak; the card's published peak is used"),
                      ("BENCH_PEAK_GBPS", "a TPU's peak; the card's published peak is used")):
        if env.get(name):
            raise SystemExit(f"{name} has no counterpart in the port ({why})")
    num_views = int(env.get("BENCH_NUM_VIEWS", "2"))
    if num_views < 2:
        raise SystemExit(f"BENCH_NUM_VIEWS must be >= 2 (got {num_views}); the model is defined over "
                         "at least one view pair")
    pallas_bn = env.get("BENCH_PALLAS_BN", "0")
    if pallas_bn not in ("0", "1", "residual"):
        raise SystemExit(f"BENCH_PALLAS_BN must be 0, 1 or residual; got {pallas_bn!r}")
    if pallas_bn == "residual":
        raise SystemExit("BENCH_PALLAS_BN=residual is refused: on the card every train-mode BatchNorm "
                         "runs the port's kernels")
    subsample = int(env.get("BENCH_BN_STAT_SUBSAMPLE", "1"))
    stereo_opts: Dict[str, Any] = {}
    if env.get("BENCH_PALLAS_FUSION", "0") == "1":
        stereo_opts["use_pallas_fusion"] = True
    if pallas_bn == "1":
        stereo_opts["use_pallas_bn"] = True
    if subsample > 1:
        stereo_opts["bn_stat_subsample"] = subsample
    if env.get("BENCH_FUSE_VIEWS", "0") == "1":
        stereo_opts["fuse_views"] = True
    freeze_bn = env.get("BENCH_FREEZE_BN", "0") == "1"
    if freeze_bn:
        inert = [name for name, on in (("BENCH_PALLAS_BN", pallas_bn != "0"),
                                       ("BENCH_BN_STAT_SUBSAMPLE", subsample > 1),
                                       ("BENCH_FUSE_VIEWS", env.get("BENCH_FUSE_VIEWS", "0") == "1"))
                 if on]
        if inert:
            raise SystemExit(f"BENCH_FREEZE_BN=1 runs eval-mode normalization; these train-mode-BN "
                             f"options would be silently inert: {', '.join(inert)}")
    return {
        "batch": int(env.get("BENCH_BATCH", "128")),
        "size": int(env.get("BENCH_SIZE", "224")),
        "depth": int(env.get("BENCH_DEPTH", "50")),
        "num_iter": int(env.get("BENCH_ITERS", "3")),
        "num_views": num_views,
        "remat": env.get("BENCH_REMAT", "0") == "1",
        "freeze_bn": freeze_bn,
        "stereo_opts": stereo_opts,
    }


def fuser_flops(img_feat_shape, rot_feat_shape, rot_shape, w1_shape, b1_shape, *args, out_shape=None,
                **kwargs) -> int:
    """FLOPs of one call of the fuser's custom op: the (B, D+3V) x (D+3V, H)
    product, 2·B·K·N (the 3x3 rotation and the ReLU are not counted)."""
    b = img_feat_shape[0]
    h, k = w1_shape
    return 2 * b * k * h


def count_flops(fn) -> tuple:
    """``(fn(), FLOPs it ran)`` under ``FlopCounterMode``, the fuser's custom
    op counted by :func:`fuser_flops`."""
    from torch.utils.flop_counter import FlopCounterMode

    import rot_mvgaze_tpu_torch.ops.fusion  # noqa: F401  (registers the custom op)

    mode = FlopCounterMode(display=False,
                           custom_mapping={torch.ops.mvgaze.rotate_concat_matmul_relu: fuser_flops})
    with mode:
        out = fn()
    return out, mode.get_total_flops()


def run(settings: Dict[str, Any], device: str = "cuda", steps: int = 20, log=None) -> Dict[str, Any]:
    """The benchmark: returns ``{"record", "steps_run", "devices"}``. The
    launch counters of the kernels move by ``steps_run`` steps' launches."""
    import numpy as np

    from rot_mvgaze_tpu_torch.parallel.mesh import make_mesh, visible_devices
    from rot_mvgaze_tpu_torch.train import cyclic_triangular2, make_optimizer
    from rot_mvgaze_tpu_torch.utils.device import resolve_device
    from rot_mvgaze_tpu_torch.utils.drivers import Workload, card_of, to_device
    from rot_mvgaze_tpu_torch.utils.seed import set_seed

    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    devices = visible_devices(device)
    if not devices:
        resolve_device("cuda")  # raises: no card
    first = resolve_device(devices[0])
    n_dev = len(devices)
    s = settings
    batch = s["batch"] * n_dev
    generator = set_seed(0, first)
    try:
        workload = Workload(num_views=s["num_views"], backbone_depth=s["depth"], num_iter=s["num_iter"],
                            dtype=torch.bfloat16, remat=s["remat"], **s["stereo_opts"])
    except ValueError as e:
        raise SystemExit(f"BENCH_NUM_VIEWS={s['num_views']}: {e}")
    model = workload.model.to(device=first, memory_format=torch.channels_last)
    host = workload.host_batch(np.random.default_rng(0), batch, s["size"])
    data = to_device(host, first)
    kw: Dict[str, Any] = {"fold_key_by_step": True, "freeze_bn": s["freeze_bn"]}
    if n_dev > 1:
        kw["mesh"] = make_mesh(devices)
    step = workload.make_train_step(make_optimizer(model.parameters()), image_size=s["size"],
                                    schedule=cyclic_triangular2(1e-6, 1e-3, 1000, 1000), **kw)

    def sync():
        if first.type == "cuda":
            for d in {d for d in devices}:
                torch.cuda.synchronize(d)

    _, flops = count_flops(lambda: step(data, generator, step=0))
    for i in range(1, WARMUP):
        step(data, generator, step=i)
    sync()
    events = None
    if first.type == "cuda":
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    t0 = time.perf_counter()
    if events:
        events[0].record()
    for i in range(WARMUP, WARMUP + steps):
        stats = step(data, generator, step=i)
    if events:
        events[1].record()
    sync()
    dt = time.perf_counter() - t0
    loss = float(stats["loss_gaze"])
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss} after {WARMUP + steps} steps")

    images = s["num_views"] * batch * steps
    per_card = images / dt / n_dev
    depth, num_iter, size, views = s["depth"], s["num_iter"], s["size"], s["num_views"]
    record: Dict[str, Any] = {
        "metric": f"rotmv_r{depth}{f'_mv{views}' if views > 2 else ''}_train_step_throughput",
        "value": per_card,
        "unit": f"images/sec/card ({views}-view {size}^2, fwd+bwd+adam, bf16)",
    }
    if (depth, num_iter, size, views) != DEFAULT_WORKLOAD:
        record["config"] = {"backbone_depth": depth, "num_iter": num_iter, "image_size": size}
        if views > 2:
            record["config"]["num_views"] = views
    if s["freeze_bn"]:
        record.setdefault("config", {})["freeze_bn"] = True
    if n_dev > 1:
        record["n_chips"] = n_dev
        record["total_imgs_per_sec"] = per_card * n_dev
    record["device"] = card_of(first)
    record["flops_per_step"] = flops
    record["mfu"] = (flops * steps / dt / (H100_BF16_FLOPS * n_dev)) if first.type == "cuda" else None
    record["value_by_cuda_events"] = (images / (events[0].elapsed_time(events[1]) / 1e3) / n_dev
                                      if events else None)
    if log is not None:
        log(f"bench: {per_card:.1f} images/s per card over {steps} steps of {batch} samples, loss {loss:.5f}")
    return {"record": record, "steps_run": WARMUP + steps, "devices": [str(d) for d in devices]}


def get_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: every visible card; raises without one), cpu, one "
                         "device, or a comma-separated list of devices for a data mesh (repeats "
                         "allowed: cuda:0,cuda:0 is a logical mesh on one card)")
    return ap


def main(argv: Optional[list] = None) -> int:
    args = get_parser().parse_args(argv)
    settings = read_settings()
    out = run(settings, args.device, log=lambda msg: print(msg, file=sys.stderr, flush=True))
    print(json.dumps(out["record"]), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
