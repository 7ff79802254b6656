"""A forward check of the flagship model and a multi-device dry run of the
training step (port of the repository's ``__graft_entry__.py``).

- :func:`entry` returns ``(fn, example_args)``: the R50 x 3 iterations bf16
  forward of ``FeatRotationSymm`` at batch 8, 224x224, in eval mode, on the
  card (or the device asked for), with seeded weights and seeded inputs;
  ``fn(*example_args)`` gives the (8, 2) float32 gaze.
- :func:`dryrun_multichip` runs the whole training step (augmentation,
  forward, loss, backward, Adam) over a data mesh of ``n_devices`` devices
  (``parallel.make_mesh``; a device may repeat, so ``["cuda:0"] * 4`` is a
  logical mesh on one card and ``["cpu"] * 2`` one on the CPU), repeats one
  batch and checks that the loss falls and the update count advances, then
  runs the evaluation over the mesh on a batch that does not split evenly
  (padded, the padding's predictions dropped).

::

    python -m rot_mvgaze_tpu_torch.dryrun [N_DEVICES] [CONFIG] [--device cpu]

runs the dry run (8 devices and ``r50-small`` by default, as the JAX
module's command).
"""

from __future__ import annotations

import argparse
import functools
import sys
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

#: (image size, backbone depth, dtype, spatial, views), JAX's configurations:
#: "reduced" R18/64² f32 (the default), "r50-small" the flagship's structure
#: at 64², "flagship" R50/224² bf16, "spatial" R18/64² on a (data n/2,
#: spatial 2) mesh, "multiview" R18/64² at V=3 on a data mesh (each replica
#: one sample's 3 views)
DRYRUN_CONFIGS = {
    "r50-small": (64, 50, "float32", 1, 2),
    "flagship": (224, 50, "bfloat16", 1, 2),
    "reduced": (64, 18, "float32", 1, 2),
    "spatial": (64, 18, "float32", 2, 2),
    "multiview": (64, 18, "float32", 1, 3),
}


def entry(device: Any = "cuda", batch: int = 8, image_size: int = 224, backbone_depth: int = 50,
          num_iter: int = 3, seed: int = 0):
    """``(fn, (params, data))`` of the bf16 eval forward. The weights are
    seeded; the BatchNorm running statistics are estimated from one
    train-mode pass over the example images (as a trained network's would
    scale its activations), then the model is in eval mode. ``params`` are
    the model's parameters and buffers by state-dict name (``fn`` runs
    ``torch.func.functional_call`` with them); ``data`` holds seeded
    preprocessed views and the rotations of seeded head poses."""
    from torch import nn

    from rot_mvgaze_tpu_torch.geometry.gaze import rotation_matrix_2d
    from rot_mvgaze_tpu_torch.models import FeatRotationSymm
    from rot_mvgaze_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    torch.manual_seed(seed)
    model = FeatRotationSymm(backbone_depth=backbone_depth, num_iter=num_iter)
    model = model.to(device=dev, memory_format=torch.channels_last)
    g = torch.Generator(device="cpu").manual_seed(seed + 1)
    data = {
        "img_0": torch.randn(batch, image_size, image_size, 3, generator=g).to(dev),
        "img_1": torch.randn(batch, image_size, image_size, 3, generator=g).to(dev),
        "rot_0": rotation_matrix_2d((torch.rand(batch, 2, generator=g) * 1.6 - 0.8).to(dev)),
        "rot_1": rotation_matrix_2d((torch.rand(batch, 2, generator=g) * 1.6 - 0.8).to(dev)),
    }
    bns = [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]
    for bn in bns:
        bn.reset_running_stats()
        bn.momentum = None  # a cumulative average over the pass
    with torch.no_grad():
        backbone = model._feat_extractor.train()
        backbone(torch.cat([data["img_0"], data["img_1"]]))
    for bn in bns:
        bn.momentum = 0.1
        bn.num_batches_tracked.zero_()
    model.eval()
    params = {k: v.detach() for k, v in model.state_dict().items()}

    @torch.no_grad()
    def fn(params: Dict[str, torch.Tensor], data: Dict[str, torch.Tensor]) -> torch.Tensor:
        with torch.autocast(dev.type, dtype=torch.bfloat16):
            out = torch.func.functional_call(model, params, (data,))
        return out["pred_gaze"].float()

    return fn, (params, data)


def mesh_devices(n_devices: int, device: str = "cuda") -> List[torch.device]:
    """``n_devices`` devices for the dry run: the CPU ``n`` times for
    ``device="cpu"``; on the card, the first ``n`` cards where that many are
    visible, else the first card ``n`` times (a logical mesh)."""
    from rot_mvgaze_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        return [dev] * n_devices
    if dev.index is None and torch.cuda.device_count() >= n_devices:
        return [torch.device("cuda", i) for i in range(n_devices)]
    return [torch.device("cuda", dev.index or 0)] * n_devices


def dryrun_multichip(n_devices: int, n_steps: int = 4, config: str = "reduced", device: str = "cuda",
                     devices: Optional[Sequence[Any]] = None) -> Dict[str, Any]:
    """The multi-device dry run (module docstring) at ``config``
    (:data:`DRYRUN_CONFIGS`) over ``devices``, default
    :func:`mesh_devices` ``(n_devices, device)``. One sample per data
    replica; a constant learning rate of 1e-4; the same augmentation draws
    every step (a generator seeded 1 each time, as JAX's constant key).
    Progress goes to stderr, the result line to stdout. Returns the losses,
    the update count and the evaluation's rows."""
    from rot_mvgaze_tpu_torch.parallel.mesh import dp_size, make_mesh, with_spatial_floor
    from rot_mvgaze_tpu_torch.train import make_optimizer
    from rot_mvgaze_tpu_torch.utils.drivers import Workload, to_device

    say = functools.partial(print, flush=True, file=sys.stderr)
    t0 = time.monotonic()
    if n_steps < 4:
        # with 3 steps the first and last pairs overlap, and the trend check
        # becomes one comparison that a single Adam bounce can fail
        raise ValueError(f"n_steps must be >= 4 for the pair-averaged loss-trend assertion (non-overlapping "
                         f"first/last pairs), got {n_steps}")
    if config not in DRYRUN_CONFIGS:
        raise ValueError(f"unknown dryrun config {config!r}; choose from {sorted(DRYRUN_CONFIGS)}")
    size, depth, dtype_name, spatial, num_views = DRYRUN_CONFIGS[config]
    devices = list(devices) if devices is not None else mesh_devices(n_devices, device)
    if len(devices) != n_devices:
        raise ValueError(f"need {n_devices} devices, got {len(devices)}")
    dtype = getattr(torch, dtype_name)
    say(f"dryrun_multichip({n_devices}) config={config} (R{depth}/{size}^2 {dtype_name}"
        + (f", spatial={spatial}" if spatial > 1 else "") + (f", V={num_views}" if num_views > 2 else "")
        + f") n_steps={n_steps} devices={[str(d) for d in devices]}")
    mesh = make_mesh(devices, spatial=spatial)
    first = mesh.first_device
    n_data = dp_size(mesh)
    batch = n_data  # one sample per data replica
    torch.manual_seed(0)
    workload = Workload(num_views=num_views, backbone_depth=depth, num_iter=3, dtype=dtype)
    model = with_spatial_floor(workload.model, mesh).to(device=first, memory_format=torch.channels_last)
    say(f"[{time.monotonic() - t0:6.1f}s] model on {first}")
    rng = np.random.default_rng(0)
    host = to_device(workload.host_batch(rng, batch, size), first)
    optimizer = make_optimizer(model.parameters())
    # a constant rate: repeating one batch must lower the loss within n_steps
    # (the cyclic schedule starts at 1e-6); 1e-4, not 1e-3, which from random
    # BatchNorm statistics first spikes the loss
    train_step = workload.make_train_step(optimizer, image_size=size, schedule=lambda _t: 1e-4, mesh=mesh)
    losses = []
    for i in range(n_steps):
        stats = train_step(host, torch.Generator(first).manual_seed(1), step=i)
        losses.append(float(stats["loss_gaze"]))
        say(f"[{time.monotonic() - t0:6.1f}s] step {i}: loss={losses[-1]:.5f}")
        assert np.isfinite(losses[-1]), f"non-finite loss at step {i}: {losses}"
    counts = {int(s["step"]) for s in optimizer.state.values()}
    assert counts == {n_steps}, f"update count {counts} != {n_steps}"
    # Adam from random weights bounces step to step: compare the first and
    # last pairs, so the check reads the trend, not one bounce
    assert (losses[-2] + losses[-1]) / 2 < (losses[0] + losses[1]) / 2, (
        f"loss did not decrease over {n_steps} steps on a repeated batch: {losses}")

    ragged = batch + max(1, batch // 2)  # not a multiple of the data axis (for n_data > 1)
    eval_step = workload.make_eval_step(image_size=size, mesh=mesh)
    eval_batch = to_device(workload.host_batch(rng, ragged, size), first)
    say(f"[{time.monotonic() - t0:6.1f}s] evaluation over the mesh ...")
    preds = eval_step(eval_batch)["pred_gaze"]
    assert preds.shape == (ragged, 2), f"eval predictions {tuple(preds.shape)} != ({ragged}, 2)"
    assert torch.isfinite(preds).all(), "non-finite eval predictions"
    padded_to = -(-ragged // n_data) * n_data
    print(f"dryrun_multichip({n_devices}) OK [{config}: R{depth}/{size}^2 {dtype_name}, "
          f"{time.monotonic() - t0:.1f}s]: losses={['%.5f' % v for v in losses]} "
          f"error={float(stats['error_gaze']):.3f} deg eval={ragged} rows padded to {padded_to} over "
          f"{n_devices} devices" + (f" (data={n_data} x spatial={spatial})" if spatial > 1 else ""), flush=True)
    return {"losses": losses, "updates": n_steps, "eval_rows": ragged, "padded_to": padded_to,
            "devices": [str(d) for d in devices], "seconds": time.monotonic() - t0}


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_devices", nargs="?", type=int, default=8)
    ap.add_argument("config", nargs="?", default="r50-small", choices=sorted(DRYRUN_CONFIGS))
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: the first N cards, or the first card N times; raises "
                         "without one) or cpu (the CPU N times)")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_devices, args.steps, args.config, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
