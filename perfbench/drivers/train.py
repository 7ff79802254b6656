"""Closed-loop training: the system's train step, one step after another.

Set-up builds the step once through the system's entries (the model and
loss of ``utils.drivers.Workload``, ``train.make_optimizer``,
``train.cyclic_triangular2``, ``make_train_step`` with the augmentation
seed folded by the update count, as the Trainer runs it), loads the
benchmark's seeded weights, and puts ``distinct_batches`` seeded batches on
the device, as a prefetching loader hands them. The first
``checked_steps`` steps run in set-up through the window's own call and
feed; their losses, the first step's answers, the first gradient (from
Adam's first moment) and the parameters' change are kept for the check; ``warmup_steps`` more follow.
The window then runs steps
until ``--seconds`` have passed on the host clock and ends in a
synchronize. Once it has closed and the peak memory is read, the system's
state is freed and the float32 reference repeats the checked steps from
the same weights, batches and seeds.

Traffic keys: ``pairs``, ``distinct_batches``, ``checked_steps``, ``warmup_steps``,
``schedule`` and ``optimizer`` (the system's defaults, restated for the
reference).
"""

from __future__ import annotations

import time
from typing import Any, Dict

import torch

from perfbench import compare, inputs, weights
from perfbench.manifest import sub_seed
from perfbench.reference.train import train_readings


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(tensors)
    if not names:
        return {}
    return dict(zip(names, torch.stack([tensors[n].float().norm() for n in names]).tolist()))


def make_inputs(cfg: Dict[str, Any], traffic: Dict[str, Any], seed: int, dev: torch.device) -> tuple:
    """``(weights seed, batches, augmentation seed)`` of a run: every input
    both sides are handed."""
    g_data = torch.Generator(device=dev).manual_seed(sub_seed(seed, "batches"))
    batches = [inputs.train_batch(traffic["pairs"], cfg["model"]["image_size"], g_data)
               for _ in range(traffic["distinct_batches"])]
    return sub_seed(seed, "weights"), batches, sub_seed(seed, "augment")


def checked_batches(traffic: Dict[str, Any], batches: list) -> list:
    return [batches[t % len(batches)] for t in range(traffic["checked_steps"])]


def control_numbers(cfg: Dict[str, Any], traffic: Dict[str, Any], seed: int, dev: torch.device,
                    precision: str = "fp8") -> Dict[str, float]:
    """The control: the reference with the operands of its products in
    ``precision`` (int8 or float8, a precision below the configuration's
    bf16) in the system's place, judged against the float32 reference on
    the run's inputs."""
    w_seed, batches, aug_seed = make_inputs(cfg, traffic, seed, dev)
    fed = checked_batches(traffic, batches)
    low = train_readings(cfg, traffic, weights.make_state(cfg, w_seed, dev), fed, aug_seed, low_precision=precision)
    ref = train_readings(cfg, traffic, weights.make_state(cfg, w_seed, dev), fed, aug_seed)
    return compare.train_numbers(low, ref)


def run(ctx: Any) -> Dict[str, Any]:
    from rot_mvgaze_tpu_torch.train import cyclic_triangular2, make_optimizer
    from rot_mvgaze_tpu_torch.utils.drivers import Workload
    from rot_mvgaze_tpu_torch.utils.seed import set_seed

    cfg, traffic, dev = ctx.config, ctx.traffic, ctx.device
    model_cfg = cfg["model"]
    if model_cfg["kind"] != "stereo":
        raise ValueError(f"the train driver runs the stereo model, not {model_cfg['kind']!r}")
    pairs, size = traffic["pairs"], model_cfg["image_size"]
    # the Trainer's seeding: cuDNN deterministic, algorithms by heuristics
    set_seed(sub_seed(ctx.seed, "program") % 2**32, dev)
    with torch.device(dev):
        workload = Workload(num_views=2, backbone_depth=model_cfg["backbone_depth"],
                            num_iter=model_cfg["num_iter"], dtype=getattr(torch, model_cfg["dtype"]))
    model = workload.model.to(device=dev, memory_format=torch.channels_last)
    ctx.mark("model")
    w_seed, batches, aug_seed = make_inputs(cfg, traffic, ctx.seed, dev)
    ctx.mark("batches")
    state = weights.make_state(cfg, w_seed, dev)
    model.load_state_dict(state)
    ctx.mark("weights")
    start = {n: state[n] for n, _ in model.named_parameters()}
    sched, opt_cfg = traffic["schedule"], traffic["optimizer"]
    optimizer = make_optimizer(model.parameters(), weight_decay=opt_cfg["weight_decay"])
    step = workload.make_train_step(
        optimizer, image_size=size, fold_key_by_step=True,
        schedule=cyclic_triangular2(sched["base_lr"], sched["max_lr"], sched["step_size_up"],
                                    sched["step_size_down"]))
    if ctx.plant is not None:
        step = ctx.plant(step, optimizer)
    generator = torch.Generator(device=dev).manual_seed(aug_seed)
    beta1 = opt_cfg["betas"][0]
    names = {p: n for n, p in model.named_parameters()}

    ctx.mark("step")
    checked = traffic["checked_steps"]
    losses, grad_norm = [], {}
    for t in range(checked):
        stats = step(batches[t % len(batches)], generator, step=t)
        losses.append(stats["loss_gaze"])
        if t == 0:
            pred_first = stats["pred_gaze"].float().cpu().numpy()
            grad_norm = _norms({names[p]: s["exp_avg"] / (1 - beta1) for p, s in optimizer.state.items()
                                if "exp_avg" in s})
    moved = [n for n in grad_norm]
    change = _norms({n: p.detach() - start[n] for n, p in model.named_parameters() if n in moved})
    program = {"loss": torch.stack(losses).tolist(), "grad_norm": grad_norm, "change_norm": change,
               "pred_first": pred_first}
    del start, state
    ctx.mark("checked_steps")
    first = checked + traffic["warmup_steps"]
    for t in range(checked, first):
        step(batches[t % len(batches)], generator, step=t)
    ctx.mark("warmup")

    images_per_step = 2 * pairs
    window_losses, n = [], 0
    ctx.sync()
    with ctx.window():
        t0 = ctx.window_start()
        while time.perf_counter() - t0 < ctx.seconds:
            with ctx.spans.span("train_step"):
                stats = step(batches[(first + n) % len(batches)], generator, step=first + n)
            window_losses.append(stats["loss_gaze"])
            n += 1
        ctx.sync()
        window_s = time.perf_counter() - t0
    ctx.mark("window_end")
    ctx.log("train_step by quarter of the window (count, mean s): "
            f"{ctx.spans.quarters('train_step', t0, t0 + window_s)}")
    failed = int((~torch.isfinite(torch.stack(window_losses))).sum()) if window_losses else 0
    peak = ctx.memory_peak()

    del step, optimizer, model, workload, stats
    ctx.free()
    state = weights.make_state(cfg, w_seed, dev)
    ref = train_readings(cfg, traffic, state, checked_batches(traffic, batches), aug_seed)
    numbers = compare.train_numbers(program, ref)
    ctx.mark("reference")
    return {
        "e2e": {"train_images_per_s": n * images_per_step / window_s},
        "record": {"steps": n, "images_per_step": images_per_step, "window_s": window_s},
        "numbers": numbers, "attempted": n, "failed": failed, "memory_peak_bytes": peak,
    }
