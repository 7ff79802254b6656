"""One rank of the port's data-parallel CPU tests (tests/test_torch_distributed.py).

    RANK=r WORLD_SIZE=n LOCAL_RANK=0 MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/_torch_dp_worker.py SCENARIO OUT_DIR [ARG]

joins the ``gloo`` group through ``rot_mvgaze_tpu_torch.parallel.initialize``,
runs SCENARIO on its shard and saves what it saw to
``OUT_DIR/SCENARIO_rank{r}.pt``. It imports the port alone (no JAX). The
one-process reference at the concatenated batch runs the same functions
(``op_case`` in the test; ``step_case`` on rank 0, which saves the
comparison rather than the states, to keep the files small)."""

import hashlib
import os
import signal
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from rot_mvgaze_tpu_torch import parallel  # noqa: E402

# --- the BN op: global statistics and the subsample's global prefix -------

OP_IMAGES, OP_C, OP_HW = 3, 8, 4  # images per rank, channels, height = width
OP_CASES = [  # (subsample, residual, relu)
    (1, False, True),
    (1, True, True),
    (2, False, False),
    (2, True, True),
    (4, False, True),
]


def op_inputs(world):
    """The global batch of the op cases: x, residual, the upstream gradient
    (world * OP_IMAGES images), scale and bias, from numpy's seed 0."""
    rng = np.random.default_rng(0)
    n = world * OP_IMAGES
    shape = (n, OP_C, OP_HW, OP_HW)
    x = rng.normal(0.5, 2.0, shape).astype(np.float32)
    res = rng.normal(size=shape).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, OP_C).astype(np.float32)
    bias = rng.normal(size=OP_C).astype(np.float32)
    return x, res, g, scale, bias


def op_case(x, res, g, scale, bias, subsample, residual, relu, group=None):
    """(y, mean, var, dx, dres, dscale, dbias) of fused_batchnorm_act on
    the given rows, forward and backward."""
    from rot_mvgaze_tpu_torch.ops.batchnorm import fused_batchnorm_act

    def leaf(a):
        return torch.from_numpy(np.ascontiguousarray(a)).contiguous(
            memory_format=torch.channels_last).requires_grad_(True)

    xt, rt = leaf(x), leaf(res) if residual else None
    st, bt = (torch.from_numpy(v.copy()).requires_grad_(True) for v in (scale, bias))
    y, mean, var = fused_batchnorm_act(xt, st, bt, rt, 1e-5, relu, subsample, group)
    y.backward(torch.from_numpy(np.ascontiguousarray(g)).contiguous(memory_format=torch.channels_last))
    return {"y": y.detach(), "mean": mean.detach(), "var": var.detach(), "dx": xt.grad,
            "dres": rt.grad if residual else None, "dscale": st.grad, "dbias": bt.grad}


def run_ops(rank, world, group):
    x, res, g, scale, bias = op_inputs(world)
    rows = slice(rank * OP_IMAGES, (rank + 1) * OP_IMAGES)
    return [op_case(x[rows], res[rows], g[rows], scale, bias, *case, group=group) for case in OP_CASES]


# --- one train step: the model, augmentation and Adam ---------------------

STEP_PAIRS, STEP_SRC, STEP_SIZE = 4, 36, 32  # pairs per rank, source and model image sizes
STEP_CASES = {  # name -> (model flags, grad_accum)
    "default": ({}, 1),
    "subsample": ({"bn_stat_subsample": 2}, 1),
    "share_feature": ({"share_feature": True}, 1),
    "grad_accum_remat": ({"remat": True}, 2),
}


def step_batch(world):
    """The global batch of uint8 stereo pairs (world * STEP_PAIRS), seed 1."""
    rng = np.random.default_rng(1)
    n = world * STEP_PAIRS
    f32 = np.float32
    return {
        "img_0": rng.integers(0, 256, (n, STEP_SRC, STEP_SRC, 3), dtype=np.uint8),
        "img_1": rng.integers(0, 256, (n, STEP_SRC, STEP_SRC, 3), dtype=np.uint8),
        "head_pose_0": rng.uniform(-0.5, 0.5, (n, 2)).astype(f32),
        "head_pose_1": rng.uniform(-0.5, 0.5, (n, 2)).astype(f32),
        "gt_gaze": rng.uniform(-0.5, 0.5, (n, 2)).astype(f32),
        "gt_gaze_1": rng.uniform(-0.5, 0.5, (n, 2)).astype(f32),
    }


def step_case(name, batch, group=None, n_steps=2):
    """``n_steps`` float32 updates of R18 x 1 from seed 0 with augmentation
    on (draws folded by the step from one seed) through make_train_step;
    returns each step's loss and error, the first update's gradients (after
    the average over ranks) and the state after the updates."""
    from rot_mvgaze_tpu_torch.losses import IterationLoss, StereoL1Loss
    from rot_mvgaze_tpu_torch.models import FeatRotationSymm
    from rot_mvgaze_tpu_torch.train import cyclic_triangular2, make_optimizer, make_train_step

    flags, grad_accum = STEP_CASES[name]
    torch.manual_seed(0)
    model = FeatRotationSymm(backbone_depth=18, num_iter=1, **flags).to(memory_format=torch.channels_last)
    parallel.set_batchnorm_group(model, group)
    metrics = IterationLoss(StereoL1Loss(rel_weight=0.01, reference_decay=1.0), iter_decay=0.5)
    step = make_train_step(
        model, metrics, make_optimizer(model.parameters()), image_size=STEP_SIZE,
        # tests/test_torch_train.py's trajectory schedule: lr 1e-6, then 3.4e-5
        schedule=cyclic_triangular2(base_lr=1e-6, max_lr=1e-4, step_size_up=3, step_size_down=3),
        grad_accum=grad_accum, fold_key_by_step=True, group=group,
    )
    generator = torch.Generator().manual_seed(7)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    stats, grads = [], None
    for i in range(n_steps):
        s = step(tbatch, generator, step=i)
        stats.append((float(s["loss_gaze"]), float(s["error_gaze"])))
        if grads is None:
            grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    return {"stats": stats, "grads": grads,
            "state": {k: v.detach().clone() for k, v in model.state_dict().items()}}


def state_digest(state) -> str:
    """A digest of a state dict's bits: equal digests, the same state."""
    h = hashlib.sha256()
    for key, value in state.items():
        h.update(key.encode())
        h.update(value.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def compare_step(got, want) -> dict:
    """The two-rank run ``got`` against the one-process run ``want`` of
    step_case: their stats, each gradient's largest |difference| over the
    tensor's largest |gradient|, each parameter's and BN buffer's largest
    |difference|, and whether num_batches_tracked agree."""
    grads = {k: ((got["grads"][k] - v).abs().max() / v.abs().max()).item() for k, v in want["grads"].items()}
    diffs = {k: (got["state"][k].double() - v.double()).abs().max().item()
             for k, v in want["state"].items() if not k.endswith("num_batches_tracked")}
    tracked = all(int(got["state"][k]) == int(v) for k, v in want["state"].items()
                  if k.endswith("num_batches_tracked"))
    return {"stats": got["stats"], "single_stats": want["stats"], "grad_rel": grads,
            "same_grad_keys": got["grads"].keys() == want["grads"].keys(), "diffs": diffs,
            "tracked_equal": tracked}


def run_steps(rank, world, group):
    """Every step case over the ranks, then, on rank 0, the same case in one
    process on the concatenated batch and the comparison (files stay
    small: no state leaves a process), and every rank's state digest."""
    batch = step_batch(world)
    rows = slice(rank * STEP_PAIRS, (rank + 1) * STEP_PAIRS)
    local = {k: v[rows] for k, v in batch.items()}
    out = {}
    for name in STEP_CASES:
        got = step_case(name, local, group)
        digests = parallel.all_gather_object(state_digest(got["state"]))
        if rank == 0:
            want = step_case(name, batch)
            out[name] = {**compare_step(got, want), "ranks_equal": len(set(digests)) == 1}
            if name == "default":
                torch.manual_seed(0)
                from rot_mvgaze_tpu_torch.models import FeatRotationSymm

                key = "_gaze_estimators.0.blocks.1.0.weight"
                init = FeatRotationSymm(backbone_depth=18, num_iter=1).state_dict()[key]
                out[name]["moved"] = (want["state"][key] - init).abs().max().item()
            if name == "share_feature":
                running = want["state"]["_img_fusers.0._batchnorm.running_mean"]
                out[name]["intensity_moved"] = (running - 1.0).abs().max().item()
    return out


# --- the Trainer through the command line ---------------------------------


def run_trainer(rank, world, group, data_path):
    """build_experiment under the process group (batch rounding, sharded
    loaders, rank 0's output directory), the aggregated evaluation and
    breakdown, then one epoch in which only rank 1 gets a preemption signal
    after its first update: every rank must stop at the same step, and rank
    0 alone writes."""
    from rot_mvgaze_tpu_torch.cli import main as cli

    out_root = os.path.join(os.path.dirname(data_path), f"logs_rank{rank}")
    args = cli.get_parser().parse_args([
        "--exp_name", "mpiinv_known", "--data_path", data_path, "-out", out_root, "--device", "cpu",
        "--backbone_depth", "18", "--num_iter", "1", "--image_size", "32", "--batch_size", "7",
        "--test_batch_size", "25", "--native_loader", "false", "--num_workers", "1",
        "--bf16", "false", "--epochs", "1",
    ])
    trainer = cli.build_experiment(args)
    error = trainer.test(-1)
    detail = trainer.test_breakdown()
    step_fn = trainer._train_step

    def step_then_signal(batch, generator=None, *, step):
        stats = step_fn(batch, generator, step=step)
        if rank == 1 and step == 0:
            os.kill(os.getpid(), signal.SIGTERM)
        return stats

    trainer._train_step = step_then_signal
    trainer.train()  # evaluates, trains until the agreed stop, saves
    written = sorted(os.path.relpath(os.path.join(d, f), out_root)
                     for d, _, fs in os.walk(out_root) for f in fs)
    return {"error": error, "n_samples": detail["n"], "per_camera_n": sum(
        v["n"] for v in detail["per_camera"].values()), "step": trainer.step,
        "output_dir": args.output_dir, "batch_size": args.batch_size,
        "local_batch": trainer.train_loader.batch_size, "written": written,
        "digest": state_digest(trainer.model.state_dict())}


def main():
    scenario, out_dir = sys.argv[1], sys.argv[2]
    torch.set_num_threads(2)
    assert parallel.initialize("cpu")
    rank, world, group = parallel.process_index(), parallel.process_count(), parallel.device_group()
    if scenario == "ops":
        result = run_ops(rank, world, group)
    elif scenario == "steps":
        result = run_steps(rank, world, group)
    elif scenario == "trainer":
        result = run_trainer(rank, world, group, sys.argv[3])
    else:
        raise SystemExit(f"unknown scenario {scenario}")
    torch.save(result, os.path.join(out_dir, f"{scenario}_rank{rank}.pt"))
    parallel.shutdown()


if __name__ == "__main__":
    main()
