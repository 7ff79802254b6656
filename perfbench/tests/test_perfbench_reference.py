"""The frozen float32 reference against the system's CPU path at a small
size: the same seeded weights and inputs through both, in float32."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench import inputs, weights
from perfbench.reference import model as reference
from perfbench.reference import ops
from perfbench.reference.train import train_readings

SIZE = 32


def _config(kind: str) -> dict:
    return {"model": {"kind": kind, "backbone_depth": 50, "num_iter": 3, "num_views": 2 if kind == "stereo" else 3,
                      "image_size": SIZE, "num_feat_vec": 512, "head_hidden": 512, "dtype": "float32"},
            "loss": {"rel_weight": 0.01, "iter_decay": 0.5},
            "weights": {"bn_running_stats": "calibrated"}}


TRAFFIC = {"schedule": {"base_lr": 1e-6, "max_lr": 1e-3, "step_size_up": 1000, "step_size_down": 1000},
           "optimizer": {"betas": [0.9, 0.999], "eps": 1e-8, "weight_decay": 1e-6}}


def test_rotation_seed_and_schedule_match_the_system():
    from rot_mvgaze_tpu_torch.geometry.gaze import rotation_matrix_2d
    from rot_mvgaze_tpu_torch.train import cyclic_triangular2
    from rot_mvgaze_tpu_torch.train.steps import fold_seed

    poses = torch.rand((16, 2), generator=torch.Generator().manual_seed(1)) * 1.6 - 0.8
    torch.testing.assert_close(ops.rotation(poses), rotation_matrix_2d(poses), atol=1e-6, rtol=0)
    assert ops.fold_seed(2**40 + 7, 3) == fold_seed(2**40 + 7, 3)
    ours, theirs = ops.triangular2(1e-6, 1e-3, 1000, 1000), cyclic_triangular2(1e-6, 1e-3, 1000, 1000)
    for count in (0, 1, 2, 999, 1000, 2500, 4100):
        assert ours(count) == pytest.approx(theirs(count), rel=1e-12)


def test_augmentation_matches_the_system_given_the_same_generator():
    from rot_mvgaze_tpu_torch.train.steps import augment_views

    batch = inputs.train_batch(6, SIZE, torch.Generator().manual_seed(2))
    theirs = augment_views(torch.Generator().manual_seed(9), batch, SIZE, torch.float32)
    g = torch.Generator().manual_seed(9)
    ours = [ops.augment(batch["img_0"], g), ops.augment(batch["img_1"], g)]
    torch.testing.assert_close(ours[0], theirs["img_0"], atol=2e-6, rtol=0)
    torch.testing.assert_close(ours[1], theirs["img_1"], atol=2e-6, rtol=0)


@pytest.mark.parametrize("kind", ["stereo", "multiview"])
def test_eval_forward_matches_the_system(kind):
    from rot_mvgaze_tpu_torch.augment.ops import eval_preprocess
    from rot_mvgaze_tpu_torch.geometry.gaze import rotation_matrix_2d
    from rot_mvgaze_tpu_torch.models import FeatRotationMultiView, FeatRotationSymm

    cfg = _config(kind)
    state = weights.make_state(cfg, 3, torch.device("cpu"))
    port = (FeatRotationSymm if kind == "stereo" else FeatRotationMultiView)(50, 3)
    port.load_state_dict(state)
    port.eval()
    net = reference.build_on(cfg, torch.device("cpu"), state).eval()
    views = cfg["model"]["num_views"]
    fr = inputs.frames(4, views, SIZE, torch.Generator().manual_seed(4))
    with torch.no_grad():
        x = eval_preprocess(fr["imgs"].reshape(-1, SIZE, SIZE, 3), SIZE).reshape(fr["imgs"].shape)
        rots = rotation_matrix_2d(fr["head_poses"])
        if kind == "stereo":
            theirs = port({"img_0": x[:, 0], "img_1": x[:, 1], "rot_0": rots[:, 0], "rot_1": rots[:, 1]})
            ours = net(ops.eval_images(fr["imgs"][:, 0]), ops.eval_images(fr["imgs"][:, 1]),
                       ops.rotation(fr["head_poses"][:, 0]), ops.rotation(fr["head_poses"][:, 1]))[-1][0]
        else:
            theirs = port({"imgs": x, "rots": rots})
            ours = net(ops.eval_images(fr["imgs"]), ops.rotation(fr["head_poses"]))
    torch.testing.assert_close(ours, theirs["pred_gaze"], atol=1e-4, rtol=1e-3)


def test_first_train_steps_match_the_system_in_float32():
    """Two float32 steps of the system's step against the reference's:
    the losses within 1e-4, the first step's answers within 1e-3 degrees,
    the median leaf's gradient within 2% and every leaf's change within 5%
    (float32 round-off in BatchNorm's backward at 32x32)."""
    from perfbench import compare
    from rot_mvgaze_tpu_torch.train import cyclic_triangular2, make_optimizer
    from rot_mvgaze_tpu_torch.utils.drivers import Workload

    cfg = _config("stereo")
    state = weights.make_state(cfg, 5, torch.device("cpu"))
    workload = Workload(num_views=2, backbone_depth=50, num_iter=3, dtype=torch.float32)
    workload.model.load_state_dict(state)
    start = {n: p.detach().clone() for n, p in workload.model.named_parameters()}
    opt = make_optimizer(workload.model.parameters())
    step = workload.make_train_step(opt, image_size=SIZE, fold_key_by_step=True,
                                    schedule=cyclic_triangular2(1e-6, 1e-3, 1000, 1000))
    batches = [inputs.train_batch(8, SIZE, torch.Generator().manual_seed(s)) for s in (6, 7)]
    generator = torch.Generator().manual_seed(123)
    names = {p: n for n, p in workload.model.named_parameters()}
    losses = []
    for t, batch in enumerate(batches):
        stats = step(batch, generator, step=t)
        losses.append(float(stats["loss_gaze"]))
        if t == 0:
            pred_first = stats["pred_gaze"].float().numpy()
            grads = {names[p]: float((s["exp_avg"] / 0.1).norm()) for p, s in opt.state.items()}
    change = {n: float((p.detach() - start[n]).norm()) for n, p in workload.model.named_parameters() if n in grads}
    program = {"loss": losses, "grad_norm": grads, "change_norm": change, "pred_first": pred_first}
    ref = train_readings(cfg, TRAFFIC, weights.make_state(cfg, 5, torch.device("cpu")), batches, 123)
    numbers = compare.train_numbers(program, ref)
    assert numbers["loss_gap"] < 1e-4
    assert numbers["pred_gap_mean_deg"] < 1e-3
    assert numbers["grad_gap_median"] < 0.02
    assert numbers["change_gap"] < 0.05
    assert np.isfinite(list(numbers.values())).all()
