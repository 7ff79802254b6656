"""The port's training slice (rot_mvgaze_tpu_torch.train and the train
forward of models.FeatRotationSymm) against the JAX package on the CPU, with
the same variables (state_dict_from_jax) and the same numpy batches. JAX
runs its Pallas BatchNorm and fusion kernels in interpret mode
(``use_pallas_bn=True, use_pallas_fusion=True``); the port runs their plain
versions. Everything is float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rot_mvgaze_tpu.geometry import rotation_matrix_2d as jax_rotation_matrix_2d
from rot_mvgaze_tpu.losses import IterationLoss as JaxIterationLoss
from rot_mvgaze_tpu.losses import StereoL1Loss as JaxStereoL1Loss
from rot_mvgaze_tpu.models import FeatRotationSymm as JaxFeatRotationSymm
from rot_mvgaze_tpu.train.schedule import cyclic_triangular2 as jax_cyclic_triangular2
from rot_mvgaze_tpu.train.steps import make_train_step as jax_make_train_step
from rot_mvgaze_tpu.train.trainer import TrainState
from rot_mvgaze_tpu.train.trainer import make_optimizer as jax_make_optimizer
from rot_mvgaze_tpu_torch.compat import state_dict_from_jax
from rot_mvgaze_tpu_torch.losses import IterationLoss, StereoL1Loss
from rot_mvgaze_tpu_torch.models import FeatRotationSymm
from rot_mvgaze_tpu_torch.train import cyclic_triangular2, make_optimizer, make_train_step

CFG = {"backbone_depth": 18, "num_iter": 2}
PALLAS = {"use_pallas_bn": True, "use_pallas_fusion": True}
PAIRS, SIZE = 4, 64


def _batch(seed=0):
    """Pre-augmented float views (augment=False) plus poses and labels."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return {
        "img_0": rng.normal(size=(PAIRS, SIZE, SIZE, 3)).astype(f32),
        "img_1": rng.normal(size=(PAIRS, SIZE, SIZE, 3)).astype(f32),
        "head_pose_0": rng.uniform(-0.5, 0.5, (PAIRS, 2)).astype(f32),
        "head_pose_1": rng.uniform(-0.5, 0.5, (PAIRS, 2)).astype(f32),
        "gt_gaze": rng.uniform(-0.5, 0.5, (PAIRS, 2)).astype(f32),
        "gt_gaze_1": rng.uniform(-0.5, 0.5, (PAIRS, 2)).astype(f32),
    }


def _model_data(batch):
    return {
        "img_0": batch["img_0"],
        "img_1": batch["img_1"],
        "rot_0": np.asarray(jax_rotation_matrix_2d(jnp.asarray(batch["head_pose_0"]))),
        "rot_1": np.asarray(jax_rotation_matrix_2d(jnp.asarray(batch["head_pose_1"]))),
    }


@pytest.fixture(scope="module")
def variables():
    data = _model_data(_batch())
    model = JaxFeatRotationSymm(**CFG)
    return jax.tree.map(
        np.asarray, model.init(jax.random.PRNGKey(0), jax.tree.map(jnp.asarray, data))
    )


def _port_model(variables):
    model = FeatRotationSymm(**CFG)
    model.load_state_dict(state_dict_from_jax(variables, **CFG), strict=True)
    return model.train()


def _assert_state_close(model, jax_variables, atol, rtol=0.0, keys=None):
    """Port state against JAX variables converted by state_dict_from_jax;
    returns the largest |difference|."""
    want = state_dict_from_jax(jax_variables, **CFG)
    got = model.state_dict()
    worst = 0.0
    for key, value in want.items():
        if "num_batches_tracked" in key or key.endswith("fc.weight") or key.endswith("fc.bias"):
            continue
        if keys is not None and not any(k in key for k in keys):
            continue
        diff = (got[key].double() - value.double()).abs()
        worst = max(worst, float(diff.max()))
        np.testing.assert_allclose(
            got[key].numpy(), value.numpy(), atol=atol, rtol=rtol, err_msg=key
        )
    return worst


def test_train_forward_matches_jax(variables):
    """Outputs at atol 2e-4 / rtol 1e-3; the running statistics after the
    forward (each BN called once per view) at 1e-4."""
    data = _model_data(_batch())
    want, updates = JaxFeatRotationSymm(**CFG, **PALLAS).apply(
        variables, jax.tree.map(jnp.asarray, data), train=True, mutable=["batch_stats"]
    )
    model = _port_model(variables)
    got = model({k: torch.from_numpy(np.array(v)) for k, v in data.items()})
    for key in ("img_feat_0", "img_feat_1", "initial_rot_feat_0", "initial_rot_feat_1", "pred_gaze"):
        np.testing.assert_allclose(
            got[key].detach().numpy(), np.asarray(want[key]), atol=2e-4, rtol=1e-3, err_msg=key
        )
    for i in range(CFG["num_iter"]):
        for key in ("feat_0", "feat_1", "pred_gaze_0", "pred_gaze_1"):
            np.testing.assert_allclose(
                got[f"iter_{i}"][key].detach().numpy(), np.asarray(want[f"iter_{i}"][key]),
                atol=2e-4, rtol=1e-3, err_msg=f"iter_{i}.{key}",
            )
    new_vars = {"params": variables["params"], "batch_stats": jax.tree.map(np.asarray, updates["batch_stats"])}
    _assert_state_close(model, new_vars, atol=1e-4, keys=("running_mean", "running_var"))
    bn = model._feat_extractor[0].layer1[0].bn2
    assert int(bn.num_batches_tracked) == 2  # once per view


# lr of the trajectory's three updates: 1e-6, then 3.4e-5, then 6.7e-5
SCHEDULE = dict(base_lr=1e-6, max_lr=1e-4, step_size_up=3, step_size_down=3)


@pytest.fixture(scope="module")
def trajectories(variables):
    """3 updates of both train steps on the same batch, augment=False."""
    batch = _batch(seed=1)
    jax_metrics = JaxIterationLoss(JaxStereoL1Loss(rel_weight=0.01, reference_decay=1.0), iter_decay=0.5)
    jax_schedule = jax_cyclic_triangular2(**SCHEDULE)
    tx = jax_make_optimizer(jax_schedule)
    jax_step = jax.jit(jax_make_train_step(
        JaxFeatRotationSymm(**CFG, **PALLAS), jax_metrics, tx,
        image_size=SIZE, schedule=jax_schedule, augment=False,
    ))
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = TrainState(
        step=jnp.asarray(0), params=params,
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]), opt_state=tx.init(params),
    )
    jbatch = jax.tree.map(jnp.asarray, batch)
    jax_stats = []
    for _ in range(3):
        state, stats = jax_step(state, jbatch, jax.random.PRNGKey(0))
        jax_stats.append({k: float(v) for k, v in stats.items()})

    model = _port_model(variables)
    metrics = IterationLoss(StereoL1Loss(rel_weight=0.01, reference_decay=1.0), iter_decay=0.5)
    step = make_train_step(
        model, metrics, make_optimizer(model.parameters()), image_size=SIZE,
        schedule=cyclic_triangular2(**SCHEDULE), augment=False,
    )
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    port_stats = [step(tbatch) for _ in range(3)]
    final = jax.tree.map(np.asarray, {"params": state.params, "batch_stats": state.batch_stats})
    return jax_stats, port_stats, model, final


def test_trajectory_losses_match_jax(trajectories):
    jax_stats, port_stats, _, _ = trajectories
    for i, (want, got) in enumerate(zip(jax_stats, port_stats)):
        np.testing.assert_allclose(float(got["loss_gaze"]), want["loss_gaze"], rtol=1e-4, err_msg=f"step {i}")
        np.testing.assert_allclose(float(got["error_gaze"]), want["error_gaze"], rtol=1e-4, err_msg=f"step {i}")
        np.testing.assert_allclose(got["lr"], want["lr"], rtol=1e-6, err_msg=f"step {i}")


def test_trajectory_parameters_match_jax(trajectories, variables):
    """After 3 Adam updates, every parameter within 2e-5 absolute. An Adam
    step moves a parameter by up to about lr whatever its gradient's size,
    so a gradient at float32 noise level could in the worst case differ by
    2 x (sum of the learning rates) = 2.04e-4; measured on the CPU, the
    largest difference is 2.0e-6 (printed), so the bar is 10x that. Running
    statistics (no optimizer) hold to 1e-4."""
    _, _, model, final = trajectories
    worst = _assert_state_close(model, final, atol=2e-5, keys=("weight", "bias"))
    print(f"trajectory: max |parameter difference| after 3 updates {worst:.3e}")
    _assert_state_close(model, final, atol=1e-4, keys=("running_mean", "running_var"))
    initial = state_dict_from_jax(variables, **CFG)
    key = "_gaze_estimators.1.blocks.1.0.weight"
    assert float((model.state_dict()[key] - initial[key]).abs().max()) > 1e-5  # it trained


@pytest.mark.parametrize("steps_per_epoch", [1, 3])
def test_schedule_matches_jax(steps_per_epoch):
    kw = dict(base_lr=1e-6, max_lr=1e-3, step_size_up=4, step_size_down=6, steps_per_epoch=steps_per_epoch)
    port, ref = cyclic_triangular2(**kw), jax_cyclic_triangular2(**kw)
    for count in range(41):
        np.testing.assert_allclose(port(count), float(ref(count)), rtol=1e-6, err_msg=f"count {count}")


@pytest.mark.parametrize(
    "option",
    [{"grad_accum": 2}, {"ema_decay": 0.999}, {"freeze_bn": True}, {"with_images": True},
     {"fold_key_by_step": True}],
    ids=["grad_accum", "ema", "freeze_bn", "with_images", "fold_key_by_step"],
)
def test_unported_step_options_raise(option):
    model = FeatRotationSymm(backbone_depth=18, num_iter=1)
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        make_train_step(model, lambda out: 0.0, make_optimizer(model.parameters()), **option)


def test_augmenting_step_needs_a_generator():
    model = FeatRotationSymm(backbone_depth=18, num_iter=1)
    step = make_train_step(model, lambda out: 0.0, make_optimizer(model.parameters()))
    with pytest.raises(ValueError, match="Generator"):
        step({k: torch.from_numpy(v) for k, v in _batch().items()})
