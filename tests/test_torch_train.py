"""The port's training slice (rot_mvgaze_tpu_torch.train and the train
forward of models.FeatRotationSymm) against the JAX package on the CPU, with
the same variables (state_dict_from_jax) and the same numpy batches. JAX
runs its Pallas BatchNorm and fusion kernels in interpret mode
(``use_pallas_bn=True, use_pallas_fusion=True``), or for the step's options
its plain path, the kernels' own reference; the port runs their plain
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
from rot_mvgaze_tpu_torch.train import cyclic_triangular2, init_ema, make_optimizer, make_train_step

CFG = {"backbone_depth": 18, "num_iter": 2}
PALLAS = {"use_pallas_bn": True, "use_pallas_fusion": True}
PAIRS, SIZE = 4, 64


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test processes at once; two intra-op threads
    each keep torch from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


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
    port_stats = [step(tbatch, step=i) for i in range(3)]
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


# options of the JAX Trainer's step, each against JAX's 3-step trajectory;
# with_images rides with grad_accum, whose previews then come from
# micro-batch 0 (rows 0::2), and with ema (the whole batch). The Pallas path
# in JAX, as in the trajectories fixture: on this batch its float32
# gradients lie nearer a float64 step's than the plain path's do.
OPTIONS = {
    "grad_accum": {"grad_accum": 2, "with_images": True},
    "ema": {"ema_decay": 0.9, "with_images": True},
    "freeze_bn": {"freeze_bn": True},
}


@pytest.fixture(scope="module")
def warm_variables(variables):
    """The variables with BatchNorm running statistics from one train-mode
    forward on another batch: the warm start freeze_bn is meant for. From the
    initial statistics (mean 0, var 1) one layer2.0.bn1 pre-activation of this
    batch is 7.7e-8, and float32 rounding flips its ReLU mask in the port's
    eval forward, not in JAX's: the port's float32 gradient then lies 0.66%
    from a float64 step's (JAX's 1.8e-6), and after 3 updates parameters
    differ by 8.4e-5. Such flips hit either package by chance (JAX's plain
    train-mode gradient on this batch lies 2.4e-3 from float64)."""
    data = jax.tree.map(jnp.asarray, _model_data(_batch(seed=3)))
    _, updates = JaxFeatRotationSymm(**CFG).apply(variables, data, train=True, mutable=["batch_stats"])
    return {"params": variables["params"], "batch_stats": jax.tree.map(np.asarray, updates["batch_stats"])}


@pytest.fixture(scope="module", params=list(OPTIONS))
def option_run(request, warm_variables):
    """3 updates of both train steps with one option set, augment=False, on
    the batch and JAX path of the trajectories fixture."""
    opts = OPTIONS[request.param]
    variables = warm_variables
    batch = _batch(seed=1)
    jax_metrics = JaxIterationLoss(JaxStereoL1Loss(rel_weight=0.01, reference_decay=1.0), iter_decay=0.5)
    jax_schedule = jax_cyclic_triangular2(**SCHEDULE)
    tx = jax_make_optimizer(jax_schedule)
    jax_step = jax.jit(jax_make_train_step(
        JaxFeatRotationSymm(**CFG, **PALLAS), jax_metrics, tx, image_size=SIZE, schedule=jax_schedule,
        augment=False, **opts,
    ))
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = TrainState(
        step=jnp.asarray(0), params=params,
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]), opt_state=tx.init(params),
        ema_params=jax.tree.map(jnp.copy, params) if "ema_decay" in opts else None,
    )
    jbatch = jax.tree.map(jnp.asarray, batch)
    jax_stats = []
    for _ in range(3):
        state, stats = jax_step(state, jbatch, jax.random.PRNGKey(0))
        jax_stats.append(jax.tree.map(np.asarray, stats))

    model = _port_model(variables)
    ema = init_ema(model) if "ema_decay" in opts else None
    metrics = IterationLoss(StereoL1Loss(rel_weight=0.01, reference_decay=1.0), iter_decay=0.5)
    step = make_train_step(
        model, metrics, make_optimizer(model.parameters()), image_size=SIZE,
        schedule=cyclic_triangular2(**SCHEDULE), augment=False, ema=ema, **opts,
    )
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    port_stats = [step(tbatch, step=i) for i in range(3)]
    final = jax.tree.map(np.asarray, {"params": state.params, "batch_stats": state.batch_stats})
    jax_ema = None if state.ema_params is None else jax.tree.map(np.asarray, state.ema_params)
    return request.param, batch, jax_stats, port_stats, model, ema, final, jax_ema


def test_option_trajectory_stats_match_jax(option_run):
    """Loss and error at rtol 1e-4 each step; previews (with_images) equal
    JAX's rows exactly."""
    name, batch, jax_stats, port_stats, _, _, _, _ = option_run
    for i, (want, got) in enumerate(zip(jax_stats, port_stats)):
        np.testing.assert_allclose(float(got["loss_gaze"]), want["loss_gaze"], rtol=1e-4,
                                   err_msg=f"{name} step {i}")
        np.testing.assert_allclose(float(got["error_gaze"]), want["error_gaze"], rtol=1e-4,
                                   err_msg=f"{name} step {i}")
        np.testing.assert_allclose(got["lr"], want["lr"], rtol=1e-6)
        assert got["pred_gaze"].shape == (PAIRS, 2)
        if OPTIONS[name].get("with_images"):
            rows = slice(0, None, 2) if name == "grad_accum" else slice(None)
            for view in ("img_0", "img_1"):
                assert got[view].dtype == torch.float32
                np.testing.assert_array_equal(got[view].numpy(), want[view])
                np.testing.assert_array_equal(got[view].numpy(), batch[view][rows][:8])
        else:
            assert "img_0" not in got


def test_option_trajectory_state_matches_jax(option_run, warm_variables):
    """Parameters after 3 updates at the bar of test_trajectory_parameters_
    match_jax (2e-5), running statistics at 1e-4; the EMA tree at 2e-5;
    under freeze_bn the running statistics (and num_batches_tracked) are
    the initial ones bit for bit, as JAX's are."""
    name, _, _, _, model, ema, final, jax_ema = option_run
    variables = warm_variables
    worst = _assert_state_close(model, final, atol=2e-5, keys=("weight", "bias"))
    print(f"{name}: max |parameter difference| after 3 updates {worst:.3e}")
    _assert_state_close(model, final, atol=1e-4, keys=("running_mean", "running_var"))
    initial = state_dict_from_jax(variables, **CFG)
    if name == "ema":
        want = state_dict_from_jax({"params": jax_ema, "batch_stats": variables["batch_stats"]}, **CFG)
        for key, value in ema.items():
            np.testing.assert_allclose(value.numpy(), want[key].numpy(), atol=2e-5, err_msg=key)
        params = dict(model.named_parameters())
        key = "_gaze_estimators.1.blocks.1.0.weight"
        assert not torch.equal(ema[key], params[key]) and not torch.equal(ema[key], initial[key])
    if name == "freeze_bn":
        for key, value in model.state_dict().items():
            if "running_" in key or "num_batches_tracked" in key:
                assert torch.equal(value, initial[key]), key
        np.testing.assert_array_equal(
            final["batch_stats"]["backbone"]["bn1"]["mean"], variables["batch_stats"]["backbone"]["bn1"]["mean"]
        )
    key = "_feat_extractor.0.bn1.weight"  # BN's affine parameters learn, frozen or not
    assert float((model.state_dict()[key] - initial[key]).abs().max()) > 0


def test_fold_key_by_step_draws_depend_on_seed_and_step_only():
    """Under fold_key_by_step the augmentation draws are a function of the
    generator's seed and the update count: the same step from another state
    of the generator draws the same, another step draws otherwise, and the
    caller's generator does not advance."""
    from rot_mvgaze_tpu_torch.train.steps import augment_views, fold_seed

    torch.manual_seed(0)
    model = FeatRotationSymm(backbone_depth=18, num_iter=1)
    seen = []

    def metrics(out):
        seen.append(out["img_0"].detach().clone())
        return out["pred_gaze"].float().sum() * 0.0

    step = make_train_step(model, metrics, make_optimizer(model.parameters()), image_size=SIZE,
                           fold_key_by_step=True)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    batch["img_0"] = torch.from_numpy(rng.integers(0, 256, (PAIRS, SIZE, SIZE, 3), dtype=np.uint8))
    batch["img_1"] = torch.from_numpy(rng.integers(0, 256, (PAIRS, SIZE, SIZE, 3), dtype=np.uint8))
    gen = torch.Generator().manual_seed(11)
    state = gen.get_state()
    for s in (4, 5, 4):
        step(batch, gen, step=s)
    assert torch.equal(gen.get_state(), state)
    other = torch.Generator().manual_seed(11)
    torch.rand(5, generator=other)  # another state, the same seed
    step(batch, other, step=4)
    assert torch.equal(seen[0], seen[2]) and torch.equal(seen[0], seen[3])
    assert not torch.equal(seen[0], seen[1])
    want = augment_views(torch.Generator().manual_seed(fold_seed(11, 4)), batch, SIZE)["img_0"]
    assert torch.equal(seen[0], want)
    assert fold_seed(11, 4) != fold_seed(12, 4) != fold_seed(11, 5)


def test_step_options_are_validated():
    model = FeatRotationSymm(backbone_depth=18, num_iter=1)
    opt = make_optimizer(model.parameters())
    with pytest.raises(ValueError, match="EMA dict"):
        make_train_step(model, lambda out: 0.0, opt, ema_decay=0.9)
    with pytest.raises(ValueError, match="ema_decay"):
        make_train_step(model, lambda out: 0.0, opt, ema_decay=1.0, ema=init_ema(model))
    with pytest.raises(ValueError, match="grad_accum"):
        make_train_step(model, lambda out: 0.0, opt, grad_accum=0)
    step = make_train_step(model, lambda out: 0.0, opt, grad_accum=3, augment=False)
    with pytest.raises(ValueError, match="micro-batches"):
        step({k: torch.from_numpy(v) for k, v in _batch().items()}, step=0)


def test_augmenting_step_needs_a_generator():
    model = FeatRotationSymm(backbone_depth=18, num_iter=1)
    step = make_train_step(model, lambda out: 0.0, make_optimizer(model.parameters()))
    with pytest.raises(ValueError, match="Generator"):
        step({k: torch.from_numpy(v) for k, v in _batch().items()}, step=0)
