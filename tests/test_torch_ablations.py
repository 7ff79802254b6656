"""The stereo model's ablations and --fuse_views in the port
(rot_mvgaze_tpu_torch.models.rot_mv, models.norm.IntensityBatchNorm)
against the JAX package on the CPU: the same variables (converted by
state_dict_from_jax and loaded strictly) and the same seeded numpy inputs
through both, R18 with 2 iterations. JAX runs these paths on XLA alone (its
fuser kernel covers only the default path, and its BN here is XLA's, the
Pallas BN's own reference); the port runs the plain twins of its kernels.

Bars: outputs atol 2e-4 / rtol 1e-3 (tests/test_model_parity.py:120);
IntensityBatchNorm's running buffer after a train forward rtol 1e-6, the
backbone's running statistics atol 1e-4 (tests/test_torch_train.py);
gradients atol 5e-4 / rtol 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rot_mvgaze_tpu.compat import flax_to_torch_state_dict
from rot_mvgaze_tpu.geometry import rotation_matrix_2d as jax_rotation_matrix_2d
from rot_mvgaze_tpu.losses import IterationLoss as JaxIterationLoss
from rot_mvgaze_tpu.losses import StereoL1Loss as JaxStereoL1Loss
from rot_mvgaze_tpu.models import FeatRotationSymm as JaxFeatRotationSymm
from rot_mvgaze_tpu.models.rot_mv import IntensityBatchNorm as JaxIntensityBatchNorm
from rot_mvgaze_tpu_torch.compat import state_dict_from_jax
from rot_mvgaze_tpu_torch.losses import IterationLoss, StereoL1Loss
from rot_mvgaze_tpu_torch.models import FeatRotationSymm, IntensityBatchNorm

PAIRS, SIZE = 4, 64
BASE = {"backbone_depth": 18, "num_iter": 2}
# every ablation and every combination the model allows
CONFIGS = {
    "ignore_rotmat": {"ignore_rotmat": True},
    "encode_rotmat": {"encode_rotmat": True},
    "share_feature": {"share_feature": True},
    "share_feature_ignore_rotmat": {"share_feature": True, "ignore_rotmat": True},
    "ignore_rotmat_share_weights": {"ignore_rotmat": True, "share_weights": True},
    "encode_rotmat_share_weights": {"encode_rotmat": True, "share_weights": True},
}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _data(seed=0):
    rng = np.random.default_rng(seed)
    hp = rng.uniform(-0.6, 0.6, (2, PAIRS, 2)).astype(np.float32)
    return {
        "img_0": rng.normal(size=(PAIRS, SIZE, SIZE, 3)).astype(np.float32),
        "img_1": rng.normal(size=(PAIRS, SIZE, SIZE, 3)).astype(np.float32),
        "rot_0": np.array(jax_rotation_matrix_2d(jnp.asarray(hp[0]))),
        "rot_1": np.array(jax_rotation_matrix_2d(jnp.asarray(hp[1]))),
        "gt_gaze": rng.uniform(-0.5, 0.5, (PAIRS, 2)).astype(np.float32),
        "gt_gaze_1": rng.uniform(-0.5, 0.5, (PAIRS, 2)).astype(np.float32),
    }


def _variables(cfg, seed=0):
    """JAX variables as numpy, with BN running statistics and the
    IntensityBatchNorm buffers moved off their initial values, so that eval
    normalisation is exercised."""
    variables = JaxFeatRotationSymm(**cfg).init(jax.random.PRNGKey(seed), jax.tree.map(jnp.asarray, _data()))
    variables = jax.tree.map(np.asarray, variables)
    rng = np.random.default_rng(seed + 1)

    def perturb(path, leaf):
        name = path[-1].key
        if name == "mean":
            return rng.normal(0.0, 0.1, leaf.shape).astype(np.float32)
        if name in ("var", "running_mean"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return leaf

    variables["batch_stats"] = jax.tree_util.tree_map_with_path(perturb, variables["batch_stats"])
    return variables


def _port(cfg, variables):
    model = FeatRotationSymm(**cfg)
    model.load_state_dict(state_dict_from_jax(variables, **{k: v for k, v in cfg.items()
                                                            if k != "fuse_views"}), strict=True)
    return model


def _torch(data):
    return {k: torch.from_numpy(np.array(v)) for k, v in data.items()}


def _assert_outputs_close(got, want, num_iter):
    for i in range(num_iter):
        for key in ("feat_0", "feat_1", "pred_gaze_0", "pred_gaze_1"):
            np.testing.assert_allclose(
                got[f"iter_{i}"][key].detach().numpy(), np.asarray(want[f"iter_{i}"][key]),
                atol=2e-4, rtol=1e-3, err_msg=f"iter_{i}.{key}",
            )
    np.testing.assert_allclose(got["pred_gaze"].detach().numpy(), np.asarray(want["pred_gaze"]),
                               atol=2e-4, rtol=1e-3)


@pytest.fixture(scope="module", params=list(CONFIGS))
def ablation(request):
    cfg = {**BASE, **CONFIGS[request.param]}
    return request.param, cfg, _variables(cfg)


def test_eval_forward_matches_jax(ablation):
    _, cfg, variables = ablation
    data = _data(seed=2)
    want = JaxFeatRotationSymm(**cfg).apply(variables, jax.tree.map(jnp.asarray, data))
    with torch.inference_mode():
        got = _port(cfg, variables).eval()(_torch(data))
    _assert_outputs_close(got, want, cfg["num_iter"])


def _jax_loss():
    return JaxIterationLoss(JaxStereoL1Loss(rel_weight=0.01, reference_decay=1.0), iter_decay=0.5)


def _port_loss():
    return IterationLoss(StereoL1Loss(rel_weight=0.01, reference_decay=1.0), iter_decay=0.5)


def _train_both(cfg, variables, data):
    """One train-mode forward and backward of the iteration loss in both
    packages: (port output, port model after backward, JAX output, JAX
    updated batch_stats, JAX gradients as a port state dict)."""
    model = JaxFeatRotationSymm(**cfg)
    jdata = jax.tree.map(jnp.asarray, data)

    def loss_fn(params):
        out, updates = model.apply({"params": params, "batch_stats": variables["batch_stats"]}, jdata,
                                   train=True, mutable=["batch_stats"])
        return _jax_loss()(out), (out, updates["batch_stats"])

    (_, (want, stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, variables["params"]))
    conv_cfg = {k: v for k, v in cfg.items() if k != "fuse_views"}
    jax_grads = state_dict_from_jax(
        {"params": jax.tree.map(np.asarray, grads), "batch_stats": variables["batch_stats"]}, **conv_cfg)
    port = _port(cfg, variables).train()
    got = port(_torch(data))
    _port_loss()(got).backward()
    return got, port, want, jax.tree.map(np.asarray, stats), jax_grads


def _assert_running_close(port, cfg, variables, stats):
    want = state_dict_from_jax({"params": variables["params"], "batch_stats": stats},
                               **{k: v for k, v in cfg.items() if k != "fuse_views"})
    got = port.state_dict()
    n_intensity = 0
    for key, value in want.items():
        if "_batchnorm.running_mean" in key:
            n_intensity += 1
            np.testing.assert_allclose(got[key].numpy(), value.numpy(), rtol=1e-6, atol=0, err_msg=key)
        elif key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[key].numpy(), value.numpy(), atol=1e-4, rtol=0, err_msg=key)
    return n_intensity


def test_train_forward_and_gradients_match_jax(ablation):
    """Outputs, the running statistics after the forward (the intensity
    buffers at rtol 1e-6), and every parameter's gradient."""
    name, cfg, variables = ablation
    got, port, want, stats, jax_grads = _train_both(cfg, variables, _data(seed=3))
    _assert_outputs_close(got, want, cfg["num_iter"])
    n_intensity = _assert_running_close(port, cfg, variables, stats)
    assert n_intensity == (cfg["num_iter"] if cfg.get("share_feature") else 0)
    if cfg.get("share_feature"):  # moved by two train calls per fuser
        init = state_dict_from_jax(variables, **cfg)["_img_fusers.0._batchnorm.running_mean"]
        assert not torch.equal(port._img_fusers[0]._batchnorm.running_mean, init)
    n = 0
    for key, p in port.named_parameters():
        if p.grad is None:
            assert key.startswith("_feat_extractor.0.fc."), key
            continue
        n += 1
        np.testing.assert_allclose(p.grad.numpy(), jax_grads[key].numpy(), atol=5e-4, rtol=1e-3,
                                   err_msg=f"{name}: d{key}")
    assert n > 60


def _f64_grads(cfg, variables, data, monkeypatch):
    """The port's gradients of the same forward and backward in float64,
    through the kernels' plain versions (their wrappers take float32 and
    bfloat16 only)."""
    from rot_mvgaze_tpu_torch.ops import batchnorm, fusion

    with monkeypatch.context() as m:
        for name in ("bn_stats", "bn_apply", "bn_bwd_reduce", "bn_bwd_dx"):
            m.setattr(batchnorm, name, getattr(batchnorm, f"{name}_reference"))
        m.setattr(fusion, "rotate_concat_matmul_relu", fusion.rotate_concat_matmul_relu_reference)
        model = _port(cfg, variables).double().train()
        _port_loss()(model({k: v.double() for k, v in _torch(data).items()})).backward()
    return {k: p.grad for k, p in model.named_parameters() if p.grad is not None}


def test_fuse_views_train_forward_matches_jax(monkeypatch):
    """--fuse_views: both views in one backbone batch in train mode; outputs
    and the merged running statistics (each BN updated once) against JAX.
    Gradients: outside the backbone within atol 5e-4 / rtol 1e-3 of JAX's.
    In the backbone, BN over 8 random-init images amplifies float32
    rounding (both packages form the variance as E[x²] - E[x]²), and the
    stem convolution's gradient is outside that elementwise bar. There each
    leaf is held within 1% (norm-relative) of JAX's gradient and of the
    port's float64 step; the worst leaf reads 0.92% against JAX, 0.89%
    against float64, and JAX's own lies 0.59% from float64."""
    cfg = {**BASE, "fuse_views": True}
    variables = _variables(BASE, seed=4)
    data = _data(seed=5)
    got, port, want, stats, jax_grads = _train_both(cfg, variables, data)
    _assert_outputs_close(got, want, cfg["num_iter"])
    _assert_running_close(port, cfg, variables, stats)
    assert int(port._feat_extractor[0].layer1[0].bn2.num_batches_tracked) == 1
    g64 = _f64_grads(cfg, variables, data, monkeypatch)
    errs = {}
    for key, p in port.named_parameters():
        if p.grad is None:
            continue
        if not key.startswith("_feat_extractor."):
            np.testing.assert_allclose(p.grad.numpy(), jax_grads[key].numpy(), atol=5e-4, rtol=1e-3,
                                       err_msg=f"d{key}")
            continue
        ref = g64[key]
        errs[key] = (float((p.grad.double() - ref).norm() / ref.norm()),
                     float((jax_grads[key].double() - ref).norm() / ref.norm()),
                     float((p.grad.double() - jax_grads[key].double()).norm() / jax_grads[key].double().norm()))
    worst = max(errs, key=lambda k: errs[k][0])
    wj = max(errs, key=lambda k: errs[k][2])
    print(f"fuse_views backbone gradients, norm-relative error against f64: port max "
          f"{errs[worst][0]:.3e} ({worst}; JAX {errs[worst][1]:.3e}), JAX max "
          f"{max(e[1] for e in errs.values()):.3e}; port against JAX max {errs[wj][2]:.3e} ({wj})")
    assert errs[worst][0] <= 1e-2, (worst, errs[worst])
    assert errs[wj][2] <= 1e-2, (wj, errs[wj])
    # unfused, the same model updates each statistic twice and normalises per view
    unfused = _port(BASE, variables).train()
    other = unfused(_torch(data))
    assert int(unfused._feat_extractor[0].layer1[0].bn2.num_batches_tracked) == 2
    assert not torch.allclose(other["img_feat_0"], got["img_feat_0"])


@pytest.mark.parametrize("name", ["default", "fuse_views", *CONFIGS])
def test_state_dict_from_jax_equals_jax_converter(name):
    """Key for key and value for value JAX's own exporter with
    strict_compatible=True, and a strict load into the port's model."""
    flags = {} if name in ("default", "fuse_views") else CONFIGS[name]
    cfg = {**BASE, **flags}
    variables = _variables(cfg)
    got = state_dict_from_jax(variables, **cfg)
    want = flax_to_torch_state_dict(variables, strict_compatible=True, **cfg)
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key].numpy(), value, err_msg=key)
    model = FeatRotationSymm(**cfg, fuse_views=name == "fuse_views")
    assert set(model.state_dict()) == set(got)
    model.load_state_dict(got, strict=True)


REJECTED = {
    "ignore_rotmat_encode_rotmat": {"ignore_rotmat": True, "encode_rotmat": True},
    "share_feature_encode_rotmat": {"share_feature": True, "encode_rotmat": True},
    "share_feature_share_weights": {"share_feature": True, "share_weights": True},
}


@pytest.mark.parametrize("name", sorted(REJECTED))
def test_rejected_combinations_raise_as_in_jax(name):
    flags = REJECTED[name]
    with pytest.raises((AssertionError, ValueError)):
        JaxFeatRotationSymm(backbone_depth=18, num_iter=1, **flags).init(
            jax.random.PRNGKey(0), jax.tree.map(jnp.asarray, _data()))
    with pytest.raises(ValueError, match="cannot be combined"):
        FeatRotationSymm(backbone_depth=18, num_iter=1, **flags)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_intensity_batchnorm_matches_jax(train):
    """Output at 1e-6 relative; in train mode the updated buffer at rtol
    1e-6, including the floor at eps (one channel with equal intensities)."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(8, 3, 16)).astype(np.float32) * rng.uniform(0.5, 3.0, (1, 1, 16)).astype(np.float32)
    x[:, :, 0] = x[0, :, 0]  # every row the same vector: variance 0, floored
    running = rng.uniform(0.5, 1.5, (1, 1, 16)).astype(np.float32)
    jbn = JaxIntensityBatchNorm(16)
    want, updates = jbn.apply({"batch_stats": {"running_mean": jnp.asarray(running)}}, jnp.asarray(x),
                              train, mutable=["batch_stats"])
    bn = IntensityBatchNorm(16).train(train)
    bn.running_mean.copy_(torch.from_numpy(running))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = bn(xt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(updates["batch_stats"]["running_mean"]),
                               rtol=1e-6, atol=0)
    assert np.array_equal(bn.running_mean.numpy(), running) == (not train)
    # no gradient through the statistic: d(sum y)/dx is 1 / (running + eps)
    got.sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.broadcast_to(1.0 / (bn.running_mean.numpy() + 1e-4),
                                                                x.shape), rtol=1e-6)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_msgpack_checkpoints_load_strictly(name, tmp_path):
    """A JAX .msgpack of each ablation's variables (written by the JAX
    package) loads strictly through load_checkpoint with the model's flags,
    equal to state_dict_from_jax's conversion; model_config reads the flags
    back off the model."""
    from rot_mvgaze_tpu.train.checkpoints import save_state as jax_save_state
    from rot_mvgaze_tpu_torch.compat import load_checkpoint, model_config

    cfg = {**BASE, **CONFIGS[name]}
    variables = _variables(cfg)
    path = jax_save_state(str(tmp_path / "vars.msgpack"), variables)
    model = FeatRotationSymm(**cfg)
    assert {k: v for k, v in model_config(model).items() if v} == {k: v for k, v in cfg.items() if v}
    got = load_checkpoint(path, **model_config(model))
    model.load_state_dict(got, strict=True)
    want = state_dict_from_jax(variables, **cfg)
    assert set(got) == set(want)
    for key, value in want.items():
        assert torch.equal(got[key], value), key


def test_intensity_buffer_is_state_not_a_parameter():
    """IntensityBatchNorm's buffer is state, as in JAX's batch_stats: the
    train step moves it, freeze_bn leaves it bit for bit, the EMA does not
    hold it, and the state dict (so a checkpoint) carries it."""
    from rot_mvgaze_tpu_torch.train import init_ema, make_optimizer, make_train_step

    cfg = {**BASE, "share_feature": True}
    data = _data(seed=7)
    batch = {"img_0": data["img_0"], "img_1": data["img_1"], "gt_gaze": data["gt_gaze"],
             "gt_gaze_1": data["gt_gaze_1"]}
    rng = np.random.default_rng(8)
    batch.update(head_pose_0=rng.uniform(-0.5, 0.5, (PAIRS, 2)).astype(np.float32),
                 head_pose_1=rng.uniform(-0.5, 0.5, (PAIRS, 2)).astype(np.float32))
    key = "_img_fusers.1._batchnorm.running_mean"
    for freeze_bn in (False, True):
        model = _port(cfg, _variables(cfg))
        before = model.state_dict()[key].clone()
        ema = init_ema(model)
        assert key not in ema and key in model.state_dict()
        step = make_train_step(model, _port_loss(), make_optimizer(model.parameters()), image_size=SIZE,
                               augment=False, freeze_bn=freeze_bn, ema_decay=0.5, ema=ema)
        step(_torch(batch), step=0)
        assert torch.equal(model.state_dict()[key], before) == freeze_bn
