"""The V-view stack in the port (rot_mvgaze_tpu_torch.models.multiview,
losses.multiview, train.multiview_steps) against the JAX package on the
CPU: the same variables (converted by state_dict_from_jax, which maps the
stereo tree the V-view model shares) and the same seeded numpy inputs
through both, R18 with 2 iterations at 32x32. The port runs the plain twins
of its BN kernels and F.linear fusers.

In eval JAX runs its V-view model as it is. In train mode the port's BN is
the port of the JAX package's Pallas BN kernels, while JAX's V-view model
builds its backbone on XLA's BN: the same math, another float32 rounding,
which Adam's first, nearly sign-like updates amplify to whole learning
rates on near-zero gradients. So, as tests/test_torch_train.py runs the
stereo step with use_pallas_bn=True, the train-mode comparisons here give
JAX's V-view model a backbone whose BN runs the Pallas kernels in
interpret mode (``_jax_pallas_bn``, a test-side swap of the backbone
constructor; the JAX package is unchanged). Against XLA's BN the losses
are checked too.

Bars: outputs atol 2e-4 / rtol 1e-3 (tests/test_model_parity.py:120),
running statistics atol 1e-4, gradients atol 5e-4 / rtol 1e-3, losses 1e-5
/ 1e-4 (tests/test_torch_losses.py), the 2-update trajectory at the
trajectory test's bars (tests/test_torch_train.py: loss and error rtol
1e-4, parameters atol 2e-5, running statistics 1e-4). A train-mode
gradient is held to the port's own step in float64 (norm-relative 1e-2),
with JAX's distance from it printed beside: at random init an activation
within float32 rounding of 0 flips its ReLU mask in one package and not in
the other, and through train-mode BN over B·V images the two packages'
float32 gradients then differ by more than atol 5e-4 / rtol 1e-3 in a few
elements (measured against float64: JAX's up to 0.54%, the port's up to
0.16%, each in other cases).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rot_mvgaze_tpu.models.multiview as jax_multiview

from rot_mvgaze_tpu.geometry import rotation_matrix_2d as jax_rotation_matrix_2d
from rot_mvgaze_tpu.losses import IterationLoss as JaxIterationLoss
from rot_mvgaze_tpu.losses import MultiViewL1Loss as JaxMultiViewL1Loss
from rot_mvgaze_tpu.models.multiview import FeatRotationMultiView as JaxFeatRotationMultiView
from rot_mvgaze_tpu.train.multiview_steps import make_multiview_eval_step as jax_make_multiview_eval_step
from rot_mvgaze_tpu.train.multiview_steps import make_multiview_train_step as jax_make_multiview_train_step
from rot_mvgaze_tpu.train.schedule import cyclic_triangular2 as jax_cyclic_triangular2
from rot_mvgaze_tpu.train.trainer import TrainState
from rot_mvgaze_tpu.train.trainer import make_optimizer as jax_make_optimizer
from rot_mvgaze_tpu_torch.compat import state_dict_from_jax
from rot_mvgaze_tpu_torch.losses import IterationLoss, MultiViewL1Loss, StereoL1Loss
from rot_mvgaze_tpu_torch.models import FeatRotationMultiView, FeatRotationSymm
from rot_mvgaze_tpu_torch.train import (
    cyclic_triangular2,
    init_ema,
    make_multiview_eval_step,
    make_multiview_train_step,
    make_optimizer,
)

B, S = 4, 32
BASE = {"backbone_depth": 18, "num_iter": 2}
FLAGS = {"default": {}, "ignore_rotmat": {"ignore_rotmat": True}, "share_weights": {"share_weights": True}}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _inputs(v, seed=0):
    rng = np.random.default_rng(seed)
    hp = rng.uniform(-0.8, 0.8, (B * v, 2)).astype(np.float32)
    return {
        "imgs": rng.standard_normal((B, v, S, S, 3)).astype(np.float32),
        "rots": np.asarray(jax_rotation_matrix_2d(jnp.asarray(hp))).reshape(B, v, 3, 3),
        "gt_gazes": rng.uniform(-0.5, 0.5, (B, v, 2)).astype(np.float32),
    }


def _variables(cfg, seed=0):
    """JAX V-view variables as numpy, BN running statistics off their
    initial values."""
    data = _inputs(3)
    variables = JaxFeatRotationMultiView(**cfg).init(
        jax.random.PRNGKey(seed), {"imgs": jnp.asarray(data["imgs"]), "rots": jnp.asarray(data["rots"])})
    variables = jax.tree.map(np.asarray, variables)
    rng = np.random.default_rng(seed + 1)

    def perturb(path, leaf):
        if path[-1].key == "mean":
            return rng.normal(0.0, 0.1, leaf.shape).astype(np.float32)
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return leaf

    variables["batch_stats"] = jax.tree_util.tree_map_with_path(perturb, variables["batch_stats"])
    return variables


def _jax_pallas_bn(monkeypatch):
    """JAX's V-view model builds its backbone with use_pallas_bn=True while
    ``monkeypatch`` lasts."""
    backbones = dict(jax_multiview.BACKBONES)
    backbones[18] = functools.partial(backbones[18], use_pallas_bn=True)
    monkeypatch.setattr(jax_multiview, "BACKBONES", backbones)


def _convert(variables, cfg):
    return state_dict_from_jax(variables, **{k: v for k, v in cfg.items() if k != "ignore_rotmat"})


def _port(cfg, variables):
    model = FeatRotationMultiView(**cfg)
    model.load_state_dict(_convert(variables, cfg), strict=True)
    return model


def _torch(data):
    return {k: torch.from_numpy(np.array(v)) for k, v in data.items()}


def _assert_outputs_close(got, want, num_iter):
    for i in range(num_iter):
        for key in ("feats", "pred_gazes"):
            np.testing.assert_allclose(
                got[f"iter_{i}"][key].detach().numpy(), np.asarray(want[f"iter_{i}"][key]),
                atol=2e-4, rtol=1e-3, err_msg=f"iter_{i}.{key}",
            )
    np.testing.assert_allclose(got["pred_gaze"].detach().numpy(), np.asarray(want["pred_gaze"]),
                               atol=2e-4, rtol=1e-3)


CASES = [(v, name) for v in (3, 4) for name in FLAGS]


@pytest.fixture(scope="module", params=CASES, ids=[f"v{v}-{n}" for v, n in CASES])
def case(request):
    v, name = request.param
    cfg = {**BASE, **FLAGS[name]}
    return v, cfg, _variables(cfg)


def test_eval_forward_matches_jax(case):
    v, cfg, variables = case
    data = _inputs(v, seed=2)
    model_in = {"imgs": data["imgs"], "rots": data["rots"]}
    want = JaxFeatRotationMultiView(**cfg).apply(variables, jax.tree.map(jnp.asarray, model_in))
    with torch.inference_mode():
        got = _port(cfg, variables).eval()(_torch(model_in))
    assert got["num_views"] == v and got["pred_gaze"].shape == (B, 2)
    assert got["img_feats"].shape == (B, v, 512) and got["initial_rot_feats"].shape == (B, v, 3, 512)
    np.testing.assert_allclose(got["img_feats"].numpy(), np.asarray(want["img_feats"]), atol=1e-4, rtol=0)
    _assert_outputs_close(got, want, cfg["num_iter"])


def _metrics(port=True):
    if port:
        return IterationLoss(MultiViewL1Loss(rel_weight=0.01, reference_decay=1.0), iter_decay=0.5)
    return JaxIterationLoss(JaxMultiViewL1Loss(rel_weight=0.01, reference_decay=1.0), iter_decay=0.5)


def test_train_forward_and_gradients_match_jax(case, monkeypatch):
    """Train mode (all B·V images in one backbone batch, BN on the Pallas
    kernels in JAX): outputs and the running statistics (each BN updated
    once) against JAX; every parameter's gradient within 1% (norm-relative)
    of JAX's and of the port's float64 step. The worst leaves read 0.54%
    against JAX (JAX's own distance from float64) and 0.16% against
    float64."""
    v, cfg, variables = case
    data = _inputs(v, seed=3)
    _jax_pallas_bn(monkeypatch)
    model = JaxFeatRotationMultiView(**cfg)
    jdata = jax.tree.map(jnp.asarray, data)

    def loss_fn(params):
        out, updates = model.apply({"params": params, "batch_stats": variables["batch_stats"]}, jdata,
                                   train=True, mutable=["batch_stats"])
        return _metrics(False)(out), (out, updates["batch_stats"])

    (_, (want, stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, variables["params"]))
    port = _port(cfg, variables).train()
    got = port(_torch(data))
    _metrics()(got).backward()
    _assert_outputs_close(got, want, cfg["num_iter"])
    new = _convert({"params": variables["params"], "batch_stats": jax.tree.map(np.asarray, stats)}, cfg)
    state = port.state_dict()
    for key, value in new.items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(state[key].numpy(), value.numpy(), atol=1e-4, rtol=0, err_msg=key)
    assert int(port._feat_extractor[0].layer1[0].bn2.num_batches_tracked) == 1
    jax_grads = _convert({"params": jax.tree.map(np.asarray, grads), "batch_stats": variables["batch_stats"]},
                         cfg)
    g64 = _f64_grads(cfg, variables, data, monkeypatch)
    errs = {}
    for key, p in port.named_parameters():
        if p.grad is not None:
            ref = g64[key]
            errs[key] = (float((p.grad.double() - ref).norm() / ref.norm()),
                         float((jax_grads[key].double() - ref).norm() / ref.norm()),
                         float((p.grad.double() - jax_grads[key].double()).norm() / jax_grads[key].double().norm()))
    worst = max(errs, key=lambda k: errs[k][0])
    wj = max(errs, key=lambda k: errs[k][2])
    print(f"V={v} gradients, norm-relative error against f64: port max {errs[worst][0]:.3e} "
          f"({worst}; JAX {errs[worst][1]:.3e}), JAX max {max(e[1] for e in errs.values()):.3e}; "
          f"port against JAX max {errs[wj][2]:.3e} ({wj})")
    assert len(errs) > 60 and errs[worst][0] <= 1e-2, (worst, errs[worst])
    assert errs[wj][2] <= 1e-2, (wj, errs[wj])


def _f64_grads(cfg, variables, data, monkeypatch):
    """The port's gradients of the same train forward and backward in
    float64, through the BN kernels' plain versions (their wrappers take
    float32 and bfloat16 only)."""
    from rot_mvgaze_tpu_torch.ops import batchnorm

    with monkeypatch.context() as m:
        _plain_bn_in_f64(m)
        model = _port(cfg, variables).double().train()
        _metrics()(model({k: v.double() for k, v in _torch(data).items()})).backward()
    return {k: p.grad for k, p in model.named_parameters() if p.grad is not None}


def _plain_bn_in_f64(monkeypatch):
    from rot_mvgaze_tpu_torch.ops import batchnorm

    for name in ("bn_stats", "bn_apply", "bn_bwd_reduce", "bn_bwd_dx"):
        monkeypatch.setattr(batchnorm, name, getattr(batchnorm, f"{name}_reference"))


@pytest.mark.parametrize("name", list(FLAGS))
def test_v2_against_the_port_stereo_model(name):
    """At V=2 the V-view model is the stereo one. Eval: with ignore_rotmat
    both run the same plain products (F.linear fusers on the unrotated
    partner) and agree bit for bit; on the default path the stereo model
    rotates inside its fuser op (the kernel's plain version on the CPU)
    and the V-view model rotates before F.linear, so they agree within 1e-5.
    Train: the V-view model against the stereo model under fuse_views (both
    views in one backbone batch, rows in another order), within 1e-5."""
    flags = FLAGS[name]
    cfg = {**BASE, **flags}
    variables = _variables(cfg)
    data = _inputs(2, seed=4)
    stereo_in = {"img_0": data["imgs"][:, 0], "img_1": data["imgs"][:, 1],
                 "rot_0": data["rots"][:, 0], "rot_1": data["rots"][:, 1]}
    sd = _convert(variables, cfg)
    mv, st = FeatRotationMultiView(**cfg), FeatRotationSymm(**cfg, fuse_views=True)
    mv.load_state_dict(sd, strict=True)
    st.load_state_dict(sd, strict=True)
    for train in (False, True):
        mv.train(train)
        st.train(train)
        with torch.no_grad():
            got = mv(_torch({"imgs": data["imgs"], "rots": data["rots"]}))
            want = st(_torch(stereo_in))
        for i in range(cfg["num_iter"]):
            for v in (0, 1):
                pairs = [(got[f"iter_{i}"]["pred_gazes"][:, v], want[f"iter_{i}"][f"pred_gaze_{v}"]),
                         (got[f"iter_{i}"]["feats"][:, v], want[f"iter_{i}"][f"feat_{v}"])]
                for a, b in pairs:
                    if name == "ignore_rotmat" and not train:
                        assert torch.equal(a, b), (i, v)
                    else:
                        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
    for key, value in mv.state_dict().items():  # the same running statistics
        torch.testing.assert_close(value, st.state_dict()[key], atol=1e-5, rtol=0)


def test_stereo_state_dict_loads_strictly_at_v3():
    """A stereo model's state dict (its running statistics moved by a train
    forward) loads strictly into the V-view model, which predicts finite
    gazes for 3 views."""
    torch.manual_seed(0)
    stereo = FeatRotationSymm(**BASE).train()
    data = _inputs(2, seed=5)
    with torch.no_grad():
        stereo(_torch({"img_0": data["imgs"][:, 0], "img_1": data["imgs"][:, 1],
                       "rot_0": data["rots"][:, 0], "rot_1": data["rots"][:, 1]}))
    mv = FeatRotationMultiView(**BASE)
    assert set(mv.state_dict()) == set(stereo.state_dict())
    mv.load_state_dict(stereo.state_dict(), strict=True)
    data = _inputs(3, seed=6)
    with torch.inference_mode():
        out = mv.eval()(_torch({"imgs": data["imgs"], "rots": data["rots"]}))
    assert out["pred_gaze"].shape == (B, 2) and bool(torch.isfinite(out["pred_gaze"]).all())
    assert out["iter_1"]["pred_gazes"].shape == (B, 3, 2)


def test_single_view_input_is_refused():
    mv = FeatRotationMultiView(**BASE).eval()
    data = _inputs(2)
    with pytest.raises(ValueError, match="at least 2 views"):
        mv(_torch({"imgs": data["imgs"][:, :1], "rots": data["rots"][:, :1]}))


@pytest.mark.parametrize("v", [2, 3, 5])
def test_multiview_loss_matches_jax(v):
    """Against JAX at 1e-5 / 1e-4 (also inside IterationLoss), and at V=2
    against StereoL1Loss on the same predictions."""
    rng = np.random.default_rng(v)
    preds = rng.uniform(-1, 1, (B, v, 2)).astype(np.float32)
    gts = rng.uniform(-1, 1, (B, v, 2)).astype(np.float32)
    for decay in (1.0, 0.3):
        loss = MultiViewL1Loss(rel_weight=0.01, reference_decay=decay)
        want = JaxMultiViewL1Loss(rel_weight=0.01, reference_decay=decay)(
            {"pred_gazes": jnp.asarray(preds), "gt_gazes": jnp.asarray(gts)})
        got = loss({"pred_gazes": torch.from_numpy(preds), "gt_gazes": torch.from_numpy(gts)})
        np.testing.assert_allclose(float(got), float(want), atol=1e-5, rtol=1e-4)
        if v == 2:
            stereo = StereoL1Loss(rel_weight=0.01, reference_decay=decay)(
                {"pred_gaze_0": torch.from_numpy(preds[:, 0]), "pred_gaze_1": torch.from_numpy(preds[:, 1]),
                 "gt_gaze": torch.from_numpy(gts[:, 0]), "gt_gaze_1": torch.from_numpy(gts[:, 1])})
            assert torch.equal(got, stereo)
    iters = {f"iter_{i}": {"pred_gazes": preds * (i + 1)} for i in range(3)}
    got = IterationLoss(MultiViewL1Loss(0.01), iter_decay=0.5)(
        {"gt_gazes": torch.from_numpy(gts), **{k: {"pred_gazes": torch.from_numpy(d["pred_gazes"])}
                                                for k, d in iters.items()}})
    want = JaxIterationLoss(JaxMultiViewL1Loss(0.01), iter_decay=0.5)(
        {"gt_gazes": jnp.asarray(gts), **{k: {"pred_gazes": jnp.asarray(d["pred_gazes"])}
                                           for k, d in iters.items()}})
    np.testing.assert_allclose(float(got), float(want), atol=1e-5, rtol=1e-4)
    with pytest.raises(ValueError, match=r"\(B, V, 2\)"):
        MultiViewL1Loss()({"pred_gazes": torch.zeros(B, v, 2), "gt_gazes": torch.zeros(B, v + 1, 2)})


# ---------------------------------------------------------------------------
# the train and eval steps
# ---------------------------------------------------------------------------

SCHEDULE = dict(base_lr=1e-6, max_lr=1e-4, step_size_up=3, step_size_down=3)
V = 3


def _step_batch(seed=7):
    """Pre-augmented float views (augment=False), poses and labels."""
    rng = np.random.default_rng(seed)
    return {
        "imgs": rng.standard_normal((B, V, S, S, 3)).astype(np.float32),
        "head_poses": rng.uniform(-0.5, 0.5, (B, V, 2)).astype(np.float32),
        "gt_gazes": rng.uniform(-0.5, 0.5, (B, V, 2)).astype(np.float32),
    }


OPTIONS = {
    "plain": {},
    "ema_images": {"ema_decay": 0.9, "with_images": True},
    "freeze_bn": {"freeze_bn": True},
}


def _jax_trajectory(variables, batch, opts, pallas_bn):
    """(stats of each update, final TrainState) of 2 updates of JAX's
    V-view step, augment=False."""
    with pytest.MonkeyPatch.context() as m:
        if pallas_bn:
            _jax_pallas_bn(m)
        schedule = jax_cyclic_triangular2(**SCHEDULE)
        tx = jax_make_optimizer(schedule)
        jax_step = jax.jit(jax_make_multiview_train_step(
            JaxFeatRotationMultiView(**BASE), _metrics(False), tx, image_size=S, schedule=schedule,
            augment=False, **opts))
        params = jax.tree.map(jnp.asarray, variables["params"])
        state = TrainState(step=jnp.asarray(0), params=params,
                           batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
                           opt_state=tx.init(params),
                           ema_params=jax.tree.map(jnp.copy, params) if "ema_decay" in opts else None)
        jax_stats = []
        for _ in range(2):
            state, stats = jax_step(state, jax.tree.map(jnp.asarray, batch), jax.random.PRNGKey(0))
            jax_stats.append(jax.tree.map(np.asarray, stats))
    return jax_stats, state


@pytest.fixture(scope="module")
def warm_variables():
    """Variables whose BN running statistics come from one train-mode
    forward on another batch: the warm start freeze_bn is meant for. From
    statistics far from the batch's, an eval-mode pre-activation can lie
    within float32 rounding of 0 and flip its ReLU mask in one package and
    not the other (tests/test_torch_train.py::warm_variables)."""
    variables = _variables(BASE, seed=8)
    data = _inputs(V, seed=12)
    _, updates = JaxFeatRotationMultiView(**BASE).apply(
        variables, {"imgs": jnp.asarray(data["imgs"]), "rots": jnp.asarray(data["rots"])}, train=True,
        mutable=["batch_stats"])
    return {"params": variables["params"], "batch_stats": jax.tree.map(np.asarray, updates["batch_stats"])}


@pytest.fixture(scope="module", params=list(OPTIONS))
def trajectory(request, warm_variables):
    """2 updates of both V-view train steps from one converted state,
    augment=False, on the same batch; JAX's with Pallas BN, and its loss
    with XLA's BN too."""
    opts = OPTIONS[request.param]
    variables = warm_variables
    batch = _step_batch()
    jax_stats, state = _jax_trajectory(variables, batch, opts, pallas_bn=True)
    xla_stats, _ = _jax_trajectory(variables, batch, opts, pallas_bn=False)
    model = _port(BASE, variables)
    ema = init_ema(model) if "ema_decay" in opts else None
    step = make_multiview_train_step(model, _metrics(), make_optimizer(model.parameters()), image_size=S,
                                     schedule=cyclic_triangular2(**SCHEDULE), augment=False, ema=ema,
                                     **opts)
    port_stats = [step(_torch(batch), step=i) for i in range(2)]

    final = jax.tree.map(np.asarray, {"params": state.params, "batch_stats": state.batch_stats})
    jax_ema = None if state.ema_params is None else jax.tree.map(np.asarray, state.ema_params)
    return request.param, variables, batch, jax_stats, port_stats, model, ema, final, jax_ema, xla_stats


def test_trajectory_matches_jax(trajectory):
    """Loss, error and rate each update at rtol 1e-4 (rate 1e-6), against
    JAX with either BN; parameters after 2 updates atol 2e-5, running
    statistics 1e-4, the EMA 2e-5; previews are views 0 and 1 as given;
    under freeze_bn every BN buffer is the initial one bit for bit."""
    name, variables, batch, jax_stats, port_stats, model, ema, final, jax_ema, xla_stats = trajectory
    for i, (want, xla, got) in enumerate(zip(jax_stats, xla_stats, port_stats)):
        for key in ("loss_gaze", "error_gaze"):
            np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-4, err_msg=f"{name} {i} {key}")
            np.testing.assert_allclose(float(got[key]), float(xla[key]), rtol=1e-4, err_msg=f"{name} {i} {key}")
        np.testing.assert_allclose(got["lr"], float(want["lr"]), rtol=1e-6)
        assert got["pred_gaze"].shape == (B, 2)
        if OPTIONS[name].get("with_images"):
            for v, view in enumerate(("img_0", "img_1")):
                np.testing.assert_array_equal(got[view].numpy(), batch["imgs"][:8, v])
                np.testing.assert_array_equal(got[view].numpy(), want[view])
        else:
            assert "img_0" not in got
    want = _convert(final, BASE)
    state = model.state_dict()
    initial = _convert(variables, BASE)
    for key, value in want.items():
        if key.endswith("num_batches_tracked") or ".fc." in key:
            continue
        atol = 1e-4 if "running_" in key else 2e-5
        np.testing.assert_allclose(state[key].numpy(), value.numpy(), atol=atol, rtol=0, err_msg=key)
    key = "_gaze_estimators.1.blocks.1.0.weight"
    assert float((state[key] - initial[key]).abs().max()) > 1e-6  # it trained
    if name == "freeze_bn":
        for key, value in state.items():
            if "running_" in key or "num_batches_tracked" in key:
                assert torch.equal(value, initial[key]), key
    if ema is not None:
        want_ema = _convert({"params": jax_ema, "batch_stats": variables["batch_stats"]}, BASE)
        for key, value in ema.items():
            np.testing.assert_allclose(value.numpy(), want_ema[key].numpy(), atol=2e-5, err_msg=key)


def test_eval_step_matches_jax():
    """The eval step on uint8 views: pred_gaze against JAX's at the model's
    bar, previews of views 0 and 1."""
    variables = _variables(BASE, seed=9)
    rng = np.random.default_rng(10)
    batch = {"imgs": rng.integers(0, 256, (B, V, S, S, 3), dtype=np.uint8),
             "head_poses": rng.uniform(-0.5, 0.5, (B, V, 2)).astype(np.float32),
             "gt_gazes": rng.uniform(-0.5, 0.5, (B, V, 2)).astype(np.float32)}
    want = jax_make_multiview_eval_step(JaxFeatRotationMultiView(**BASE), image_size=S)(
        variables["params"], variables["batch_stats"], jax.tree.map(jnp.asarray, batch))
    got = make_multiview_eval_step(_port(BASE, variables), image_size=S)(_torch(batch))
    np.testing.assert_allclose(got["pred_gaze"].numpy(), np.asarray(want["pred_gaze"]), atol=2e-4, rtol=1e-3)
    for view in ("img_0", "img_1"):
        assert got[view].shape == (B, S, S, 3)
        np.testing.assert_allclose(got[view].numpy(), np.asarray(want[view]), atol=1e-6, rtol=0)


def test_augmenting_step_draws_per_row_and_by_step():
    """With augmentation all B·V views are augmented in one call from the
    step's generator (each row its own draws), and under fold_key_by_step
    the draws depend on the seed and update count only."""
    from rot_mvgaze_tpu_torch.augment.ops import train_preprocess
    from rot_mvgaze_tpu_torch.train.steps import fold_seed

    torch.manual_seed(0)
    model = FeatRotationMultiView(backbone_depth=18, num_iter=1)
    seen = []

    def metrics(out):
        seen.append(out["imgs"].detach().clone())
        return out["pred_gaze"].float().sum() * 0.0

    step = make_multiview_train_step(model, metrics, make_optimizer(model.parameters()), image_size=S,
                                     fold_key_by_step=True)
    rng = np.random.default_rng(11)
    batch = _torch(_step_batch())
    batch["imgs"] = torch.from_numpy(rng.integers(0, 256, (B, V, S, S, 3), dtype=np.uint8))
    gen = torch.Generator().manual_seed(12)
    for s in (4, 5, 4):
        step(batch, gen, step=s)
    assert torch.equal(seen[0], seen[2]) and not torch.equal(seen[0], seen[1])
    flat = batch["imgs"].reshape(B * V, S, S, 3)
    want = train_preprocess(flat, torch.Generator().manual_seed(fold_seed(12, 4)), S)
    assert torch.equal(seen[0], want.reshape(B, V, S, S, 3))
    assert not torch.equal(seen[0][:, 0], seen[0][:, 1])
