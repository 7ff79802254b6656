"""--remat in the port (each residual block recomputed in the backward,
``torch.utils.checkpoint``) on the CPU, mirroring
tests/test_models.py::TestRemat: the remat model's step equals the plain
model's from the same state, and its BatchNorm running statistics move once
per call, as JAX's recompute changes no state. Its train forward against
JAX's remat model (XLA BatchNorm) at the model bar (atol 2e-4 / rtol 1e-3),
the running statistics at 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rot_mvgaze_tpu.geometry import rotation_matrix_2d as jax_rotation_matrix_2d
from rot_mvgaze_tpu.models import FeatRotationSymm as JaxFeatRotationSymm
from rot_mvgaze_tpu_torch.compat import state_dict_from_jax
from rot_mvgaze_tpu_torch.losses import IterationLoss, StereoL1Loss
from rot_mvgaze_tpu_torch.models import FeatRotationMultiView, FeatRotationSymm, SingleViewGazeNet
from rot_mvgaze_tpu_torch.models.norm import BatchNormAct
from rot_mvgaze_tpu_torch.ops import batchnorm
from rot_mvgaze_tpu_torch.train import make_optimizer, make_train_step

CFG = {"backbone_depth": 18, "num_iter": 2}
PAIRS, SIZE = 4, 32


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _batch(seed=0):
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


def _counting(monkeypatch):
    """Calls of each BN wrapper (their plain versions run here; the kernels
    count launches only on the card)."""
    calls = {}
    for name in ("bn_stats", "bn_apply", "bn_bwd_reduce", "bn_bwd_dx"):
        fn = getattr(batchnorm, name)

        def counted(*args, _fn=fn, _name=name, **kwargs):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*args, **kwargs)

        monkeypatch.setattr(batchnorm, name, counted)
    return calls


def _one_step(remat, batch, monkeypatch):
    torch.manual_seed(0)
    model = FeatRotationSymm(**CFG, remat=remat).to(memory_format=torch.channels_last)
    metrics = IterationLoss(StereoL1Loss(rel_weight=0.01, reference_decay=1.0), iter_decay=0.5)
    optimizer = make_optimizer(model.parameters(), lr=1e-4)
    step = make_train_step(model, metrics, optimizer, image_size=SIZE, augment=False)
    with monkeypatch.context() as m:
        calls = _counting(m)
        stats = step({k: torch.from_numpy(v) for k, v in batch.items()}, step=0)
    grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    return stats, grads, model, calls


@pytest.fixture(scope="module")
def steps():
    mp = pytest.MonkeyPatch()
    batch = _batch()
    try:
        return {remat: _one_step(remat, batch, mp) for remat in (False, True)}
    finally:
        mp.undo()


def test_remat_step_equals_the_plain_step(steps):
    """Loss, error, every gradient, every parameter after Adam and every BN
    buffer bit for bit: the recompute repeats the same float32 operations on
    the same values (tests/test_models.py holds JAX's to atol 1e-6)."""
    (s0, g0, m0, _), (s1, g1, m1, _) = steps[False], steps[True]
    assert float(s0["loss_gaze"]) == float(s1["loss_gaze"])
    assert float(s0["error_gaze"]) == float(s1["error_gaze"])
    assert g0.keys() == g1.keys() and len(g0) > 60
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name
    for (name, a), b in zip(m0.state_dict().items(), m1.state_dict().values()):
        assert torch.equal(a, b), name


def test_running_statistics_move_once_per_call(steps):
    """Each BN's num_batches_tracked is 2 after one stereo step (once per
    view) with and without remat; the recompute changed no buffer."""
    for remat in (False, True):
        model = steps[remat][2]
        bns = [m for m in model.modules() if isinstance(m, BatchNormAct)]
        assert len(bns) == 20
        assert {int(m.num_batches_tracked) for m in bns} == {2}


def test_the_recompute_calls_the_forward_kernels_again(steps):
    """R18 has 20 BNs, 19 in its 8 blocks: per stereo step bn_stats and
    bn_apply run 40 times plain and 40 + 2 x 19 = 78 times under remat; the
    backward's bn_bwd_reduce and bn_bwd_dx 40 times either way (R50: 106
    and 210, chip_smoke.py phase 12b)."""
    assert steps[False][3] == {"bn_stats": 40, "bn_apply": 40, "bn_bwd_reduce": 40, "bn_bwd_dx": 40}
    assert steps[True][3] == {"bn_stats": 78, "bn_apply": 78, "bn_bwd_reduce": 40, "bn_bwd_dx": 40}


def test_remat_is_off_outside_training():
    """Eval mode and no-grad forwards run the blocks as they are (nothing to
    recompute) and match the plain model's output bit for bit."""
    torch.manual_seed(1)
    plain = FeatRotationSymm(**CFG)
    remat = FeatRotationSymm(**CFG, remat=True)
    remat.load_state_dict(plain.state_dict())
    data = {k: torch.from_numpy(v) for k, v in _batch(1).items()}
    from rot_mvgaze_tpu_torch.train.steps import prepare_rotations

    inputs = {"img_0": data["img_0"], "img_1": data["img_1"], **prepare_rotations(data)}
    for mode in ("eval", "train"):
        getattr(plain, mode)()
        getattr(remat, mode)()
        with torch.no_grad():
            a, b = plain(inputs), remat(inputs)
        assert torch.equal(a["pred_gaze"], b["pred_gaze"]), mode


def test_every_model_takes_remat():
    """The field is on every model the JAX package gives it (rot_mv.py,
    multiview.py, single.py) and reaches the backbone."""
    for model in (FeatRotationSymm(backbone_depth=18, num_iter=1, remat=True),
                  FeatRotationMultiView(backbone_depth=18, num_iter=1, remat=True),
                  SingleViewGazeNet(backbone_depth=18, remat=True)):
        assert model.remat and model._feat_extractor[0].remat


def test_remat_train_forward_matches_jax():
    """The remat model's train forward against JAX's remat model (nn.remat
    around each block, XLA BatchNorm) from the same variables: outputs at
    the model bar, running statistics at 1e-4."""
    batch = _batch(2)
    data = {"img_0": batch["img_0"], "img_1": batch["img_1"],
            "rot_0": np.asarray(jax_rotation_matrix_2d(jnp.asarray(batch["head_pose_0"]))),
            "rot_1": np.asarray(jax_rotation_matrix_2d(jnp.asarray(batch["head_pose_1"])))}
    model = JaxFeatRotationSymm(**CFG, remat=True)
    variables = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0), jax.tree.map(jnp.asarray, data)))
    want, updates = model.apply(variables, jax.tree.map(jnp.asarray, data), train=True, mutable=["batch_stats"])
    port = FeatRotationSymm(**CFG, remat=True)
    port.load_state_dict(state_dict_from_jax(variables, **CFG), strict=True)
    got = port.train()({k: torch.from_numpy(v) for k, v in data.items()})
    got["pred_gaze"].sum().backward()  # through the recompute
    for i in range(CFG["num_iter"]):
        for key in ("feat_0", "feat_1", "pred_gaze_0", "pred_gaze_1"):
            np.testing.assert_allclose(got[f"iter_{i}"][key].detach().numpy(),
                                       np.asarray(want[f"iter_{i}"][key]), atol=2e-4, rtol=1e-3,
                                       err_msg=f"iter_{i}.{key}")
    stats = state_dict_from_jax({"params": variables["params"],
                                 "batch_stats": jax.tree.map(np.asarray, updates["batch_stats"])}, **CFG)
    state = port.state_dict()
    for key, value in stats.items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(state[key].numpy(), value.numpy(), atol=1e-4, err_msg=key)
