"""The port's Workload (rot_mvgaze_tpu_torch.utils.drivers) against the JAX
package's: the cases of tests/test_workload.py, host batches bit for bit,
one train update and the eval step on the same weights and numpy batch.

The JAX side of the update runs its Pallas BatchNorm and fuser in interpret
mode (``use_pallas_bn=True, use_pallas_fusion=True``, which the JAX
Workload passes to its model), as the port's other trajectory tests do:
XLA's BatchNorm rounds float32 otherwise, and Adam's first update turns a
rounding into a whole learning rate (ROADMAP Queue C, "Not faults")."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rot_mvgaze_tpu.train.trainer import TrainState
from rot_mvgaze_tpu.train.trainer import make_optimizer as jax_make_optimizer
from rot_mvgaze_tpu.utils.drivers import Workload as JaxWorkload
from rot_mvgaze_tpu_torch.compat import state_dict_from_jax
from rot_mvgaze_tpu_torch.train import make_optimizer
from rot_mvgaze_tpu_torch.utils.drivers import (
    Workload,
    card_of,
    make_host_batch,
    make_multiview_host_batch,
    to_device,
)

CFG = {"backbone_depth": 18, "num_iter": 1}
PALLAS = {"use_pallas_bn": True, "use_pallas_fusion": True}
PAIRS, SIZE = 4, 32
# a constant rate of 3.4e-5, the trajectory tests' second (optax evaluates a
# schedule at its own count, which starts at 0)
LR = 3.4e-5


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


class TestConstruction:
    def test_stereo_default(self):
        wl = Workload(**CFG)
        assert not wl.multiview and wl.num_views == 2
        assert type(wl.model).__name__ == "FeatRotationSymm"
        assert wl.images_per_sample() == 2
        assert wl.dtype == torch.float32

    def test_multiview(self):
        wl = Workload(num_views=3, **CFG)
        assert wl.multiview
        assert type(wl.model).__name__ == "FeatRotationMultiView"
        assert wl.images_per_sample() == 3

    def test_stereo_options_forwarded(self):
        wl = Workload(**CFG, fuse_views=True, share_weights=True, remat=True)
        assert wl.model.fuse_views is True and wl.model.share_weights is True and wl.model.remat is True
        wl = Workload(**CFG, bn_stat_subsample=2, int8_backbone="static")
        assert wl.model.bn_stat_subsample == 2 and wl.model.int8_backbone == "static"

    def test_pallas_options_accepted_and_inert(self):
        """JAX's use_pallas_* pass at V=2 and build the same model: on the
        card the kernels are the path."""
        wl = Workload(**CFG, **PALLAS)
        assert set(wl.model.state_dict()) == set(Workload(**CFG).model.state_dict())

    @pytest.mark.parametrize("option", ["use_pallas_fusion", "use_pallas_bn", "fuse_views"])
    def test_stereo_options_rejected_at_v3(self, option):
        with pytest.raises(ValueError, match=option):
            Workload(num_views=3, backbone_depth=18, **{option: True})

    def test_residual_pallas_bn_refused(self):
        with pytest.raises(ValueError, match="residual"):
            Workload(**CFG, use_pallas_bn="residual")

    def test_rejects_v_below_2(self):
        with pytest.raises(ValueError, match="num_views"):
            Workload(num_views=1)

    def test_loss_matches_view_arity(self):
        assert type(Workload(**CFG).metrics.loss).__name__ == "StereoL1Loss"
        assert type(Workload(num_views=3, **CFG).metrics.loss).__name__ == "MultiViewL1Loss"
        for v in (2, 3):
            ours, theirs = Workload(num_views=v, **CFG).metrics, JaxWorkload(num_views=v, **CFG).metrics
            assert ours.iter_decay == theirs.iter_decay == 0.5
            assert ours.loss.rel_weight == theirs.loss.rel_weight == 0.01
            assert ours.loss.reference_decay == theirs.loss.reference_decay == 1.0


class TestHostData:
    def test_stereo_shapes(self):
        wl = Workload(**CFG)
        b = wl.host_batch(np.random.default_rng(0), 4, 16)
        assert b["img_0"].shape == (4, 16, 16, 3) and b["img_0"].dtype == np.uint8
        assert set(b) == {"img_0", "img_1", "gt_gaze", "gt_gaze_1", "head_pose_0", "head_pose_1"}
        init = wl.init_data(16)
        assert init["img_0"].shape == (2, 16, 16, 3)
        assert init["rot_0"].shape == (2, 3, 3)
        assert torch.equal(init["rot_1"], torch.eye(3).expand(2, 3, 3))

    def test_multiview_shapes(self):
        wl = Workload(num_views=4, **CFG)
        b = wl.host_batch(np.random.default_rng(0), 3, 16)
        assert b["imgs"].shape == (3, 4, 16, 16, 3)
        assert b["gt_gazes"].shape == (3, 4, 2) and b["head_poses"].shape == (3, 4, 2)
        init = wl.init_data(16)
        assert init["imgs"].shape == (2, 4, 16, 16, 3)
        assert init["rots"].shape == (2, 4, 3, 3)

    @pytest.mark.parametrize("num_views", [2, 3])
    def test_host_batches_bit_for_bit_jax(self, num_views):
        """The same draws, in the same order, from the same generator."""
        ours = Workload(num_views=num_views, **CFG).host_batch(np.random.default_rng(7), 5, 24)
        theirs = JaxWorkload(num_views=num_views, **CFG).host_batch(np.random.default_rng(7), 5, 24)
        assert list(ours) == list(theirs)
        for k in ours:
            assert ours[k].dtype == theirs[k].dtype and np.array_equal(ours[k], theirs[k]), k

    def test_module_functions_are_the_workloads(self):
        a = make_host_batch(np.random.default_rng(1), 2, 8)
        b = Workload(**CFG).host_batch(np.random.default_rng(1), 2, 8)
        assert all(np.array_equal(a[k], b[k]) for k in a)
        a = make_multiview_host_batch(np.random.default_rng(1), 2, 8, 3)
        assert a["imgs"].shape == (2, 3, 8, 8, 3)

    def test_to_device_and_card(self):
        t = to_device({"x": np.arange(6, dtype=np.float32).reshape(2, 3)[:, ::2]}, "cpu")
        assert t["x"].tolist() == [[0.0, 2.0], [3.0, 5.0]]
        assert card_of("cpu") == {"name": "cpu", "power_limit": None}


class TestStepFactories:
    @pytest.mark.parametrize("num_views", [2, 3])
    def test_train_and_eval_steps_build(self, num_views):
        wl = Workload(num_views=num_views, **CFG)
        assert callable(wl.make_train_step(make_optimizer(wl.model.parameters()), image_size=16))
        assert callable(wl.make_eval_step(image_size=16))

    @pytest.mark.parametrize("num_views, factory", [(2, "make_train_step"), (3, "make_multiview_train_step")])
    def test_compute_dtype_follows_the_workload(self, monkeypatch, num_views, factory):
        """The workload's dtype is the step's compute dtype unless the
        caller gives one; the port's factory checks it."""
        import rot_mvgaze_tpu_torch.train as train

        seen = []
        monkeypatch.setattr(train, factory, lambda *a, **kw: seen.append(kw["compute_dtype"]))
        wl = Workload(num_views=num_views, dtype=torch.bfloat16, **CFG)
        opt = make_optimizer(wl.model.parameters())
        wl.make_train_step(opt, image_size=16)
        wl.make_train_step(opt, image_size=16, compute_dtype=torch.float32)
        assert seen == [torch.bfloat16, torch.float32]
        monkeypatch.undo()
        with pytest.raises(ValueError, match="compute_dtype"):
            wl.make_train_step(opt, image_size=16, compute_dtype=torch.float16)


def _float_batch(seed=3):
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


@pytest.fixture(scope="module")
def jax_workload():
    wl = JaxWorkload(**CFG, **PALLAS)
    variables = wl.model.init(jax.random.PRNGKey(0), wl.init_data(SIZE))
    return wl, jax.tree.map(np.asarray, variables)


def _port_workload(variables):
    wl = Workload(**CFG)
    wl.model.load_state_dict(state_dict_from_jax(variables, **CFG), strict=True)
    return wl


def _assert_buffers_close(model, variables, atol):
    want = state_dict_from_jax(variables, **CFG)
    got = model.state_dict()
    for key, value in want.items():
        if "running_" in key:
            np.testing.assert_allclose(got[key].numpy(), value.numpy(), atol=atol, rtol=0.0, err_msg=key)


def update_gaps(got, want, start):
    """Per parameter leaf, |(got - start) - (want - start)| / |want - start|
    in float64 (tests/test_torch_ema_probe.py's measure); a leaf JAX's
    update left where it was must stay there bit for bit."""
    gaps = {}
    for key, w in want.items():
        if "running_" in key or "num_batches" in key:
            continue
        s = start[key].double()
        dw, dg = w.double() - s, got[key].double() - s
        norm = float(dw.norm())
        gaps[key] = (0.0 if torch.equal(dg, dw) else float("inf")) if norm == 0.0 else float((dg - dw).norm()) / norm
    return gaps


# each leaf's update relative to JAX's, worst leaf. Measured: 1.8e-2 (a
# layer-1 conv whose one element moves +lr in one package and -lr in the
# other); 0.1 leaves about 5x room. An update at half the rate lies 0.5 from
# JAX's, one at 0.8 of it 0.2 (test_update_bar_rejects_a_planted_rate)
UPDATE_BAR = 0.1


@pytest.fixture(scope="module")
def jax_update(jax_workload):
    """One f32 update of JAX's Workload at the rate LR on _float_batch():
    (batch, the step's stats, the state dict before and after)."""
    jwl, variables = jax_workload
    batch = _float_batch()
    tx = jax_make_optimizer(lambda _count: LR)
    step = jax.jit(jwl.make_train_step(tx, image_size=SIZE, schedule=lambda _count: LR, augment=False))
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = TrainState(step=jnp.asarray(0), params=params,
                       batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]), opt_state=tx.init(params))
    state, want = step(state, jax.tree.map(jnp.asarray, batch), jax.random.PRNGKey(0))
    final = jax.tree.map(np.asarray, {"params": state.params, "batch_stats": state.batch_stats})
    return batch, want, final


def _port_update(variables, batch, lr):
    """One f32 update of the port's Workload from JAX's weights at the rate
    ``lr``: (the model, the step's stats)."""
    wl = _port_workload(variables)
    ours = wl.make_train_step(make_optimizer(wl.model.parameters()), image_size=SIZE,
                              schedule=lambda _count: lr, augment=False)
    got = ours({k: torch.from_numpy(v) for k, v in batch.items()}, step=0)
    return wl.model, got


def test_one_update_matches_jax(jax_workload, jax_update):
    """One f32 update of R18 x 1 at 32x32, 4 pairs, through each package's
    Workload from the same weights and batch at the rate LR: the loss and
    error at rtol 1e-4 and the running statistics within 1e-4, the
    trajectory tests' bars (tests/test_torch_train.py); each parameter
    leaf's update within UPDATE_BAR of JAX's, relative to it. Adam's first
    update is lr * g / (|g| + eps), so an element whose gradient float32
    rounding puts on either side of zero moves by +lr in one package and
    -lr in the other: the parameters are held by their updates, as the EMA
    probe's test holds them, and the worst element is printed."""
    _, variables = jax_workload
    batch, want, final = jax_update
    model, got = _port_update(variables, batch, LR)
    np.testing.assert_allclose(got["lr"], float(want["lr"]), rtol=1e-6)
    np.testing.assert_allclose(float(got["loss_gaze"]), float(want["loss_gaze"]), rtol=1e-4)
    np.testing.assert_allclose(float(got["error_gaze"]), float(want["error_gaze"]), rtol=1e-4)
    _assert_buffers_close(model, final, 1e-4)
    start = state_dict_from_jax(variables, **CFG)
    after = state_dict_from_jax(final, **CFG)
    now = model.state_dict()
    gaps = update_gaps(now, after, start)
    worst = max(gaps, key=gaps.get)
    element = max(float((now[k].double() - after[k].double()).abs().max()) for k in gaps)
    print(f"one update: worst leaf {worst} {gaps[worst]:.3e}, median {np.median(list(gaps.values())):.3e}; "
          f"worst element {element:.3e} (lr {LR})")
    assert not {k: v for k, v in gaps.items() if not v <= UPDATE_BAR}
    key = "_gaze_estimators.0.blocks.1.0.weight"
    assert float((now[key] - start[key]).abs().max()) > 1e-5  # it trained


@pytest.mark.parametrize("rate", [0.5, 0.8], ids=["half_rate", "rate_0.8"])
def test_update_bar_rejects_a_planted_rate(jax_workload, jax_update, rate):
    """The port's update at ``rate`` x LR, against JAX's at LR: the worst
    leaf lies about |1 - rate| from JAX's update (Adam's first step is
    linear in the rate) and fails UPDATE_BAR."""
    _, variables = jax_workload
    batch, _, final = jax_update
    model, _ = _port_update(variables, batch, rate * LR)
    gaps = update_gaps(model.state_dict(), state_dict_from_jax(final, **CFG), state_dict_from_jax(variables, **CFG))
    worst = max(gaps.values())
    print(f"update at {rate} x LR: worst leaf {worst:.3e}, median {np.median(list(gaps.values())):.3e}")
    assert worst > UPDATE_BAR
    assert abs(np.median(list(gaps.values())) - (1 - rate)) < 0.05


def test_eval_step_matches_jax(jax_workload):
    """The eval step of each Workload on the same uint8 host batch (eval
    preprocessing, running statistics): pred_gaze at the model bar, atol
    2e-4 / rtol 1e-3."""
    jwl, variables = jax_workload
    host = jwl.host_batch(np.random.default_rng(11), PAIRS, SIZE)
    want = jax.jit(jwl.make_eval_step(image_size=SIZE))(
        variables["params"], variables["batch_stats"], jax.tree.map(jnp.asarray, host))
    wl = _port_workload(variables)
    got = wl.make_eval_step(image_size=SIZE)(to_device(host, "cpu"))
    np.testing.assert_allclose(got["pred_gaze"].numpy(), np.asarray(want["pred_gaze"]), atol=2e-4, rtol=1e-3)
