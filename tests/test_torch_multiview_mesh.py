"""The port's V-view steps over a data mesh of one process
(``make_multiview_train_step(mesh=)``, ``make_multiview_eval_step(mesh=)``,
``parallel.shard_batch`` on (B, V, H, W, C) leaves, the Trainer at V = 3 on
a mesh) on the CPU, R18 at 32x32, V = 3, against the port's unsharded
steps and the JAX package's V-view steps jitted over its virtual CPU
devices with the batch sharded on ``data``.

- Three Adam updates on (data 4) against the unsharded updates in float64
  (the BN kernels' plain versions taking float64): state and losses within
  1e-7 (tests/test_torch_spatial.py's float64 state bar).
- The same updates in float32 against JAX's on its 4-device mesh, whose
  V-view backbone runs the Pallas BN kernels in interpret mode (a
  test-side swap of its constructor, as tests/test_torch_multiview.py
  does: Adam's first updates turn XLA-BN rounding into whole learning
  rates): losses rtol 1e-4, running statistics 1e-4, each update since
  the start within 0.1 of JAX's relative to it (the whole update, and
  from update 2 on each leaf; an update at half the rate fails it), and
  parameters atol 2e-5, held where float32 cannot reach that by their
  distance from the float64 updates.
- The eval step on 7 samples over 4 replicas (padded by samples to 8)
  against the unsharded eval step and JAX's, at the model bar (atol 2e-4 /
  rtol 1e-3).
- The images reach the replicas: every train-mode BN call receives one
  block of whole samples' views per replica, and ``shard_batch`` cuts a
  V-view leaf b-major.
- The Trainer with a (data 2) mesh: ``test`` within 1e-4 deg of the
  Trainer without one, one epoch's losses at rtol 1e-4, and ``test`` after
  it within 1e-4 deg.
- Refusals: a spatial mesh, and a sample count the replicas do not split.
"""

import contextlib
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rot_mvgaze_tpu.models.multiview as jax_multiview
from rot_mvgaze_tpu.losses import IterationLoss as JaxIterationLoss
from rot_mvgaze_tpu.losses import MultiViewL1Loss as JaxMultiViewL1Loss
from rot_mvgaze_tpu.models.multiview import FeatRotationMultiView as JaxFeatRotationMultiView
from rot_mvgaze_tpu.parallel.mesh import make_mesh as jax_make_mesh
from rot_mvgaze_tpu.parallel.mesh import replicated_sharding as jax_replicated
from rot_mvgaze_tpu.parallel.mesh import shard_batch as jax_shard_batch
from rot_mvgaze_tpu.train.multiview_steps import make_multiview_eval_step as jax_make_multiview_eval_step
from rot_mvgaze_tpu.train.multiview_steps import make_multiview_train_step as jax_make_multiview_train_step
from rot_mvgaze_tpu.train.schedule import cyclic_triangular2 as jax_cyclic_triangular2
from rot_mvgaze_tpu.train.trainer import TrainState
from rot_mvgaze_tpu.train.trainer import make_optimizer as jax_make_optimizer
from rot_mvgaze_tpu_torch.compat import state_dict_from_jax
from rot_mvgaze_tpu_torch.data import BatchLoader, MultiViewGazeDataset, write_synthetic_dataset
from rot_mvgaze_tpu_torch.losses import IterationLoss, MultiViewL1Loss
from rot_mvgaze_tpu_torch.models import FeatRotationMultiView, norm
from rot_mvgaze_tpu_torch.ops import batchnorm
from rot_mvgaze_tpu_torch.parallel import Sharded, make_mesh, shard_batch
from rot_mvgaze_tpu_torch.train import (
    Trainer,
    cyclic_triangular2,
    make_multiview_eval_step,
    make_multiview_train_step,
    make_optimizer,
)

S, V, B = 32, 3, 4
CFG = {"backbone_depth": 18, "num_iter": 2}
SCHEDULE = dict(base_lr=1e-6, max_lr=1e-4, step_size_up=3, step_size_down=3)
STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _batch(seed=7, b=B):
    """Pre-augmented float views (augment=False), poses and labels."""
    rng = np.random.default_rng(seed)
    return {
        "imgs": rng.standard_normal((b, V, S, S, 3)).astype(np.float32),
        "head_poses": rng.uniform(-0.5, 0.5, (b, V, 2)).astype(np.float32),
        "gt_gazes": rng.uniform(-0.5, 0.5, (b, V, 2)).astype(np.float32),
    }


@pytest.fixture(scope="module")
def variables():
    init = {"imgs": jnp.zeros((2, V, S, S, 3)), "rots": jnp.broadcast_to(jnp.eye(3), (2, V, 3, 3))}
    return jax.tree.map(np.asarray, jax.jit(JaxFeatRotationMultiView(**CFG).init)(jax.random.PRNGKey(3), init))


def _metrics():
    return IterationLoss(MultiViewL1Loss(rel_weight=0.01, reference_decay=1.0), iter_decay=0.5)


def _port(variables, dtype=torch.float32):
    model = FeatRotationMultiView(**CFG)
    model.load_state_dict(state_dict_from_jax(variables, **CFG), strict=True)
    return model.to(dtype=dtype, memory_format=torch.channels_last)


@contextlib.contextmanager
def _float64_plain_path():
    """The BN kernels' plain versions taking float64 (their float32/bfloat16
    checks lifted); the V-view fusers are F.linear."""
    check = batchnorm._check_vectors
    batchnorm._DTYPE_CODES[torch.float64] = -1
    batchnorm._check_vectors = lambda *args, **kwargs: None
    try:
        yield
    finally:
        del batchnorm._DTYPE_CODES[torch.float64]
        batchnorm._check_vectors = check


def _port_steps(variables, mesh, dtype, schedule=SCHEDULE):
    """STEPS updates of the port's V-view step from ``variables`` (Adam,
    the cyclic ``schedule``, augment=False): losses, the state after each."""
    model = _port(variables, dtype)
    step = make_multiview_train_step(model, _metrics(), make_optimizer(model.parameters()), image_size=S,
                                     schedule=cyclic_triangular2(**schedule), augment=False, mesh=mesh)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    batch["imgs"] = batch["imgs"].to(dtype)
    losses, states = [], []
    with _float64_plain_path() if dtype == torch.float64 else contextlib.nullcontext():
        for i in range(STEPS):
            losses.append(float(step(batch, step=i)["loss_gaze"]))
            states.append({k: v.detach().double().clone() for k, v in model.state_dict().items()})
    return losses, states


@pytest.fixture(scope="module")
def port_steps(variables):
    """The port's updates on (data 4) in float32 and float64, and unsharded
    in float64."""
    return {(name, dtype): _port_steps(variables, mesh, dtype)
            for name, mesh, dtype in (("data4", make_mesh(["cpu"] * 4), torch.float32),
                                      ("data4", make_mesh(["cpu"] * 4), torch.float64),
                                      ("unsharded", None, torch.float64))}


def _compared_keys(state):
    return [k for k in state if "num_batches_tracked" not in k and ".fc." not in k]


def test_mesh_steps_are_the_unsharded_steps_in_float64(port_steps):
    """Three updates on (data 4) in float64: the blocks change nothing but
    rounding (state and losses within 1e-7; the step takes its loss on
    float32 predictions, as JAX's does, so an ulp of float32 can show)."""
    (losses, states), (want_losses, want_states) = (port_steps["data4", torch.float64],
                                                    port_steps["unsharded", torch.float64])
    np.testing.assert_allclose(losses, want_losses, atol=1e-7, rtol=0)
    for i in range(STEPS):
        for key in _compared_keys(want_states[i]):
            torch.testing.assert_close(states[i][key], want_states[i][key], atol=1e-7, rtol=0,
                                       msg=lambda m, key=key: f"{key} (update {i + 1}): {m}")
    key = "_gaze_estimators.1.blocks.1.0.weight"
    assert float((states[-1][key] - states[0][key]).abs().max()) > 1e-6  # it trained


def _jax_pallas_bn(monkeypatch):
    """JAX's V-view model builds its backbone with use_pallas_bn=True while
    ``monkeypatch`` lasts (tests/test_torch_multiview.py)."""
    backbones = dict(jax_multiview.BACKBONES)
    backbones[18] = functools.partial(backbones[18], use_pallas_bn=True)
    monkeypatch.setattr(jax_multiview, "BACKBONES", backbones)


def _hold(got, want, anchor, atol, rtol, what):
    """``got`` within atol + rtol·|want| of ``want``, or, where float32
    cannot reach that, no farther from the float64 ``anchor`` than 1.5x
    ``want`` is (tests/test_torch_spatial.py's rule). Returns whether the
    bar held."""
    got, want, anchor = (torch.as_tensor(t, dtype=torch.float64) for t in (got, want, anchor))
    if bool(((got - want).abs() <= atol + rtol * want.abs()).all()):
        return True
    ours, theirs = float((got - anchor).abs().max()), float((want - anchor).abs().max())
    assert ours <= 1.5 * theirs, f"{what}: {ours:.3e} from float64, JAX {theirs:.3e}"
    return False


@pytest.fixture(scope="module")
def jax_mesh_steps(variables):
    """STEPS updates of JAX's V-view step jitted over 4 devices (state
    replicated, the batch's samples sharded on ``data``; Pallas BN): the
    losses and the state dict after each update."""
    with pytest.MonkeyPatch.context() as m:
        _jax_pallas_bn(m)
        mesh = jax_make_mesh(jax.devices()[:4])
        schedule = jax_cyclic_triangular2(**SCHEDULE)
        tx = jax_make_optimizer(schedule)
        rep = jax_replicated(mesh)
        step = jax.jit(jax_make_multiview_train_step(JaxFeatRotationMultiView(**CFG), JaxIterationLoss(
            loss=JaxMultiViewL1Loss(rel_weight=0.01, reference_decay=1.0), iter_decay=0.5), tx, image_size=S,
            schedule=schedule, augment=False), out_shardings=(rep, rep))
        params = jax.tree.map(jnp.asarray, variables["params"])
        state = jax.device_put(TrainState(step=jnp.asarray(0), params=params,
                                          batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
                                          opt_state=tx.init(params)), rep)
        batch = jax_shard_batch(_batch(), mesh)
        assert len(batch["imgs"].sharding.device_set) == 4
        losses, states = [], []
        for _ in range(STEPS):
            state, stats = step(state, batch, jax.random.PRNGKey(0))
            losses.append(float(stats["loss_gaze"]))
            states.append(state_dict_from_jax(
                jax.tree.map(np.asarray, {"params": state.params, "batch_stats": state.batch_stats}), **CFG))
    return losses, states


def _update_gaps(got, want, start):
    """Each parameter leaf's update since ``start`` against ``want``'s,
    |Δgot - Δwant| / |Δwant| in float64 (tests/test_torch_drivers.py's
    measure), and the same over every leaf at once."""
    gaps, num, den = {}, 0.0, 0.0
    for key in _compared_keys(want):
        if "running_" in key:
            continue
        w = want[key].double()
        miss, move = float((got[key].double() - w).norm()), float((w - start[key].double()).norm())
        gaps[key] = miss / move
        num, den = num + miss ** 2, den + move ** 2
    return gaps, (num / den) ** 0.5


# each update since the start against JAX's, relative to it. Measured on the
# CPU: the whole update 3.9e-2, 1.0e-2 and 7.9e-3 after updates 1-3; the
# worst leaf 3.7e-2 from update 2 on, but 0.25 at update 1 (lr 1e-6), where
# Adam's first step is lr·sign(g) and one element of a 64-element bias whose
# gradient float32 rounds to the other side of zero moves by -lr instead of
# +lr. An update at half the rate lies 0.5 from JAX's
# (test_update_bar_rejects_a_planted_rate)
UPDATE_BAR = 0.1


def _update_bars(states, jax_states, variables):
    """Per update: (the whole update's gap, the worst leaf and its gap,
    the leaves' median gap), and the updates that miss UPDATE_BAR: the
    whole update past it, or, from update 2 on, a leaf."""
    start = state_dict_from_jax(variables, **CFG)
    rows, missed = [], []
    for i in range(STEPS):
        gaps, whole = _update_gaps(states[i], jax_states[i], start)
        worst = max(gaps, key=gaps.get)
        rows.append((whole, worst, gaps[worst], float(np.median(list(gaps.values())))))
        if not whole <= UPDATE_BAR or (i > 0 and not gaps[worst] <= UPDATE_BAR):
            missed.append(i + 1)
    return rows, missed


def test_mesh_steps_match_jax_on_its_mesh(variables, port_steps, jax_mesh_steps):
    """The port's float32 updates on (data 4) against JAX's V-view step on
    its 4-device mesh, after each update: losses rtol 1e-4; running
    statistics atol 1e-4; each update since the start within UPDATE_BAR
    of JAX's as a whole and, from update 2 on, leaf by leaf; parameters atol 2e-5, or where float32 cannot
    reach that (Adam's early updates, lr·g / (|g| + eps), turn a rounding
    of a near-zero gradient into a step of up to the rate), no farther from
    the port's float64 updates than JAX's is, by 1.5x (:func:`_hold`), at
    update 1 (lr 1e-6) without that rule."""
    jax_losses, jax_states = jax_mesh_steps
    losses, states = port_steps["data4", torch.float32]
    f64_states = port_steps["unsharded", torch.float64][1]
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-4)
    rows, missed = _update_bars(states, jax_states, variables)
    beyond = {}
    for i in range(STEPS):
        for key in _compared_keys(jax_states[i]):
            if "running_" in key:
                torch.testing.assert_close(states[i][key], jax_states[i][key].double(), atol=1e-4, rtol=0,
                                           msg=lambda m, key=key: f"{key} (update {i + 1}): {m}")
            elif not _hold(states[i][key], jax_states[i][key], f64_states[i][key], 2e-5, 0.0,
                           f"{key} (update {i + 1})"):
                beyond.setdefault(i + 1, []).append(key)
    for i, (whole, worst, gap, median) in enumerate(rows):
        print(f"update {i + 1}: whole {whole:.3e}, worst leaf {worst} {gap:.3e}, median {median:.3e}; "
              f"{len(beyond.get(i + 1, []))} leaves past 2e-5, held by float64")
    assert not missed, rows
    # JAX's own float32 updates lie 5.6e-5 (update 2) and 1.4e-4 (update 3)
    # from the float64 ones at their worst, the port's on the mesh 4.6e-6
    assert 1 not in beyond, beyond[1]


def test_update_bar_rejects_a_planted_rate(variables, jax_mesh_steps):
    """The port's (data 4) updates at half the schedule's rate against
    JAX's at the full rate: every update misses UPDATE_BAR, and the
    leaves' median gap is about 0.5."""
    half = {k: v / 2 if k.endswith("lr") else v for k, v in SCHEDULE.items()}
    states = _port_steps(variables, make_mesh(["cpu"] * 4), torch.float32, schedule=half)[1]
    rows, missed = _update_bars(states, jax_mesh_steps[1], variables)
    print(f"updates at half the rate: {rows}")
    assert missed == list(range(1, STEPS + 1)), rows
    assert all(abs(median - 0.5) < 0.1 for *_, median in rows), rows


def test_mesh_eval_step_pads_by_samples(variables):
    """7 uint8 samples over 4 replicas (padded to 8 by repeating the last
    sample's views): the unsharded eval step's predictions and JAX's at the
    model bar, the previews views 0 and 1 of the first rows."""
    rng = np.random.default_rng(10)
    batch = {"imgs": rng.integers(0, 256, (7, V, S, S, 3), dtype=np.uint8),
             "head_poses": rng.uniform(-0.5, 0.5, (7, V, 2)).astype(np.float32),
             "gt_gazes": rng.uniform(-0.5, 0.5, (7, V, 2)).astype(np.float32)}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    model = _port(variables)
    got = make_multiview_eval_step(model, image_size=S, mesh=make_mesh(["cpu"] * 4))(tbatch)
    plain = make_multiview_eval_step(model, image_size=S)(tbatch)
    want = jax.jit(jax_make_multiview_eval_step(JaxFeatRotationMultiView(**CFG), image_size=S))(
        variables["params"], variables["batch_stats"], jax.tree.map(jnp.asarray, batch))
    assert got["pred_gaze"].shape == (7, 2)
    np.testing.assert_allclose(got["pred_gaze"].numpy(), plain["pred_gaze"].numpy(), atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(got["pred_gaze"].numpy(), np.asarray(want["pred_gaze"]), atol=2e-4, rtol=1e-3)
    for view in ("img_0", "img_1"):
        assert torch.equal(got[view], plain[view]) and got[view].shape == (7, S, S, 3)


def test_shard_batch_cuts_v_view_leaves_into_whole_samples():
    """A (B, V, H, W, C) leaf over (data 4): one block per replica, each
    its samples' V views b-major; the other leaves stay whole."""
    imgs = torch.arange(8 * V * 4 * 2 * 3, dtype=torch.float32).reshape(8, V, 4, 2, 3)
    poses = torch.zeros(8, V, 2)
    placed = shard_batch({"imgs": imgs, "head_poses": poses}, make_mesh(["cpu"] * 4))
    assert placed["head_poses"] is poses
    assert isinstance(placed["imgs"], Sharded) and placed["imgs"].shape == (8 * V, 4, 2, 3)
    assert [[tuple(t.shape) for t in row] for row in placed["imgs"].rows] == [[(2 * V, 4, 2, 3)]] * 4
    for d, row in enumerate(placed["imgs"].rows):
        assert torch.equal(row[0], imgs[2 * d:2 * d + 2].reshape(2 * V, 4, 2, 3))


def test_the_images_reach_every_replica(variables, monkeypatch):
    """Every train-mode BN call of a (data 4) update receives four blocks,
    each one sample's three views (R18: 20 BN calls); an update that
    passed the V-view leaf whole would run the one-block path and fail."""
    seen = []
    blocks = norm.fused_batchnorm_act_blocks

    def recorded(xs, *args, **kwargs):
        seen.append([[t.shape[0] for t in row] for row in xs])
        return blocks(xs, *args, **kwargs)

    monkeypatch.setattr(norm, "fused_batchnorm_act_blocks", recorded)
    model = _port(variables)
    step = make_multiview_train_step(model, _metrics(), make_optimizer(model.parameters()), image_size=S,
                                     augment=False, mesh=make_mesh(["cpu"] * 4))
    step({k: torch.from_numpy(v) for k, v in _batch().items()}, step=0)
    assert len(seen) == 20 and all(call == [[V]] * 4 for call in seen), seen


@pytest.mark.parametrize("mesh, b, match", [
    (lambda: make_mesh(["cpu"] * 4, spatial=2), B, "--spatial_partition is not supported with --num_views > 2"),
    (lambda: make_mesh(["cpu"] * 4), 6, "a batch of 6 samples .* does not split over 4 data replicas"),
], ids=["spatial", "uneven"])
def test_mesh_refusals(variables, mesh, b, match):
    model = _port(variables)

    def run():
        step = make_multiview_train_step(model, _metrics(), make_optimizer(model.parameters()), image_size=S,
                                         augment=False, mesh=mesh())
        step({k: torch.from_numpy(v) for k, v in _batch(b=b).items()}, step=0)

    with pytest.raises(ValueError, match=match):
        run()
    if b == B:
        with pytest.raises(ValueError, match=match):
            make_multiview_eval_step(model, S, mesh=mesh())


# ------------------------------------------------------------ the Trainer


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """One subject, 1 frame x 18 cameras at 32x32: 18 V-view samples."""
    root = str(tmp_path_factory.mktemp("mv_mesh_corpus"))
    write_synthetic_dataset(root, ["s00.h5"], n_frames=1, image_size=S, learnable=True)
    return root


def _trainer(tmp_path, corpus, variables, mesh):
    """A V-view Trainer on the CPU: 4 drop-last updates of 4 samples per
    epoch, test batches of 5 (5, 5, 5, 3: ragged over 2 replicas)."""
    train = MultiViewGazeDataset("xgaze", corpus, "bgr", ["s00.h5"], n_views=V, seed=0)
    test = MultiViewGazeDataset("mpiinv", corpus, "rgb", ["s00.h5"], n_views=V, seed=0)
    config = SimpleNamespace(mode="train", output_dir=str(tmp_path), ckpt_resume=None, print_freq=2, seed=0,
                             batch_size=4, epochs=1, save_epoch=99, image_size=S, scheduler_step="epoch",
                             num_views=V)
    return Trainer(config, _port(variables), _metrics(),
                   BatchLoader(train, batch_size=4, shuffle=True, drop_last=True), BatchLoader(test, batch_size=5),
                   device="cpu", mesh=mesh, init_state_dict=state_dict_from_jax(variables, **CFG))


def test_trainer_over_a_data_mesh(tmp_path, corpus, variables):
    """The V-view Trainer on (data 2) against the same Trainer without a
    mesh: ``test`` before training within 1e-4 deg, one epoch's losses at
    rtol 1e-4, ``test`` after it within 1e-4 deg."""
    runs = {}
    for name, mesh in (("unsharded", None), ("data2", make_mesh(["cpu"] * 2))):
        trainer = _trainer(tmp_path / name, corpus, variables, mesh)
        losses = []
        step_fn = trainer._train_step

        def recorded(batch, generator=None, *, step, step_fn=step_fn, losses=losses):
            stats = step_fn(batch, generator, step=step)
            losses.append(float(stats["loss_gaze"]))
            return stats

        trainer._train_step = recorded
        before = trainer.test(-1)
        trainer.train_one_epoch(0)
        runs[name] = (before, losses, trainer.test(0))
    (before, losses, after), (want_before, want_losses, want_after) = runs["data2"], runs["unsharded"]
    assert len(losses) == 4 and np.all(np.isfinite(losses))
    assert abs(before - want_before) <= 1e-4
    np.testing.assert_allclose(losses, want_losses, rtol=1e-4)
    assert abs(after - want_after) <= 1e-4
