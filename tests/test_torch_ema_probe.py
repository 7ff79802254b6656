"""The port's EMA probe (rot_mvgaze_tpu_torch.probe_ema_benefit) on the
CPU against the JAX package: train_and_score, one epoch (3 updates) from the
same starting weights on the same batches (augment=False, pre-augmented
float views, as the step-trajectory tests in tests/test_torch_train.py run
them) at the probe's learning rate, against JAX's train step with ema_decay
and the JAX probe's scoring (make_eval_step and the mean angular error).
R18 with the probe's one fusion iteration, 32x32, batch 9. The command line
end to end at a tiny size, its decay bound and its record.

How the trajectories are held. Adam normalises each update element by
element (its first step is lr * g / (|g| + eps)), so a gradient element
that float32 rounding puts on either side of zero moves by +lr or -lr: two
float32 runs of the same three updates lie several percent apart however
close their gradients are, and no absolute bar of a few lr says anything.
So each leaf's update delta = theta_after - theta_start is held relative to
JAX's, |delta_port - delta_jax| / |delta_jax| <= UPDATE_BAR for the worst
leaf, parameters and moving average alike. Measured on the CPU by
tests/_torch_ema_noise.py (run it as a script): the port's float32 update
lies 0.053 (median leaf) / 0.084 (worst) from its own float64 update, JAX's
plain and Pallas routes 0.051 / 0.092 from each other, the port from JAX
0.12 / 0.20. The extra gap between the packages is one ReLU mask: a
layer2.0 output whose float64 value is -3.6e-7 comes out on the other side
of zero in JAX's float32 forward; opening that one element in the port's
float64 step brings its first gradient from 6.2e-3 (worst leaf) to 3.2e-5
of JAX's. A zeroed update lies 1 from JAX's, a sign-flipped one 2, training
on half of each batch 2.3 (test_update_bar_rejects_planted_faults).

The errors after the epoch are held at ERROR_BAR, above the float32 floor
(the port's float32 raw error lies 0.0087 deg from its float64 run's, JAX's
two routes 0.0038 deg apart) and well below what a zeroed update would miss
by (the raw error moves 0.52 deg in the epoch, the average 0.18 deg, both
checked); the scoring alone is held at 1e-3 deg on JAX's own final weights."""

import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rot_mvgaze_tpu.data import BatchLoader as JaxBatchLoader
from rot_mvgaze_tpu.data import GazeDataset as JaxGazeDataset
from rot_mvgaze_tpu.evaluate import evaluate_gaze as jax_evaluate_gaze
from rot_mvgaze_tpu.losses import IterationLoss as JaxIterationLoss
from rot_mvgaze_tpu.losses import StereoL1Loss as JaxStereoL1Loss
from rot_mvgaze_tpu.models import FeatRotationSymm as JaxFeatRotationSymm
from rot_mvgaze_tpu.train.steps import make_train_step as jax_make_train_step
from rot_mvgaze_tpu.train.trainer import TrainState
from rot_mvgaze_tpu.train.trainer import make_optimizer as jax_make_optimizer
from rot_mvgaze_tpu_torch import probe_ema_benefit
from rot_mvgaze_tpu_torch.compat import state_dict_from_jax
from rot_mvgaze_tpu_torch.data import BatchLoader, PackedGazeDataset, write_synthetic_corpus, write_synthetic_dataset
from rot_mvgaze_tpu_torch.evaluate import evaluate_gaze
from rot_mvgaze_tpu_torch.models import FeatRotationSymm

SIZE, BATCH = 32, 9


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test processes at once; two intra-op threads
    each keep torch from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


CFG = {"backbone_depth": 18, "num_iter": 1}  # the probe's model
LR = 3e-4  # the probe's default rate
DECAY = 0.9  # three updates move the average visibly
UPDATE_BAR = 0.5  # worst leaf, relative to JAX's update (see the module docstring)
ERROR_BAR = 0.02  # degrees, the errors after the epoch
BUFFER_BAR = 0.05  # worst running statistic, relative to JAX's change (measured 9.9e-3)


@pytest.fixture(scope="module")
def variables():
    """JAX variables of FeatRotationSymm(**CFG) at SIZE, as numpy."""
    data = {"img_0": jnp.zeros((2, SIZE, SIZE, 3)), "img_1": jnp.zeros((2, SIZE, SIZE, 3)),
            "rot_0": jnp.broadcast_to(jnp.eye(3), (2, 3, 3)), "rot_1": jnp.broadcast_to(jnp.eye(3), (2, 3, 3))}
    return jax.tree.map(np.asarray, jax.jit(JaxFeatRotationSymm(**CFG).init)(jax.random.PRNGKey(0), data))


def _port_model(variables):
    model = FeatRotationSymm(**CFG)
    model.load_state_dict(state_dict_from_jax(variables, **CFG), strict=True)
    return model


def _float_batches(seed, n=3):
    """One epoch of pre-augmented float views with poses and labels."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return [{
        "img_0": rng.normal(size=(BATCH, SIZE, SIZE, 3)).astype(f32),
        "img_1": rng.normal(size=(BATCH, SIZE, SIZE, 3)).astype(f32),
        "head_pose_0": rng.uniform(-0.5, 0.5, (BATCH, 2)).astype(f32),
        "head_pose_1": rng.uniform(-0.5, 0.5, (BATCH, 2)).astype(f32),
        "gt_gaze": rng.uniform(-0.5, 0.5, (BATCH, 2)).astype(f32),
        "gt_gaze_1": rng.uniform(-0.5, 0.5, (BATCH, 2)).astype(f32),
    } for _ in range(n)]


def _port_epoch(variables, batches, eval_loader):
    model = _port_model(variables)
    history, ema = probe_ema_benefit.train_and_score(
        model, batches, eval_loader, epochs=1, decay=DECAY, lr=LR, image_size=SIZE, seed=0, augment=False)
    return history, model, ema


@pytest.fixture(scope="module")
def held_out(tmp_path_factory):
    """The held-out learnable subject (2 frames, 36 pairs): an HDF5 archive
    for JAX, packs (the probe's own corpus route) for the port."""
    root = tmp_path_factory.mktemp("ema")
    names = write_synthetic_dataset(str(root / "h5"), ["e0.h5"], n_frames=2, image_size=SIZE,
                                    learnable=True, seed=77)
    write_synthetic_corpus(str(root / "packs"), names, n_frames=2, image_size=SIZE, learnable=True, seed=77)
    jax_loader = JaxBatchLoader(JaxGazeDataset("xgaze", str(root / "h5"), "bgr", names, seed=0),
                                batch_size=BATCH)
    port_loader = BatchLoader(PackedGazeDataset("xgaze", str(root / "packs"), "bgr", names, seed=0,
                                                use_native=False), batch_size=BATCH)
    return jax_loader, port_loader


@pytest.fixture(scope="module")
def ema_runs(variables, held_out):
    """One epoch (3 updates) of the JAX step with ema_decay, scored as the
    JAX probe scores, and the port's train_and_score on the same start and
    batches."""
    jax_loader, port_loader = held_out
    batches = _float_batches(seed=5)

    tx = jax_make_optimizer(lambda _t: LR)
    step = jax.jit(jax_make_train_step(
        JaxFeatRotationSymm(**CFG),
        JaxIterationLoss(loss=JaxStereoL1Loss(rel_weight=0.01), iter_decay=0.5), tx,
        image_size=SIZE, augment=False, ema_decay=DECAY))
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
                       opt_state=tx.init(params), ema_params=jax.tree.map(jnp.copy, params))
    for b in batches:
        state, _ = step(state, jax.tree.map(jnp.asarray, b), jax.random.PRNGKey(0))

    def jax_error(p, stats):  # the JAX probe's eval_error: make_eval_step, the mean angular error
        return jax_evaluate_gaze(JaxFeatRotationSymm(**CFG), {"params": p, "batch_stats": stats},
                                 jax_loader, image_size=SIZE)

    want = {"raw_deg": jax_error(state.params, state.batch_stats),
            "ema_deg": jax_error(state.ema_params, state.batch_stats),
            "start_deg": jax_error(variables["params"], variables["batch_stats"])}
    final = jax.tree.map(np.asarray, {"params": state.params, "batch_stats": state.batch_stats})
    jax_ema = state_dict_from_jax({"params": jax.tree.map(np.asarray, state.ema_params),
                                   "batch_stats": variables["batch_stats"]}, **CFG)
    history, model, ema = _port_epoch(variables, batches, port_loader)
    return want, final, jax_ema, history, model, ema


def update_gaps(got, want, start, buffers=False):
    """Per leaf, |(got - start) - (want - start)| / |want - start| (float64)
    over the parameters of the state dicts, or with ``buffers`` over the
    running statistics; a leaf that JAX's run left where it was must stay
    there bit for bit (gap 0, else infinity)."""
    gaps = {}
    for key, w in want.items():
        if ("running_" in key) != buffers or "num_batches" in key:
            continue
        s = start[key].double()
        dw, dg = w.double() - s, got[key].double() - s
        norm = float(dw.norm())
        if norm == 0.0:
            gaps[key] = 0.0 if torch.equal(dg, dw) else float("inf")
        else:
            gaps[key] = float((dg - dw).norm()) / norm
    return gaps


def _summary(gaps):
    worst = max(gaps, key=gaps.get)
    return f"median {np.median(list(gaps.values())):.3e}, worst {gaps[worst]:.3e} ({worst})"


def test_ema_probe_errors_match_jax(ema_runs):
    """Raw and moving-average errors after the epoch within ERROR_BAR of
    JAX's (measured 0.0068 deg raw, 1.2e-5 deg average, printed), and each
    moved from the start by more than the bar, so that an update that did
    nothing fails."""
    want, _, _, history, _, _ = ema_runs
    assert len(history) == 1 and history[0]["epoch"] == 1
    for key in ("raw_deg", "ema_deg"):
        print(f"{key}: port {history[0][key]:.8f}, JAX {want[key]:.8f}, start {want['start_deg']:.8f}")
        assert abs(history[0][key] - want[key]) <= ERROR_BAR, (key, history[0][key], want[key])
        assert abs(want[key] - want["start_deg"]) > 5 * ERROR_BAR, (key, want[key], want["start_deg"])
    assert history[0]["raw_deg"] != history[0]["ema_deg"]


def test_ema_probe_scores_jax_weights_as_jax(ema_runs, held_out):
    """The probe's scoring alone (evaluate_gaze on the raw weights, and with
    params= on the average) over the packs, on JAX's own final weights,
    within 1e-3 deg of JAX's scores over the archive."""
    want, final, jax_ema, _, _, _ = ema_runs
    _, port_loader = held_out
    model = _port_model(final)
    raw = evaluate_gaze(model, port_loader, image_size=SIZE)
    avg = evaluate_gaze(model, port_loader, image_size=SIZE,
                        params={n: jax_ema[n].contiguous() for n, _ in model.named_parameters()})
    print(f"JAX's weights scored by the port: raw {raw:.8f} ({want['raw_deg']:.8f}), "
          f"average {avg:.8f} ({want['ema_deg']:.8f})")
    assert abs(raw - want["raw_deg"]) <= 1e-3 and abs(avg - want["ema_deg"]) <= 1e-3


def test_ema_probe_weights_match_jax(ema_runs, variables):
    """Every parameter's update, and the average's, within UPDATE_BAR of
    JAX's relative to JAX's (median and worst printed); the running
    statistics' change within BUFFER_BAR of JAX's, relative to it (no
    optimizer between the batch and them)."""
    _, final, jax_ema, _, model, ema = ema_runs
    start = state_dict_from_jax(variables, **CFG)
    want = state_dict_from_jax(final, **CFG)
    got = model.state_dict()
    for name, gaps, bar in (("parameters", update_gaps(got, want, start), UPDATE_BAR),
                            ("average", update_gaps(ema, {k: jax_ema[k] for k in ema}, start), UPDATE_BAR),
                            ("running statistics", update_gaps(got, want, start, buffers=True), BUFFER_BAR)):
        print(f"{name}: update gap to JAX's, {_summary(gaps)}")
        bad = {k: v for k, v in gaps.items() if not v <= bar}
        assert not bad, (name, bad)


@pytest.mark.parametrize("fault", ["zeroed", "sign_flipped", "half_batch"])
def test_update_bar_rejects_planted_faults(ema_runs, variables, held_out, fault):
    """The update bar is not vacuous: an update that did nothing, one in the
    opposite direction, and the port trained on every other row of each
    batch each lie past UPDATE_BAR from JAX's update."""
    _, final, _, _, _, _ = ema_runs
    start = state_dict_from_jax(variables, **CFG)
    want = state_dict_from_jax(final, **CFG)
    if fault == "zeroed":
        got = start
    elif fault == "sign_flipped":
        got = {k: 2 * start[k].double() - want[k].double() for k in want}
    else:
        half = [{k: v[0::2] for k, v in b.items()} for b in _float_batches(seed=5)]
        got = _port_epoch(variables, half, held_out[1])[1].state_dict()
    gaps = update_gaps(got, want, start)
    print(f"{fault}: update gap to JAX's, {_summary(gaps)}")
    assert max(gaps.values()) > UPDATE_BAR


def test_ema_probe_command_line(tmp_path, capsys):
    out = str(tmp_path / "ema.json")
    rc = probe_ema_benefit.main(["--epochs", "2", "--frames", "2", "--batch", "24", "--image-size", "32",
                                 "--out", out, "--device", "cpu"])
    assert rc == 0
    with open(out) as f:
        record = json.load(f)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == record
    assert (record["decay"], record["epochs"], record["train_rows"], record["eval_rows"]) == (0.98, 2, 72, 36)
    assert [h["epoch"] for h in record["history"]] == [1, 2]
    last = record["history"][-1]
    assert (record["final_raw_deg"], record["final_ema_deg"]) == (last["raw_deg"], last["ema_deg"])
    assert record["ema_better_final"] == (last["ema_deg"] < last["raw_deg"])
    assert record["ema_better_best"] == (min(h["ema_deg"] for h in record["history"])
                                        < min(h["raw_deg"] for h in record["history"]))
    assert record["device"] == "cpu"


@pytest.mark.parametrize("argv", [["--decay", "0"], ["--decay", "1.0"], ["--decay", "-0.5"], ["--epochs", "0"]])
def test_ema_probe_refuses_bad_arguments(argv, capsys):
    """(0, 1) for the decay, as the JAX probe: 0 scores the raw weights
    twice, 1 the initial ones."""
    with pytest.raises(SystemExit) as e:
        probe_ema_benefit.main([*argv, "--device", "cpu"])
    assert e.value.code == 2
    assert ("--decay must be in (0, 1)" if "--decay" in argv else "--epochs must be >= 1") in capsys.readouterr().err


def test_ema_probe_record_rounds_as_jax():
    args = SimpleNamespace(decay=0.98, epochs=2)
    history = [{"epoch": 1, "raw_deg": 10.00049, "ema_deg": 12.0}, {"epoch": 2, "raw_deg": 9.0, "ema_deg": 8.99951}]
    record = probe_ema_benefit.make_record(args, history, 10, 5, torch.device("cpu"))
    assert record["history"] == [{"epoch": 1, "raw_deg": 10.0, "ema_deg": 12.0},
                                 {"epoch": 2, "raw_deg": 9.0, "ema_deg": 9.0}]
    assert record["ema_better_final"] is False and record["ema_better_best"] is False
    assert (record["train_rows"], record["eval_rows"], record["device"]) == (10, 5, "cpu")
