"""The port's Trainer (rot_mvgaze_tpu_torch.train.Trainer) on the CPU: R18,
2 fusion iterations, 32x32, a learnable synthetic corpus. Its evaluation
against the JAX Trainer's from the same initial weights; training,
checkpoints and resume against the port's own uninterrupted runs (in
float32 on the CPU, step-exact means bit for bit)."""

import os
import shutil
import signal
import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from rot_mvgaze_tpu.data import BatchLoader as JaxBatchLoader
from rot_mvgaze_tpu.data import GazeDataset as JaxGazeDataset
from rot_mvgaze_tpu.losses import IterationLoss as JaxIterationLoss
from rot_mvgaze_tpu.losses import StereoL1Loss as JaxStereoL1Loss
from rot_mvgaze_tpu.models import FeatRotationSymm as JaxFeatRotationSymm
from rot_mvgaze_tpu.train import Trainer as JaxTrainer
from rot_mvgaze_tpu.train.checkpoints import save_state as jax_save_state
from rot_mvgaze_tpu_torch.compat import load_checkpoint, read_checkpoint, state_dict_from_jax
from rot_mvgaze_tpu_torch.data import BatchLoader, GazeDataset, write_synthetic_dataset
from rot_mvgaze_tpu_torch.evaluate import evaluate_gaze
from rot_mvgaze_tpu_torch.losses import IterationLoss, StereoL1Loss
from rot_mvgaze_tpu_torch.models import FeatRotationSymm
from rot_mvgaze_tpu_torch.serving import GazePredictor
from rot_mvgaze_tpu_torch.train import Trainer, make_train_step
from rot_mvgaze_tpu_torch.train.checkpoints import find_latest_checkpoint, save_state

CFG = {"backbone_depth": 18, "num_iter": 2}
SIZE = 32


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test processes at once; two intra-op threads
    each keep torch from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _remove_outputs(tmp_path):
    """A checkpoint of this model with Adam's state is about 380 MB: each
    test's outputs go when it ends, rather than stay with pytest's kept
    temporary directories."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """One subject, 2 frames x 18 cameras: 36 pairs, 6 drop-last batches of 6."""
    root = str(tmp_path_factory.mktemp("trainer_corpus"))
    write_synthetic_dataset(root, ["s00.h5"], n_frames=2, image_size=SIZE, learnable=True)
    return root


def _loaders(root, batch_size=6):
    """Fresh loaders, as a fresh process has them (epoch counters at 0)."""
    train = GazeDataset("xgaze", root, "bgr", ["s00.h5"], seed=0)
    test = GazeDataset("mpiinv", root, "rgb", ["s00.h5"], seed=0)
    return (BatchLoader(train, batch_size=batch_size, shuffle=True, drop_last=True),
            BatchLoader(test, batch_size=8))


def _config(tmp_path, **overrides):
    cfg = dict(mode="train", output_dir=str(tmp_path / "logs"), ckpt_resume=None, print_freq=2,
               seed=0, batch_size=6, epochs=2, save_epoch=99, image_size=SIZE,
               scheduler_step="epoch")
    cfg.update(overrides)
    return SimpleNamespace(**cfg)


def _metrics():
    return IterationLoss(StereoL1Loss(rel_weight=0.01), iter_decay=0.5)


def _trainer(tmp_path, root, state=None, batch_size=6, **overrides):
    """A CPU Trainer over fresh loaders from fixed initial weights."""
    torch.manual_seed(0)
    return Trainer(_config(tmp_path, batch_size=batch_size, **overrides),
                   FeatRotationSymm(**CFG), _metrics(), *_loaders(root, batch_size),
                   device="cpu", init_state_dict=state)


def _record_losses(trainer):
    """Wrap the trainer's step so that each update's loss is kept, by step."""
    losses = {}
    step_fn = trainer._train_step

    def recorded(batch, generator=None, *, step):
        stats = step_fn(batch, generator, step=step)
        losses[step] = float(stats["loss_gaze"])
        return stats

    trainer._train_step = recorded
    return losses


def _assert_same_state(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    assert a.step == b.step


def test_test_matches_the_jax_trainer(tmp_path, corpus):
    """Trainer.test(-1) from the JAX Trainer's initial weights, within
    1e-4 deg of the JAX Trainer's own test(-1)."""
    jax_loaders = (
        JaxBatchLoader(JaxGazeDataset("xgaze", corpus, "bgr", ["s00.h5"], seed=0), 6, shuffle=True,
                       drop_last=True),
        JaxBatchLoader(JaxGazeDataset("mpiinv", corpus, "rgb", ["s00.h5"], seed=0), 8),
    )
    jax_trainer = JaxTrainer(_config(tmp_path / "jax"), JaxFeatRotationSymm(**CFG),
                             JaxIterationLoss(loss=JaxStereoL1Loss(rel_weight=0.01), iter_decay=0.5),
                             *jax_loaders)
    want = jax_trainer.test(-1)
    variables = jax.tree.map(np.asarray, {"params": jax_trainer.state.params,
                                          "batch_stats": jax_trainer.state.batch_stats})
    trainer = _trainer(tmp_path / "port", corpus, state=state_dict_from_jax(variables, **CFG))
    got = trainer.test(-1)
    assert abs(got - want) < 1e-4, (got, want)
    print(f"Trainer.test(-1): port {got:.8f} deg, JAX {want:.8f} deg")
    with open(os.path.join(trainer.output_dir, "test_results.txt")) as f:
        assert float(f.read().strip().split("error: ")[1]) == pytest.approx(got)
    detail = trainer.test_breakdown()
    assert detail["mean_error"] == got and detail["n"] == 36
    assert sum(s["n"] for s in detail["per_camera"].values()) == 36
    assert detail["per_subject"] == {0: {"error": got, "n": 36}}


def test_one_epoch_runs_and_the_loss_falls_on_an_overfit(tmp_path, corpus):
    trainer = _trainer(tmp_path, corpus, scheduler_step="iteration")
    trainer.train_one_epoch(0)
    assert trainer.step == len(trainer.train_loader) == 6
    assert trainer.train_loader.epoch == 1
    tb = os.path.join(trainer.output_dir, "tensorboard")
    assert any(f.startswith("events.out.tfevents") for f in os.listdir(tb))
    assert os.path.exists(os.path.join(trainer.output_dir, "config.yaml"))
    # the same batch and the same draws, 10 updates on the Trainer's schedule
    step = make_train_step(trainer.model, _metrics(), trainer.optimizer, image_size=SIZE,
                           schedule=trainer.schedule)
    batch = {k: torch.from_numpy(v) for k, v in next(iter(trainer.train_loader)).items()}
    losses = [float(step(batch, torch.Generator().manual_seed(0), step=i)["loss_gaze"])
              for i in range(10)]
    assert losses[-1] < losses[0], losses


def test_checkpoint_round_trip(tmp_path, corpus):
    """A saved state restores the weights, Adam's state and the step exactly,
    whatever the file's name; the state dict loads strictly into
    GazePredictor."""
    trainer = _trainer(tmp_path, corpus)
    trainer.train_one_epoch(0)
    path = trainer.save_checkpoint(add="unit")
    assert path.endswith("unit.pth.tar")
    renamed = str(tmp_path / "weights.bin")
    os.replace(path, renamed)
    again = _trainer(tmp_path / "again", corpus, ckpt_resume=renamed)
    _assert_same_state(trainer, again)
    a, b = trainer.optimizer.state_dict(), again.optimizer.state_dict()
    assert a["param_groups"] == b["param_groups"]
    for i, state in a["state"].items():
        for k, v in state.items():
            assert torch.equal(v, b["state"][i][k]), (i, k)
    GazePredictor(renamed, backbone_depth=18, num_iter=2, image_size=SIZE, dtype=torch.float32,
                  device="cpu")


@pytest.mark.parametrize("stop_at", [None, 8], ids=["at_epoch_boundary", "mid_epoch"])
def test_resume_is_step_exact(tmp_path, corpus, stop_at):
    """Train 2 epochs straight; then stop after epoch 1 (a save) or after
    update 8 (a preemption save, mid-epoch) and resume from a fresh process's
    loaders: the resumed updates' losses and the final state are bit for bit
    the uninterrupted run's."""
    full = _trainer(tmp_path / "full", corpus)
    full_losses = _record_losses(full)
    full_error = full.train()
    assert full.step == 12

    first = _trainer(tmp_path / "first", corpus)
    if stop_at is None:
        first.train_one_epoch(0)
        path = first.save_checkpoint(add="after_epoch_1")
    else:
        first._preempt_requested = lambda: first.step >= stop_at
        assert np.isnan(first.train())
        path = os.path.join(first.ckpt_dir, "preempt_epoch_01.pth.tar")
    done = first.step
    meta = read_checkpoint(path)["epoch_meta"]
    assert meta == {"epochs_done": done // 6, "epoch_step": done % 6, "steps_per_epoch": 6}

    resumed = _trainer(tmp_path / "resumed", corpus, ckpt_resume=path)
    assert resumed.step == done and resumed.train_loader.epoch == done // 6
    losses = _record_losses(resumed)
    error = resumed.train()
    assert sorted(losses) == list(range(done, 12))
    for s, loss in losses.items():
        assert loss == full_losses[s], s
    _assert_same_state(full, resumed)
    assert error == full_error


def test_changed_batching_restarts_the_interrupted_epoch(tmp_path, corpus, capsys):
    first = _trainer(tmp_path, corpus)
    first._preempt_requested = lambda: first.step >= 2
    first.train()
    path = os.path.join(first.ckpt_dir, "preempt_epoch_00.pth.tar")
    resumed = _trainer(tmp_path / "r", corpus, batch_size=4, ckpt_resume=path)
    assert resumed._start_epoch == 0 and resumed._start_batch == 0
    assert "steps_per_epoch changed" in capsys.readouterr().out


def test_keep_last_n(tmp_path, corpus):
    trainer = _trainer(tmp_path, corpus, keep_last_n=2)
    for i in range(4):
        trainer.save_checkpoint(add=f"epoch_{i:02d}")
        time.sleep(0.02)
    assert sorted(os.listdir(trainer.ckpt_dir)) == ["epoch_02.pth.tar", "epoch_03.pth.tar"]
    assert find_latest_checkpoint(trainer.ckpt_dir).endswith("epoch_03.pth.tar")


def test_auto_resume_picks_the_latest_and_test_mode_needs_a_checkpoint(tmp_path, corpus):
    """The newest by mtime of the port's .pth.tar and the JAX package's
    .msgpack, in a directory of either or of both; a temporary file of
    either writer (``<name>.tmp.<pid>``) is never taken. The next update
    from a JAX run's directory against JAX's own:
    tests/test_torch_checkpoint_interop.py::test_auto_resume_over_jax_checkpoints."""
    trainer = _trainer(tmp_path, corpus)
    trainer.save_checkpoint(add="old")
    time.sleep(0.02)
    newest = trainer.save_checkpoint(add="new")
    assert _trainer(tmp_path / "a", corpus, auto_resume_dir=trainer.ckpt_dir)._resume_path == newest
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError, match="pth.tar"):
        _trainer(tmp_path / "b", corpus, mode="test", auto_resume_dir=str(empty))
    with pytest.raises(ValueError, match="weights_only contradicts auto_resume_dir"):
        _trainer(tmp_path / "c", corpus, weights_only=True, auto_resume_dir=trainer.ckpt_dir)

    # a directory of the JAX package's checkpoints alone
    data = {"img_0": np.zeros((2, SIZE, SIZE, 3), np.float32), "img_1": np.zeros((2, SIZE, SIZE, 3), np.float32),
            "rot_0": np.broadcast_to(np.eye(3, dtype=np.float32), (2, 3, 3)),
            "rot_1": np.broadcast_to(np.eye(3, dtype=np.float32), (2, 3, 3))}
    variables = jax.tree.map(np.asarray, JaxFeatRotationSymm(**CFG).init(jax.random.PRNGKey(3), data))
    jax_dir = tmp_path / "jax_ckpt"
    jax_save_state(str(jax_dir / "epoch_01.msgpack"), variables)
    time.sleep(0.02)
    jax_newest = jax_save_state(str(jax_dir / "epoch_02.msgpack"), variables)
    time.sleep(0.02)
    (jax_dir / "epoch_03.msgpack.tmp.123").write_bytes(b"a save cut short")
    resumed = _trainer(tmp_path / "d", corpus, mode="test", auto_resume_dir=str(jax_dir))
    assert resumed._resume_path == jax_newest
    want = state_dict_from_jax(variables, **CFG)
    for key, value in resumed.model.state_dict().items():
        assert torch.equal(value, want[key]), key
    # a mixed directory: the newer of either kind, whatever the suffix
    time.sleep(0.02)
    port_newest = trainer.save_checkpoint(add="newer")
    os.link(port_newest, jax_dir / "newer.pth.tar")  # the same file, its mtime kept
    (jax_dir / "newest.pth.tar.tmp.456").write_bytes(b"a save cut short")
    assert _trainer(tmp_path / "e", corpus, auto_resume_dir=str(jax_dir))._resume_path == \
        str(jax_dir / "newer.pth.tar")
    time.sleep(0.02)
    jax_last = jax_save_state(str(jax_dir / "epoch_04.msgpack"), {"step": np.int32(4)})
    assert find_latest_checkpoint(str(jax_dir)) == jax_last


def test_weights_only_warm_start_keeps_a_fresh_optimizer(tmp_path, corpus):
    trainer = _trainer(tmp_path, corpus)
    trainer.train_one_epoch(0)
    path = trainer.save_checkpoint(add="w")
    warm = _trainer(tmp_path / "w", corpus, ckpt_resume=path, weights_only=True)
    assert warm.step == 0 and warm._start_epoch == 0 and not warm.optimizer.state
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(v, warm.model.state_dict()[k]), k


def test_sigterm_saves_at_the_next_step_boundary(tmp_path, corpus):
    trainer = _trainer(tmp_path, corpus, epochs=1)
    test = trainer.test

    def test_then_signal(epoch):
        err = test(epoch)
        os.kill(os.getpid(), signal.SIGTERM)
        return err

    trainer.test = test_then_signal
    assert np.isnan(trainer.train())
    assert trainer.step == 0
    assert os.listdir(trainer.ckpt_dir) == ["preempt_epoch_00.pth.tar"]
    assert signal.getsignal(signal.SIGTERM) is not None  # the previous handler is back


def test_bf16_training_evaluates_in_float32(tmp_path, corpus):
    """A bf16 Trainer trains under bf16 autocast; its test() equals that of
    a float32 Trainer holding the same weights."""
    t16 = _trainer(tmp_path / "bf16", corpus, bf16=True, epochs=1)
    losses = _record_losses(t16)
    t16.train_one_epoch(0)
    assert t16.compute_dtype == torch.bfloat16 and len(losses) == 6
    assert all(np.isfinite(list(losses.values())))
    t32 = _trainer(tmp_path / "f32", corpus, state=t16.model.state_dict())
    assert t16.test(0) == t32.test(0)


def test_ema_is_evaluated_saved_and_preferred_by_weight_loaders(tmp_path, corpus):
    trainer = _trainer(tmp_path, corpus, ema_decay=0.5)
    trainer.train_one_epoch(0)
    params = dict(trainer.model.named_parameters())
    key = "_gaze_estimators.1.blocks.1.0.weight"
    assert not torch.equal(trainer.ema[key], params[key])
    ema_error = trainer.test(0)
    twin = FeatRotationSymm(**CFG).to(memory_format=torch.channels_last)  # the Trainer's layout
    twin.load_state_dict({**trainer.model.state_dict(), **trainer.ema})
    assert ema_error == evaluate_gaze(twin, trainer.test_loader, image_size=SIZE)
    path = trainer.save_checkpoint(add="ema")
    sd = load_checkpoint(path)
    assert torch.equal(sd[key], trainer.ema[key])
    # test mode keeps the stored average for evaluation; a training resume
    # without ema_decay drops it
    tested = _trainer(tmp_path / "t", corpus, mode="test", ckpt_resume=path)
    assert tested.test(0) == ema_error
    assert _trainer(tmp_path / "d", corpus, ckpt_resume=path).ema is None
    resumed = _trainer(tmp_path / "e", corpus, ckpt_resume=path, ema_decay=0.5)
    assert torch.equal(resumed.ema[key], trainer.ema[key])


@pytest.mark.parametrize("option", [{"grad_accum": 2}, {"freeze_bn": True}], ids=["grad_accum", "freeze_bn"])
def test_trainer_step_options(tmp_path, corpus, option):
    """grad_accum and freeze_bn through the Trainer: one epoch runs; under
    freeze_bn every BatchNorm buffer is unchanged bit for bit."""
    trainer = _trainer(tmp_path, corpus, **option)
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    trainer.train_one_epoch(0)
    assert trainer.step == 6
    after = trainer.model.state_dict()
    buffers = [k for k in after if "running_" in k or "num_batches_tracked" in k]
    unchanged = all(torch.equal(after[k], before[k]) for k in buffers)
    assert unchanged == ("freeze_bn" in option)


def test_trainer_checks_its_configuration(tmp_path, corpus):
    with pytest.raises(ValueError, match="divisible by grad_accum"):
        _trainer(tmp_path, corpus, grad_accum=4)
    root = corpus
    torch.manual_seed(0)
    ragged = BatchLoader(GazeDataset("xgaze", root, "bgr", ["s00.h5"]), batch_size=6)
    with pytest.raises(ValueError, match="drop_last"):
        Trainer(_config(tmp_path, grad_accum=2), FeatRotationSymm(**CFG), _metrics(), ragged,
                None, device="cpu")
    with pytest.raises(ValueError, match="ema_decay"):
        _trainer(tmp_path, corpus, ema_decay=1.5)
    with pytest.raises(ValueError, match="scheduler_step"):
        _trainer(tmp_path, corpus, scheduler_step="step")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Trainer(_config(tmp_path), FeatRotationSymm(**CFG), _metrics())


def test_checkpoint_files_are_written_atomically(tmp_path):
    """A failed save leaves the previous file whole and no temporary file; a
    temporary name never matches the checkpoint glob; the format is told by
    the contents, not the name: a truncated msgpack under a .pth.tar name
    raises in the msgpack reader, and a file of neither format is refused."""
    path = str(tmp_path / "ckpt.pth.tar")
    save_state(path, {"a": torch.arange(4)})
    before = open(path, "rb").read()
    with pytest.raises(Exception):
        save_state(path, {"a": lambda: None})
    assert open(path, "rb").read() == before
    assert os.listdir(tmp_path) == ["ckpt.pth.tar"]
    assert torch.equal(read_checkpoint(path)["a"], torch.arange(4))
    (tmp_path / "ckpt.pth.tar.tmp.123").write_bytes(b"partial")
    assert find_latest_checkpoint(str(tmp_path)) == path
    msgpack = tmp_path / "jax.pth.tar"
    msgpack.write_bytes(b"\x85\xa4step\x03")
    with pytest.raises(ValueError, match="truncated msgpack"):
        read_checkpoint(str(msgpack))
    other = tmp_path / "other.pth.tar"
    other.write_bytes(b"\x00\x01not a checkpoint")
    with pytest.raises(ValueError, match="not a torch.save file"):
        read_checkpoint(str(other))
