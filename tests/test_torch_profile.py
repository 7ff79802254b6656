"""--profile_steps / --profile_dir in the port's Trainer on the CPU,
mirroring tests/test_trainer.py::TestProfilerCapture: one torch.profiler
trace of the N train steps after the first, written once per run, and the
command line's error for --profile_dir without --profile_steps."""

import json
import os
from types import SimpleNamespace

import pytest
import torch

from rot_mvgaze_tpu_torch.cli import main as cli
from rot_mvgaze_tpu_torch.data import BatchLoader, GazeDataset, write_synthetic_dataset
from rot_mvgaze_tpu_torch.losses import IterationLoss, StereoL1Loss
from rot_mvgaze_tpu_torch.models import FeatRotationSymm
from rot_mvgaze_tpu_torch.train import Trainer

SIZE = 32


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """One subject, 1 frame x 18 cameras: 18 pairs, 3 drop-last batches of 6."""
    root = str(tmp_path_factory.mktemp("profile_corpus"))
    write_synthetic_dataset(root, ["s00.h5"], n_frames=1, image_size=SIZE, learnable=True)
    return root


def _trainer(tmp_path, root, **overrides):
    config = SimpleNamespace(mode="train", output_dir=str(tmp_path / "out"), epochs=2, save_epoch=10,
                             print_freq=100, seed=0, image_size=SIZE, bf16=False, **overrides)
    ds = GazeDataset("xgaze", root, "bgr", ["s00.h5"], stereo=True)
    torch.manual_seed(0)
    return Trainer(config, FeatRotationSymm(backbone_depth=18, num_iter=1),
                   IterationLoss(StereoL1Loss(rel_weight=0.01, reference_decay=1.0), iter_decay=0.5),
                   BatchLoader(ds, 6, shuffle=True, drop_last=True, num_threads=1),
                   BatchLoader(ds, 9, num_threads=1), device="cpu")


def _files(d):
    return sorted(os.path.join(p, f) for p, _, fs in os.walk(d) for f in fs)


def test_profile_steps_captures_one_trace(tmp_path, corpus, capsys):
    """profile_steps 2: one Chrome trace in <output_dir>/profile holding the
    second and third updates (two optimizer steps; the first update, which
    pays the start-up, is outside), printed with its path; the second epoch
    opens no second capture."""
    trainer = _trainer(tmp_path, corpus, profile_steps=2)
    trainer.train_one_epoch(0)
    profile_dir = os.path.join(trainer.output_dir, "profile")
    files = _files(profile_dir)
    assert files == [os.path.join(profile_dir, "trace.json")] == [trainer.profile_trace]
    assert f"profiler trace of 2 train step(s) saved to {files[0]}" in capsys.readouterr().out
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events]
    assert sum(n.startswith("Optimizer.step#Adam.step") for n in names) == 2
    assert any("batch_norm" in n or "bn_" in n or "convolution" in n for n in names)
    trainer.train_one_epoch(1)
    assert _files(profile_dir) == files


def test_profile_dir_takes_the_trace(tmp_path, corpus):
    trainer = _trainer(tmp_path, corpus, profile_steps=1, profile_dir=str(tmp_path / "traces"))
    trainer.train_one_epoch(0)
    assert _files(tmp_path / "traces") == [str(tmp_path / "traces" / "trace.json")]


def test_a_window_longer_than_the_epoch_closes_with_it(tmp_path, corpus, capsys):
    """3 updates an epoch, the window from the second: profile_steps 5
    closes after 2 at the epoch's end, as the JAX Trainer does."""
    trainer = _trainer(tmp_path, corpus, profile_steps=5)
    trainer.train_one_epoch(0)
    assert "profiler trace of 2 train step(s)" in capsys.readouterr().out
    assert trainer.profile_trace is not None


def test_profile_dir_needs_profile_steps(tmp_path, corpus):
    """The command line's parser error (as JAX's), and the Trainer's own."""
    with pytest.raises(SystemExit) as e:
        cli.main(["--mode", "train", "--exp_name", "mpiinv_known", "--output_dir", str(tmp_path),
                  "--profile_dir", str(tmp_path / "trace"), "--device", "cpu"])
    assert e.value.code == 2
    with pytest.raises(ValueError, match="profile_dir needs profile_steps"):
        _trainer(tmp_path, corpus, profile_dir=str(tmp_path / "trace"))
