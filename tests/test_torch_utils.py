"""The port's utils (rot_mvgaze_tpu_torch.utils) against the JAX package's
where both compute the same thing, on the CPU."""

import math
import random
import warnings

import numpy as np
import pytest
import torch

from rot_mvgaze_tpu.train.tb import make_image_grid as jax_make_image_grid
from rot_mvgaze_tpu.utils.helper import StreamingStats as JaxStreamingStats
from rot_mvgaze_tpu_torch.models import FeatRotationSymm
from rot_mvgaze_tpu_torch.train.tb import SummaryWriter, make_image_grid
from rot_mvgaze_tpu_torch.utils.helper import AverageMeter, StreamingStats
from rot_mvgaze_tpu_torch.utils.profiling import StepTimer
from rot_mvgaze_tpu_torch.utils.seed import set_seed
from rot_mvgaze_tpu_torch.utils.summary import count_parameters, parameter_table


def test_streaming_stats_match_jax():
    rng = np.random.default_rng(0)
    ours, theirs = AverageMeter(), JaxStreamingStats()
    assert AverageMeter is StreamingStats
    for v, n in zip(rng.normal(size=200), rng.integers(1, 5, 200)):
        ours.update(v, int(n))
        theirs.update(v, int(n))
    assert (ours.val, ours.avg, ours.count, ours.min, ours.max, ours.sum) == (
        theirs.val, theirs.avg, theirs.count, theirs.min, theirs.max, theirs.sum)
    ours.reset()
    assert ours.count == 0 and ours.min == math.inf


def test_set_seed_seeds_every_host_generator():
    gen = set_seed(7, device="cpu")
    assert isinstance(gen, torch.Generator) and gen.initial_seed() == 7
    draws = (random.random(), np.random.rand(), torch.rand(1).item())
    set_seed(7, device="cpu")
    assert draws == (random.random(), np.random.rand(), torch.rand(1).item())


def test_parameter_summary_counts_shared_parameters_once():
    model = FeatRotationSymm(backbone_depth=18, num_iter=2)
    total = sum(p.numel() for p in model.parameters())
    assert count_parameters(model) == total
    table = parameter_table(model)
    assert f"{total:,}" in table.splitlines()[-2]
    assert "_feat_extractor" in table and "_img_fusers" in table
    shared = FeatRotationSymm(backbone_depth=18, num_iter=3, share_weights=True)
    assert count_parameters(shared) < count_parameters(FeatRotationSymm(backbone_depth=18, num_iter=3))


def test_step_timer_fences_and_warns_once_without_a_result():
    timer = StepTimer(items_per_step=10)
    for _ in range(2):
        timer.start()
        assert timer.stop({"loss": torch.zeros(())}) >= 0
    assert timer.meter.count == 2 and timer.items_per_second > 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for _ in range(2):
            timer.start()
            timer.stop()
    assert len(caught) == 1
    with pytest.raises(RuntimeError, match="without start"):
        timer.stop(torch.zeros(()))


def test_image_grid_and_event_file_match_jax(tmp_path):
    images = np.random.default_rng(0).normal(size=(6, 8, 8, 3)).astype(np.float32)
    np.testing.assert_array_equal(make_image_grid(images), jax_make_image_grid(images))
    writer = SummaryWriter(str(tmp_path))
    writer.add_scalar("train/loss", 0.5, 3)
    writer.add_image("train/images", make_image_grid(images), 3)
    writer.close()
    (event,) = tmp_path.iterdir()
    assert event.name.startswith("events.out.tfevents") and event.stat().st_size > 100
