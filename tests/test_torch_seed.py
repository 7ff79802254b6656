"""set_seed (rot_mvgaze_tpu_torch.utils.seed): it sets the reference's cuDNN
flags (cudnn.deterministic on, cudnn.benchmark off), which make seeded
training repeat on the card, and a seeded Trainer update run twice on the
CPU is bit for bit the same (weights, Adam's moments, running statistics),
while another seed gives another update."""

from types import SimpleNamespace

import pytest
import torch

from rot_mvgaze_tpu_torch.data import BatchLoader, InMemoryGazeDataset
from rot_mvgaze_tpu_torch.losses import IterationLoss, StereoL1Loss
from rot_mvgaze_tpu_torch.models import FeatRotationSymm
from rot_mvgaze_tpu_torch.train import Trainer
from rot_mvgaze_tpu_torch.utils.seed import set_seed

SIZE = 32


@pytest.fixture(autouse=True)
def _restore_cudnn_flags():
    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
    torch.set_num_threads(threads)


def test_set_seed_sets_the_cudnn_flags():
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = False, True
    gen = set_seed(3, "cpu")
    assert torch.backends.cudnn.deterministic is True
    assert torch.backends.cudnn.benchmark is False
    assert gen.initial_seed() == 3


def _one_update(tmp_path, seed):
    """One Trainer update (R18 x 1, 32x32, the 18 pairs of one synthetic
    frame in one batch) after the flags were set the other way: the model's
    state, Adam's state and the flags the Trainer left."""
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = False, True
    set_seed(seed, "cpu")
    model = FeatRotationSymm(backbone_depth=18, num_iter=1)
    data = InMemoryGazeDataset(1, n_frames=1, image_size=SIZE, seed=0, learnable=True)
    cfg = SimpleNamespace(mode="train", output_dir=str(tmp_path / f"seed{seed}"), ckpt_resume=None,
                          print_freq=10**9, seed=seed, batch_size=18, epochs=1, save_epoch=99,
                          image_size=SIZE, scheduler_step="iteration", base_lr=1e-4, max_lr=1e-3)
    trainer = Trainer(cfg, model, IterationLoss(StereoL1Loss(rel_weight=0.01), iter_decay=0.5),
                      BatchLoader(data, batch_size=18, shuffle=True, drop_last=True), None, device="cpu")
    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    trainer.train_one_epoch(0)
    assert trainer.step == 1
    moments = {(i, k): v.clone() for i, s in enumerate(trainer.optimizer.state.values())
               for k, v in s.items()}
    return {k: v.clone() for k, v in trainer.model.state_dict().items()}, moments, flags


def test_seeded_trainer_update_repeats_bit_for_bit(tmp_path):
    state_a, adam_a, flags = _one_update(tmp_path, seed=0)
    state_b, adam_b, _ = _one_update(tmp_path, seed=0)
    assert flags == (True, False)  # the Trainer seeds through set_seed
    assert state_a.keys() == state_b.keys() and adam_a.keys() == adam_b.keys()
    assert all(torch.equal(state_a[k], state_b[k]) for k in state_a)
    assert all(torch.equal(adam_a[k], adam_b[k]) for k in adam_a)
    state_c, _, _ = _one_update(tmp_path, seed=1)
    assert not all(torch.equal(state_a[k], state_c[k]) for k in state_a)  # the seed reaches the update
