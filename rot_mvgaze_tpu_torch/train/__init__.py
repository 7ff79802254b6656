from rot_mvgaze_tpu_torch.train.schedule import cyclic_triangular2
from rot_mvgaze_tpu_torch.train.steps import (
    augment_views,
    init_ema,
    make_eval_step,
    make_train_step,
    prepare_rotations,
    update_ema,
)
from rot_mvgaze_tpu_torch.train.trainer import Trainer, make_optimizer

__all__ = [
    "Trainer",
    "augment_views",
    "cyclic_triangular2",
    "init_ema",
    "make_eval_step",
    "make_optimizer",
    "make_train_step",
    "prepare_rotations",
    "update_ema",
]
