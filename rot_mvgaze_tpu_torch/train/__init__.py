from rot_mvgaze_tpu_torch.train.schedule import cyclic_triangular2
from rot_mvgaze_tpu_torch.train.steps import (
    augment_views,
    make_train_step,
    prepare_rotations,
)
from rot_mvgaze_tpu_torch.train.trainer import make_optimizer

__all__ = [
    "augment_views",
    "cyclic_triangular2",
    "make_optimizer",
    "make_train_step",
    "prepare_rotations",
]
