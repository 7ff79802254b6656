from rot_mvgaze_tpu_torch.losses.gaze import (
    gaze_angular_loss,
    gaze_l1_loss,
    gaze_l2_loss,
    make_gaze_loss,
)
from rot_mvgaze_tpu_torch.losses.multiview import MultiViewL1Loss
from rot_mvgaze_tpu_torch.losses.stereo import IterationLoss, StereoL1Loss

__all__ = [
    "IterationLoss",
    "MultiViewL1Loss",
    "StereoL1Loss",
    "gaze_angular_loss",
    "gaze_l1_loss",
    "gaze_l2_loss",
    "make_gaze_loss",
]
