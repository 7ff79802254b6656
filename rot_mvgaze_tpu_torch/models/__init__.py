from rot_mvgaze_tpu_torch.models.blocks import Mlp
from rot_mvgaze_tpu_torch.models.multiview import FeatRotationMultiView
from rot_mvgaze_tpu_torch.models.norm import IntensityBatchNorm
from rot_mvgaze_tpu_torch.models.resnet import BACKBONES, ResNet
from rot_mvgaze_tpu_torch.models.rot_mv import FeatRotationSymm
from rot_mvgaze_tpu_torch.models.single import SingleViewGazeNet

__all__ = [
    "BACKBONES",
    "FeatRotationMultiView",
    "FeatRotationSymm",
    "IntensityBatchNorm",
    "Mlp",
    "ResNet",
    "SingleViewGazeNet",
]
