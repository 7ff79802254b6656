from rot_mvgaze_tpu_torch.models.blocks import Mlp
from rot_mvgaze_tpu_torch.models.resnet import BACKBONES, ResNet
from rot_mvgaze_tpu_torch.models.rot_mv import FeatRotationSymm

__all__ = ["BACKBONES", "FeatRotationSymm", "Mlp", "ResNet"]
