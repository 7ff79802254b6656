"""ResNet family (18/34/50/101/152, ResNeXt, Wide): port of
``rot_mvgaze_tpu/models/resnet.py``.

The module tree is torchvision's (``conv1``, ``bn1``, ``layer{L}.{B}.conv{k}``,
``downsample.{0,1}``, ``fc``), which is the reference checkpoints' key anatomy
under ``_feat_extractor.0.``. ``forward`` takes NHWC images, as the JAX
backbone does, and runs them as an NCHW view with channels_last strides (the
permute copies nothing). It returns the pooled ``(B, C)`` spatial mean; ``fc``
is never called and is kept only so that ``load_state_dict(strict=True)``
accepts a reference checkpoint. Every BatchNorm is a ``BatchNormAct`` that
applies its own ReLU, and a block's last one also adds the residual, as the
JAX package's ``ConvBN`` does: in train mode that is one fused op
(``ops/batchnorm.py``), in eval ``nn.BatchNorm2d`` then add then ReLU. int8,
remat and spatial partitioning are not ported.
"""

from __future__ import annotations

from typing import Optional, Sequence, Type, Union

import torch
from torch import nn

from rot_mvgaze_tpu_torch.models.norm import BatchNormAct


def _conv(in_ch: int, out_ch: int, k: int, stride: int = 1, groups: int = 1) -> nn.Conv2d:
    return nn.Conv2d(
        in_ch, out_ch, k, stride=stride, padding=k // 2, groups=groups, bias=False
    )


class BasicBlock(nn.Module):
    """Two 3x3 convs + shortcut."""

    expansion = 1

    def __init__(
        self,
        inplanes: int,
        planes: int,
        stride: int = 1,
        downsample: Optional[nn.Module] = None,
        groups: int = 1,
        base_width: int = 64,
    ) -> None:
        super().__init__()
        if groups != 1 or base_width != 64:
            raise ValueError(
                "BasicBlock only supports groups=1 and base_width=64; "
                f"got groups={groups}, base_width={base_width}"
            )
        self.conv1 = _conv(inplanes, planes, 3, stride)
        self.bn1 = BatchNormAct(planes, relu=True)
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = BatchNormAct(planes, relu=True)  # + residual, then ReLU
        self.downsample = downsample

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        out = self.bn1(self.conv1(x))
        return self.bn2(self.conv2(out), identity)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (strided, grouped) -> 1x1 + shortcut."""

    expansion = 4

    def __init__(
        self,
        inplanes: int,
        planes: int,
        stride: int = 1,
        downsample: Optional[nn.Module] = None,
        groups: int = 1,
        base_width: int = 64,
    ) -> None:
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = _conv(inplanes, width, 1)
        self.bn1 = BatchNormAct(width, relu=True)
        self.conv2 = _conv(width, width, 3, stride, groups)
        self.bn2 = BatchNormAct(width, relu=True)
        self.conv3 = _conv(width, planes * self.expansion, 1)
        self.bn3 = BatchNormAct(planes * self.expansion, relu=True)  # + residual, then ReLU
        self.downsample = downsample

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        out = self.bn1(self.conv1(x))
        out = self.bn2(self.conv2(out))
        return self.bn3(self.conv3(out), identity)


class ResNet(nn.Module):
    """ResNet backbone over NHWC input returning pooled features (B, C)."""

    def __init__(
        self,
        block: Type[Union[BasicBlock, Bottleneck]],
        stage_sizes: Sequence[int],
        groups: int = 1,
        width_per_group: int = 64,
        num_classes: int = 1000,
    ) -> None:
        super().__init__()
        self.conv1 = _conv(3, 64, 7, 2)
        self.bn1 = BatchNormAct(64, relu=True)
        self.maxpool = nn.MaxPool2d(kernel_size=3, stride=2, padding=1)
        inplanes = 64
        for stage_i, (planes, num_blocks) in enumerate(
            zip((64, 128, 256, 512), stage_sizes)
        ):
            stride = 1 if stage_i == 0 else 2
            blocks = []
            for block_i in range(num_blocks):
                s = stride if block_i == 0 else 1
                downsample = None
                if block_i == 0 and (s != 1 or inplanes != planes * block.expansion):
                    downsample = nn.Sequential(
                        _conv(inplanes, planes * block.expansion, 1, s),
                        BatchNormAct(planes * block.expansion),
                    )
                blocks.append(
                    block(inplanes, planes, s, downsample, groups, width_per_group)
                )
                inplanes = planes * block.expansion
            setattr(self, f"layer{stage_i + 1}", nn.Sequential(*blocks))
        self.feature_dim = 512 * block.expansion
        self.fc = nn.Linear(self.feature_dim, num_classes)
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                # torchvision's init, as the JAX package's conv_kaiming_init
                nn.init.kaiming_normal_(m.weight, mode="fan_out", nonlinearity="relu")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).to(self.conv1.weight.dtype)
        x = self.maxpool(self.bn1(self.conv1(x)))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return x.mean(dim=(2, 3))


def resnet18() -> ResNet:
    return ResNet(BasicBlock, (2, 2, 2, 2))


def resnet34() -> ResNet:
    return ResNet(BasicBlock, (3, 4, 6, 3))


def resnet50() -> ResNet:
    return ResNet(Bottleneck, (3, 4, 6, 3))


def resnet101() -> ResNet:
    return ResNet(Bottleneck, (3, 4, 23, 3))


def resnet152() -> ResNet:
    return ResNet(Bottleneck, (3, 8, 36, 3))


def resnext50_32x4d() -> ResNet:
    return ResNet(Bottleneck, (3, 4, 6, 3), groups=32, width_per_group=4)


def resnext101_32x8d() -> ResNet:
    return ResNet(Bottleneck, (3, 4, 23, 3), groups=32, width_per_group=8)


def wide_resnet50_2() -> ResNet:
    return ResNet(Bottleneck, (3, 4, 6, 3), width_per_group=128)


def wide_resnet101_2() -> ResNet:
    return ResNet(Bottleneck, (3, 4, 23, 3), width_per_group=128)


BACKBONES = {
    18: resnet18,
    34: resnet34,
    50: resnet50,
    101: resnet101,
    152: resnet152,
    "resnet18": resnet18,
    "resnet34": resnet34,
    "resnet50": resnet50,
    "resnet101": resnet101,
    "resnet152": resnet152,
    "resnext50_32x4d": resnext50_32x4d,
    "resnext101_32x8d": resnext101_32x8d,
    "wide_resnet50_2": wide_resnet50_2,
    "wide_resnet101_2": wide_resnet101_2,
}
