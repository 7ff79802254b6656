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
(``ops/batchnorm.py``), in eval ``nn.BatchNorm2d`` then add then ReLU.
``int8`` makes every conv a :class:`QuantConv2d` (eval only; the state dict
is the float model's). ``bn_stat_subsample`` sets every BatchNorm's
train-mode statistics to the batch's first ``B // k`` images, and ``remat``
recomputes each residual block in the backward
(``torch.utils.checkpoint``), as the JAX package's ``nn.remat`` does; the
stem is not recomputed.

Spatial partitioning: with ``spatial_unshard`` set (by
``parallel.with_spatial_floor``) ``forward`` also takes images as height
strips over a mesh (``parallel.spatial.Sharded``). The convs and the
max-pool run on the strips with halo rows (:class:`Conv2d`,
:class:`MaxPool2d`), the BatchNorms take the whole batch's statistics, the
strips are gathered onto their group's first device before a stage whose
output would leave fewer than 2 rows in a strip (at the stem and at each
stage, as the JAX backbone's floor), and the pool returns ``(B, C)`` on the
mesh's first device.
"""

from __future__ import annotations

import contextlib
from typing import Any, Iterator, Optional, Sequence, Type, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from rot_mvgaze_tpu_torch.models.norm import BatchNormAct, recomputing
from rot_mvgaze_tpu_torch.ops import quant
from rot_mvgaze_tpu_torch.parallel import spatial
from rot_mvgaze_tpu_torch.parallel.spatial import Sharded

INT8_MODES = (False, True, "static")
# the frozen static scale's range when a conv was never calibrated, as the
# JAX package's QuantConv: post-BN/ReLU activations rarely exceed |8|
UNCALIBRATED_AMAX = 8.0


class QuantConv2d(nn.Conv2d):
    """``nn.Conv2d`` (the same parameters and state-dict keys) whose eval
    forward runs :func:`rot_mvgaze_tpu_torch.ops.quant.int8_conv`: weights
    per output channel, int32 accumulation, out in the input's dtype. Train
    mode is the float conv.

    ``int8=True`` scales activations dynamically. ``int8="static"`` keeps
    the running max of ``|x|`` in the non-persistent buffer ``act_amax``
    (not in the state dict): while ``calibrating`` is set, passes record
    the range and quantize dynamically; otherwise the scale is
    ``act_amax / 127``, or ``8 / 127`` while ``act_amax`` is 0. The
    quantized weight is cached per weight version and device; a traced
    call (``torch.export``) quantizes in the graph."""

    def __init__(self, *args: Any, int8: Any = True, **kwargs: Any) -> None:
        super().__init__(*args, **kwargs)
        if int8 not in (True, "static"):
            raise ValueError(f"QuantConv2d int8 must be True or 'static', got {int8!r}")
        self.int8 = int8
        self.calibrating = False
        if int8 == "static":
            self.register_buffer("act_amax", torch.zeros((), dtype=torch.float32), persistent=False)
        self._wq: Any = None

    def _apply(self, fn, recurse=True):
        # the range stays float32 (as the JAX package's) when the module is
        # cast to a compute dtype
        amax = getattr(self, "act_amax", None)
        super()._apply(fn, recurse)
        if amax is not None:
            self.act_amax = amax.to(device=self.act_amax.device, dtype=torch.float32)
        return self

    def _quantized_weight(self):
        w = self.weight
        if torch.compiler.is_compiling() or type(w) not in (torch.Tensor, nn.Parameter):
            return quant.quantize_conv_weight(w)
        key = (w.data_ptr(), w._version, w.dtype, w.device)
        if self._wq is None or self._wq[0] != key:
            with torch.no_grad():
                self._wq = (key, quant.quantize_conv_weight(w))
        return self._wq[1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return super().forward(x)
        act_scale = None
        if self.int8 == "static":
            if self.calibrating:
                with torch.no_grad():
                    torch.maximum(self.act_amax, x.detach().float().abs().amax(), out=self.act_amax)
            else:
                amax = torch.where(self.act_amax > 0, self.act_amax, UNCALIBRATED_AMAX)
                act_scale = amax / 127.0
        return quant.int8_conv(x, self.weight, self.stride, self.padding, self.groups,
                               act_scale=act_scale, quantized_weight=self._quantized_weight())


@contextlib.contextmanager
def calibrating(model: nn.Module) -> Iterator[None]:
    """Static int8 calibration passes: every :class:`QuantConv2d` of
    ``model`` records its input range and quantizes dynamically."""
    convs = [m for m in model.modules() if isinstance(m, QuantConv2d)]
    for m in convs:
        m.calibrating = True
    try:
        yield
    finally:
        for m in convs:
            m.calibrating = False


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` (the same parameters and state-dict keys) that also
    takes height strips (``parallel.spatial.Sharded``): the strip conv with
    halo rows, ``parallel.spatial.conv2d``."""

    def forward(self, x: Any) -> Any:
        if isinstance(x, Sharded):
            return spatial.conv2d(x, self.weight, self.bias, self.stride, self.padding, self.dilation,
                                  self.groups, owner=self)
        return super().forward(x)


class MaxPool2d(nn.MaxPool2d):
    """``nn.MaxPool2d`` that also takes height strips
    (``parallel.spatial.max_pool2d``: −inf only above and below the image)."""

    def forward(self, x: Any) -> Any:
        if isinstance(x, Sharded):
            return spatial.max_pool2d(x, self.kernel_size, self.stride, self.padding)
        return super().forward(x)


def _conv(
    in_ch: int, out_ch: int, k: int, stride: int = 1, groups: int = 1, int8: Any = False
) -> nn.Conv2d:
    kwargs = dict(stride=stride, padding=k // 2, groups=groups, bias=False)
    if int8:
        return QuantConv2d(in_ch, out_ch, k, int8=int8, **kwargs)
    return Conv2d(in_ch, out_ch, k, **kwargs)


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
        int8: Any = False,
    ) -> None:
        super().__init__()
        if groups != 1 or base_width != 64:
            raise ValueError(
                "BasicBlock only supports groups=1 and base_width=64; "
                f"got groups={groups}, base_width={base_width}"
            )
        self.conv1 = _conv(inplanes, planes, 3, stride, int8=int8)
        self.bn1 = BatchNormAct(planes, relu=True)
        self.conv2 = _conv(planes, planes, 3, int8=int8)
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
        int8: Any = False,
    ) -> None:
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = _conv(inplanes, width, 1, int8=int8)
        self.bn1 = BatchNormAct(width, relu=True)
        self.conv2 = _conv(width, width, 3, stride, groups, int8=int8)
        self.bn2 = BatchNormAct(width, relu=True)
        self.conv3 = _conv(width, planes * self.expansion, 1, int8=int8)
        self.bn3 = BatchNormAct(planes * self.expansion, relu=True)  # + residual, then ReLU
        self.downsample = downsample

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        out = self.bn1(self.conv1(x))
        out = self.bn2(self.conv2(out))
        return self.bn3(self.conv3(out), identity)


def _recompute_context():
    """``checkpoint``'s context_fn: nothing around the first forward, and
    :func:`recomputing` around the backward's recompute, so that the
    recomputed BatchNorms leave their running statistics and
    ``num_batches_tracked`` as the first forward left them (the recompute
    launches bn_stats and bn_apply again, with the same statistics)."""
    return contextlib.nullcontext(), recomputing()


class ResNet(nn.Module):
    """ResNet backbone over NHWC input returning pooled features (B, C).
    ``int8`` (False, True or "static") selects the eval convs
    (:class:`QuantConv2d`); ``bn_stat_subsample`` and ``remat`` as the JAX
    backbone's fields (module docstring)."""

    def __init__(
        self,
        block: Type[Union[BasicBlock, Bottleneck]],
        stage_sizes: Sequence[int],
        groups: int = 1,
        width_per_group: int = 64,
        num_classes: int = 1000,
        int8: Any = False,
        bn_stat_subsample: int = 1,
        remat: bool = False,
    ) -> None:
        super().__init__()
        if int8 not in INT8_MODES:
            raise ValueError(f"int8 must be one of {INT8_MODES}, got {int8!r}")
        if bn_stat_subsample < 1:
            raise ValueError(f"bn_stat_subsample must be >= 1, got {bn_stat_subsample}")
        self.int8 = int8
        self.bn_stat_subsample = bn_stat_subsample
        self.remat = remat
        self.conv1 = _conv(3, 64, 7, 2, int8=int8)
        self.bn1 = BatchNormAct(64, relu=True)
        self.maxpool = MaxPool2d(kernel_size=3, stride=2, padding=1)
        # the spatial floor's strip count, set by parallel.with_spatial_floor
        # (the JAX backbone's spatial_unshard); None: no strips accepted
        self.spatial_unshard: Optional[int] = None
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
                        _conv(inplanes, planes * block.expansion, 1, s, int8=int8),
                        BatchNormAct(planes * block.expansion),
                    )
                blocks.append(
                    block(inplanes, planes, s, downsample, groups, width_per_group, int8)
                )
                inplanes = planes * block.expansion
            setattr(self, f"layer{stage_i + 1}", nn.Sequential(*blocks))
        self.feature_dim = 512 * block.expansion
        self.fc = nn.Linear(self.feature_dim, num_classes)
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                # torchvision's init, as the JAX package's conv_kaiming_init
                nn.init.kaiming_normal_(m.weight, mode="fan_out", nonlinearity="relu")
            elif isinstance(m, BatchNormAct):
                m.stat_subsample = bn_stat_subsample

    def forward(self, x: Any) -> torch.Tensor:
        sharded = isinstance(x, Sharded)
        if sharded and self.spatial_unshard is None:
            raise ValueError("height strips need the backbone's spatial floor: "
                             "parallel.with_spatial_floor(model, mesh)")

        def floor(x, total_stride):
            # gather the strips before a stage whose output would leave < 2
            # rows in one (models/resnet.py of the JAX package, :446,496)
            return spatial.floor_check(x, total_stride, self.spatial_unshard) if sharded else x

        dtype = self.conv1.weight.dtype
        if sharded:
            x = x.map(lambda t: t.permute(0, 3, 1, 2).to(dtype), hdim=2)
        else:
            x = x.permute(0, 3, 1, 2).to(dtype)
        x = floor(x, 4)  # stem: conv1 (s2) + maxpool (s2)
        x = self.maxpool(self.bn1(self.conv1(x)))
        remat = self.remat and self.training and torch.is_grad_enabled()
        for stage_i, stage in enumerate((self.layer1, self.layer2, self.layer3, self.layer4)):
            x = floor(x, 1 if stage_i == 0 else 2)
            for block in stage:
                if remat:
                    x = checkpoint(block, x, use_reentrant=False, preserve_rng_state=False,
                                   context_fn=_recompute_context)
                else:
                    x = block(x)
        return spatial.mean_pool(x) if sharded else x.mean(dim=(2, 3))


def resnet18(**kwargs: Any) -> ResNet:
    return ResNet(BasicBlock, (2, 2, 2, 2), **kwargs)


def resnet34(**kwargs: Any) -> ResNet:
    return ResNet(BasicBlock, (3, 4, 6, 3), **kwargs)


def resnet50(**kwargs: Any) -> ResNet:
    return ResNet(Bottleneck, (3, 4, 6, 3), **kwargs)


def resnet101(**kwargs: Any) -> ResNet:
    return ResNet(Bottleneck, (3, 4, 23, 3), **kwargs)


def resnet152(**kwargs: Any) -> ResNet:
    return ResNet(Bottleneck, (3, 8, 36, 3), **kwargs)


def resnext50_32x4d(**kwargs: Any) -> ResNet:
    return ResNet(Bottleneck, (3, 4, 6, 3), groups=32, width_per_group=4, **kwargs)


def resnext101_32x8d(**kwargs: Any) -> ResNet:
    return ResNet(Bottleneck, (3, 4, 23, 3), groups=32, width_per_group=8, **kwargs)


def wide_resnet50_2(**kwargs: Any) -> ResNet:
    return ResNet(Bottleneck, (3, 4, 6, 3), width_per_group=128, **kwargs)


def wide_resnet101_2(**kwargs: Any) -> ResNet:
    return ResNet(Bottleneck, (3, 4, 23, 3), width_per_group=128, **kwargs)


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
