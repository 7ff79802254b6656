"""Plain float32 reference of the benchmarked Rot-MVGaze models.

Written from the paper (arXiv 2305.12704) and the reference repository
(``ut-vision/Rot-MVGaze``, ``models/rot_mv.py:102-269``), in plain PyTorch,
with no kernel, no cache and no batching trick. It imports torch alone.

The module tree is the reference checkpoints' (``_feat_extractor.0`` a
torchvision ResNet with its unused ``fc``, ``_lifter._lifter``,
``_img_fusers.{i}._fuser``, ``_gaze_estimators.{i}``, each MLP as
``blocks.{i}.0``), so one state dict loads into this model and into the
system under test.

- ``StereoModel``: two views. In train mode each view runs the backbone
  alone (BatchNorm statistics per view, each running statistic moved twice
  per step); in eval both views run as one batch. Per iteration ``i``::

      f0' = fuser_i([img_feat_0, (R0 R1^T) f1])   f1' = fuser_i([img_feat_1, (R1 R0^T) f0])
      g_v = head_i([img_feat_v, f_v'])

  where ``fuser_i`` is Linear -> ReLU -> Linear and ``f0`` is the feature
  before this iteration's update.
- ``MultiViewModel``: V views, one backbone batch of all B·V images; view
  v's partner is the mean over w != v of ``(R_v R_w^T) f_w``, fused by the
  same MLP; the answer is view 0's gaze of the last iteration.

:func:`set_low_precision` makes a model round both operands of every
convolution and linear layer, with one scale per tensor, before the
float32 product, with a straight-through gradient: to int8 (amax / 127,
round to nearest) or to float8 e4m3 (amax / 448). It is the control of a
bfloat16 configuration: the reference in the program's place, one
precision below.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

FP8_MAX = 448.0  # largest finite float8 e4m3fn
INT8_MAX = 127.0


def fake_quant(t: torch.Tensor, kind: str) -> torch.Tensor:
    """``t`` rounded to ``kind`` ("int8" or "fp8") under one per-tensor
    scale, back in ``t``'s dtype; the gradient passes straight through."""
    x = t.detach()
    if kind == "int8":
        scale = x.abs().amax().clamp(min=1e-12) / INT8_MAX
        q = torch.round(x / scale).clamp(-INT8_MAX, INT8_MAX) * scale
    else:
        scale = x.abs().amax().clamp(min=1e-12) / FP8_MAX
        q = (x / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
    return t + (q - x)


class Conv2d(nn.Conv2d):
    quant = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.quant is None:
            return super().forward(x)
        return F.conv2d(fake_quant(x, self.quant), fake_quant(self.weight, self.quant), self.bias, self.stride,
                        self.padding, self.dilation, self.groups)


class Linear(nn.Linear):
    quant = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.quant is None:
            return super().forward(x)
        return F.linear(fake_quant(x, self.quant), fake_quant(self.weight, self.quant), self.bias)


def set_low_precision(model: nn.Module, kind: "str | None") -> nn.Module:
    """Every convolution's and linear layer's operands rounded to ``kind``
    ("int8", "fp8"), or exact with None."""
    for m in model.modules():
        if isinstance(m, (Conv2d, Linear)):
            m.quant = kind
    return model


class Mlp(nn.Module):
    """Linear layers with a ReLU between all but the last (``blocks.{i}.0``)."""

    def __init__(self, in_features: int, features: Sequence[int]) -> None:
        super().__init__()
        blocks = []
        for i, out in enumerate(features):
            layers: List[nn.Module] = [Linear(in_features, out)]
            if i < len(features) - 1:
                layers.append(nn.ReLU())
            blocks.append(nn.Sequential(*layers))
            in_features = out
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x = block(x)
        return x


def batch_norm(channels: int) -> nn.BatchNorm2d:
    # eps 1e-5, momentum 0.1: torch's BatchNorm2d, the reference's
    return nn.BatchNorm2d(channels, eps=1e-5, momentum=0.1)


class Bottleneck(nn.Module):
    """torchvision's ResNet v1.5 bottleneck: 1x1, 3x3 (strided), 1x1, each
    followed by BatchNorm; ReLU after the first two and after the residual
    sum."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int) -> None:
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = batch_norm(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn2 = batch_norm(planes)
        self.conv3 = Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = batch_norm(planes * 4)
        self.downsample = None
        if stride != 1 or inplanes != planes * 4:
            self.downsample = nn.Sequential(Conv2d(inplanes, planes * 4, 1, stride=stride, bias=False),
                                            batch_norm(planes * 4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        return F.relu(self.bn3(self.conv3(out)) + identity)


STAGES = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


class ResNet(nn.Module):
    """Bottleneck ResNet over NHWC images, returning the pooled (B, 2048)
    features; ``fc`` is never called."""

    def __init__(self, depth: int) -> None:
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = batch_norm(64)
        inplanes = 64
        for i, (planes, blocks) in enumerate(zip((64, 128, 256, 512), STAGES[depth])):
            layer = []
            for b in range(blocks):
                layer.append(Bottleneck(inplanes, planes, 2 if (b == 0 and i > 0) else 1))
                inplanes = planes * 4
            setattr(self, f"layer{i + 1}", nn.Sequential(*layer))
        self.feature_dim = inplanes
        self.fc = nn.Linear(inplanes, 1000)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return x.mean(dim=(2, 3))


class Lifter(nn.Module):
    def __init__(self, in_features: int, k: int) -> None:
        super().__init__()
        self.k = k
        self._lifter = Mlp(in_features, [3 * k, 3 * k])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._lifter(x).reshape(-1, 3, self.k)


class Fuser(nn.Module):
    """[img_feat, partner.flatten] -> Linear(D+3K, D+3K) -> ReLU -> Linear(., 3K)."""

    def __init__(self, d: int, k: int) -> None:
        super().__init__()
        self.k = k
        self._fuser = Mlp(d + 3 * k, [d + 3 * k, 3 * k])

    def forward(self, img_feat: torch.Tensor, partner: torch.Tensor) -> torch.Tensor:
        x = torch.cat([img_feat, partner.reshape(partner.shape[0], -1)], dim=-1)
        return self._fuser(x).reshape(-1, 3, self.k)


class _RotMV(nn.Module):
    def __init__(self, backbone_depth: int, num_iter: int, num_feat_vec: int, head_hidden: int) -> None:
        super().__init__()
        self.num_iter = num_iter
        self._feat_extractor = nn.Sequential(ResNet(backbone_depth))
        d = self._feat_extractor[0].feature_dim
        self._lifter = Lifter(d, num_feat_vec)
        self._img_fusers = nn.ModuleList(Fuser(d, num_feat_vec) for _ in range(num_iter))
        self._gaze_estimators = nn.ModuleList(Mlp(d + 3 * num_feat_vec, [head_hidden, 2])
                                              for _ in range(num_iter))

    @property
    def backbone(self) -> nn.Module:
        return self._feat_extractor[0]


def relative(rot_a: torch.Tensor, rot_b: torch.Tensor) -> torch.Tensor:
    """R_a R_b^T: takes a feature in view b's frame into view a's."""
    return rot_a @ rot_b.transpose(-1, -2)


class StereoModel(_RotMV):
    """The two-view model (module docstring)."""

    def heads(self, feat_0: torch.Tensor, feat_1: torch.Tensor, rot_0: torch.Tensor,
              rot_1: torch.Tensor) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Everything after the backbone: ``[(g0, g1)]`` per iteration."""
        rot_10, rot_01 = relative(rot_0, rot_1), relative(rot_1, rot_0)
        r0, r1 = self._lifter(feat_0), self._lifter(feat_1)
        out = []
        for i in range(self.num_iter):
            prev_0 = r0
            r0 = self._img_fusers[i](feat_0, rot_10 @ r1)
            r1 = self._img_fusers[i](feat_1, rot_01 @ prev_0)
            head = self._gaze_estimators[i]
            out.append((head(torch.cat([feat_0, r0.flatten(1)], -1)),
                        head(torch.cat([feat_1, r1.flatten(1)], -1))))
        return out

    def forward(self, img_0: torch.Tensor, img_1: torch.Tensor, rot_0: torch.Tensor,
                rot_1: torch.Tensor) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        if self.training:
            feat_0, feat_1 = self.backbone(img_0), self.backbone(img_1)
        else:
            feat_0, feat_1 = self.backbone(torch.cat([img_0, img_1])).split(img_0.shape[0])
        return self.heads(feat_0, feat_1, rot_0, rot_1)


class MultiViewModel(_RotMV):
    """The V-view model (module docstring)."""

    def forward(self, imgs: torch.Tensor, rots: torch.Tensor) -> torch.Tensor:
        """imgs (B, V, H, W, 3), rots (B, V, 3, 3) -> (B, 2), view 0's gaze
        of the last iteration."""
        b, v = rots.shape[:2]
        feats = self.backbone(imgs.reshape((b * v,) + tuple(imgs.shape[2:])))
        k = self._lifter.k
        f = self._lifter(feats).reshape(b, v, 3, k)
        rel = rots[:, :, None] @ rots[:, None].transpose(-1, -2)  # [b, v, w] = R_v R_w^T
        gaze = None
        for i in range(self.num_iter):
            partners = []
            for vi in range(v):
                rotated = [rel[:, vi, w] @ f[:, w] for w in range(v) if w != vi]
                partners.append(torch.stack(rotated).sum(0) / (v - 1))
            partner = torch.stack(partners, dim=1).reshape(b * v, 3, k)
            f = self._img_fusers[i](feats, partner).reshape(b, v, 3, k)
            gaze = self._gaze_estimators[i](torch.cat([feats, f.reshape(b * v, -1)], -1))
        return gaze.reshape(b, v, 2)[:, 0]


def build(config: Dict) -> nn.Module:
    """The reference model of a configuration file's ``model`` section."""
    m = config["model"]
    cls = {"stereo": StereoModel, "multiview": MultiViewModel}[m["kind"]]
    return cls(m["backbone_depth"], m["num_iter"], m["num_feat_vec"], m["head_hidden"])


def build_on(config: Dict, device: torch.device, state: Dict[str, torch.Tensor]) -> nn.Module:
    """The reference model on ``device`` holding ``state`` in float32
    (built on the meta device, so no initialisation runs)."""
    with torch.device("meta"):
        net = build(config)
    net = net.to_empty(device=device)
    net.load_state_dict(state)
    return net


@contextlib.contextmanager
def exact_float32() -> Iterator[None]:
    """float32 products as float32: TF32 off for cuBLAS and cuDNN inside,
    restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
