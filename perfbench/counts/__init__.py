"""Operations and bytes of a configuration, from its shapes alone.

FLOPs count the dense products, 2 per multiply-add: every convolution and
linear layer of the reference model (the 3x3 rotations, under 1e-5 of the
total, are left out), never what a kernel of the system runs. A training
step adds the backward's two products per layer (input and weight
gradients), except the stem convolution's input gradient, which nothing
needs. BatchNorm bytes count each input read once and each output written
once per op, whatever the kernels that implement it read again:

- forward: read x (and the residual), write y;
- backward: read x and dy (and y, which a ReLU after a residual sum needs
  for its mask), write dx (and d-residual where a ReLU sits between the
  sum and the output).

Peaks (``peaks.json``) are the card's published dense rates.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
STAGES = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


@dataclass(frozen=True)
class Conv:
    cin: int
    cout: int
    k: int
    hout: int
    wout: int

    @property
    def flops(self) -> int:
        """Per image."""
        return 2 * self.cin * self.k * self.k * self.cout * self.hout * self.wout


@dataclass(frozen=True)
class BN:
    c: int
    h: int
    w: int
    relu: bool
    residual: bool

    def elements(self, images: int) -> int:
        return images * self.c * self.h * self.w

    def forward_bytes(self, images: int, itemsize: int) -> int:
        return self.elements(images) * itemsize * (3 if self.residual else 2)

    def backward_bytes(self, images: int, itemsize: int) -> int:
        tensors = 5 if (self.residual and self.relu) else 3
        return self.elements(images) * itemsize * tensors


def _out(size: int, k: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - k) // stride + 1


def resnet(depth: int, size: int) -> tuple:
    """``(convs, bns)`` of a bottleneck ResNet's backbone at ``size`` x
    ``size`` inputs, in forward order."""
    convs: List[Conv] = []
    bns: List[BN] = []
    s = _out(size, 7, 2, 3)
    convs.append(Conv(3, 64, 7, s, s))
    bns.append(BN(64, s, s, relu=True, residual=False))
    s = _out(s, 3, 2, 1)
    inplanes = 64
    for i, (planes, blocks) in enumerate(zip((64, 128, 256, 512), STAGES[depth])):
        for b in range(blocks):
            stride = 2 if (b == 0 and i > 0) else 1
            s2 = _out(s, 3, stride, 1)
            convs.append(Conv(inplanes, planes, 1, s, s))
            bns.append(BN(planes, s, s, relu=True, residual=False))
            convs.append(Conv(planes, planes, 3, s2, s2))
            bns.append(BN(planes, s2, s2, relu=True, residual=False))
            convs.append(Conv(planes, planes * 4, 1, s2, s2))
            bns.append(BN(planes * 4, s2, s2, relu=True, residual=True))
            if stride != 1 or inplanes != planes * 4:
                convs.append(Conv(inplanes, planes * 4, 1, s2, s2))
                bns.append(BN(planes * 4, s2, s2, relu=False, residual=False))
            inplanes, s = planes * 4, s2
    return convs, bns


def head_linears(model: Dict) -> Dict[str, List[tuple]]:
    """(in, out) of each linear layer after the backbone: the lifter's, one
    fuser's and one gaze head's."""
    d, k, hidden = 512 * 4, model["num_feat_vec"], model["head_hidden"]
    return {"lifter": [(d, 3 * k), (3 * k, 3 * k)],
            "fuser": [(d + 3 * k, d + 3 * k), (d + 3 * k, 3 * k)],
            "head": [(d + 3 * k, hidden), (hidden, 2)]}


def _linear_flops(layers: List[tuple]) -> int:
    return sum(2 * i * o for i, o in layers)


def forward_flops_per_sample(model: Dict) -> int:
    """One sample's forward (a pair, or a V-view frame): V backbone passes,
    V lifter rows, and num_iter fuser and head rows per view."""
    views = model["num_views"]
    convs, _ = resnet(model["backbone_depth"], model["image_size"])
    lin = head_linears(model)
    per_view = (sum(c.flops for c in convs) + _linear_flops(lin["lifter"])
                + model["num_iter"] * (_linear_flops(lin["fuser"]) + _linear_flops(lin["head"])))
    return views * per_view


def train_flops_per_sample(model: Dict) -> int:
    """One sample's forward and backward: three times the forward's
    products, less the stem convolution's input gradient per view."""
    convs, _ = resnet(model["backbone_depth"], model["image_size"])
    return 3 * forward_flops_per_sample(model) - model["num_views"] * convs[0].flops


def bn_train_bytes_per_sample(model: Dict, itemsize: int) -> int:
    """Bytes of every train-mode BatchNorm op, forward and backward, of one
    sample's views."""
    _, bns = resnet(model["backbone_depth"], model["image_size"])
    views = model["num_views"]
    return sum(bn.forward_bytes(views, itemsize) + bn.backward_bytes(views, itemsize) for bn in bns)


def peaks(device_name: str) -> Optional[Dict[str, float]]:
    """The published peaks of the card named ``device_name``
    (``torch.cuda.get_device_name``), or None for a card not in the table."""
    with open(os.path.join(HERE, "peaks.json")) as f:
        table = json.load(f)
    for entry in table["cards"]:
        if all(word in device_name for word in entry["name_contains"]):
            return entry
    return None
