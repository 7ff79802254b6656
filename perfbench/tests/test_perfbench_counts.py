"""The yardstick's operation and byte counts against hand arithmetic and
against PyTorch's FLOP counter over the plain reference."""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import counts
from perfbench.reference import model as reference
from perfbench.reference import ops

MODEL = {"kind": "stereo", "backbone_depth": 50, "num_iter": 3, "num_views": 2, "image_size": 224,
         "num_feat_vec": 512, "head_hidden": 512}


def test_resnet50_convolutions_at_224_match_hand_arithmetic():
    # multiply-adds per image, stage by stage: (cin, cout, k, output side)
    convs = [(3, 64, 7, 112)]
    for cin, width, out, side, side_in, blocks in ((64, 64, 256, 56, 56, 3), (256, 128, 512, 28, 56, 4),
                                                   (512, 256, 1024, 14, 28, 6), (1024, 512, 2048, 7, 14, 3)):
        convs += [(cin, width, 1, side_in), (width, width, 3, side), (width, out, 1, side), (cin, out, 1, side)]
        convs += [(out, width, 1, side), (width, width, 3, side), (width, out, 1, side)] * (blocks - 1)
    macs = sum(ci * co * k * k * s * s for ci, co, k, s in convs)
    assert macs == 4_087_136_256  # torchvision's 4.09 GMACs for ResNet-50, less fc's 2.05 M
    got, bns = counts.resnet(50, 224)
    assert sum(c.flops for c in got) == 2 * macs
    assert len(got) == len(bns) == 53


def test_one_batchnorm_shape_by_hand():
    _, bns = counts.resnet(50, 224)
    bn = bns[3]  # layer1.0.bn3: 256 channels at 56 x 56, ReLU after the residual sum
    assert (bn.c, bn.h, bn.w, bn.relu, bn.residual) == (256, 56, 56, True, True)
    elements = 256 * 56 * 56 * 256  # 256 images
    assert bn.forward_bytes(256, 2) == elements * 2 * 3  # x, residual in; y out
    assert bn.backward_bytes(256, 2) == elements * 2 * 5  # x, dy, y in; dx, d-residual out
    stem = bns[0]
    assert stem.backward_bytes(1, 4) == 64 * 112 * 112 * 4 * 3


def test_step_totals():
    per_pair = counts.train_flops_per_sample(MODEL)
    assert per_pair * 256 == pytest.approx(12.64e12, rel=1e-3)
    assert counts.forward_flops_per_sample(dict(MODEL, num_views=3)) == pytest.approx(24.92e9, rel=1e-3)


def _dense_flops(mode: FlopCounterMode) -> int:
    table = mode.get_flop_counts()["Global"]
    return sum(v for op, v in table.items() if any(n in str(op) for n in ("convolution", "addmm", ".mm")))


@pytest.mark.parametrize("kind", ["stereo", "multiview"])
def test_counts_match_the_flop_counter_over_the_reference(kind):
    model_cfg = dict(MODEL, kind=kind, image_size=64, num_views=2 if kind == "stereo" else 3)
    net = reference.build({"model": model_cfg})
    g = torch.Generator().manual_seed(0)
    b, v = 2, model_cfg["num_views"]
    imgs = torch.rand((b, v, 64, 64, 3), generator=g)
    rots = ops.rotation(torch.rand((b, v, 2), generator=g) - 0.5)
    mode = FlopCounterMode(display=False)
    if kind == "stereo":
        net.train()
        with mode:
            gazes = net(imgs[:, 0], imgs[:, 1], rots[:, 0], rots[:, 1])
            ops.stereo_loss(gazes, torch.zeros(b, 2), torch.zeros(b, 2), 0.01, 0.5).backward()
        assert _dense_flops(mode) == counts.train_flops_per_sample(model_cfg) * b
    else:
        net.eval()
        with mode, torch.no_grad():
            net(imgs, rots)
        assert _dense_flops(mode) == counts.forward_flops_per_sample(model_cfg) * b


def test_peaks_table():
    assert counts.peaks("NVIDIA H100 80GB HBM3")["bf16_flops_per_s"] == 989e12
    assert counts.peaks("cpu") is None
