"""ImageNet warm start of the backbone (port of ``load_pretrained_backbone``
in ``rot_mvgaze_tpu/compat/torch_convert.py`` and of
``resolve_pretrained_backbone`` in ``rot_mvgaze_tpu/compat/download.py``).

A torchvision ResNet state dict has the port backbone's own key names
(``conv1``, ``bn1``, ``layer{L}.{B}.conv{k}``, ``downsample.{0,1}``), so it
loads into ``model._feat_extractor[0]`` as it is. ``--pretrained_backbone
auto`` fetches the file into the cache both packages share, checked
against the sha256 prefix in its torchvision name
(``compat/download.py``), or takes it from there.
"""

from __future__ import annotations

import os
from typing import Any

import torch
from torch import nn

MODEL_URLS = {
    "resnet18": "https://download.pytorch.org/models/resnet18-5c106cde.pth",
    "resnet34": "https://download.pytorch.org/models/resnet34-333f7ec4.pth",
    "resnet50": "https://download.pytorch.org/models/resnet50-19c8e357.pth",
    "resnet101": "https://download.pytorch.org/models/resnet101-5d3b4d8f.pth",
    "resnet152": "https://download.pytorch.org/models/resnet152-b121ed2d.pth",
    "resnext50_32x4d": "https://download.pytorch.org/models/resnext50_32x4d-7cdf4587.pth",
    "resnext101_32x8d": "https://download.pytorch.org/models/resnext101_32x8d-8ba56ff5.pth",
    "wide_resnet50_2": "https://download.pytorch.org/models/wide_resnet50_2-95faca4d.pth",
    "wide_resnet101_2": "https://download.pytorch.org/models/wide_resnet101_2-32ee1156.pth",
}


def resolve_pretrained(value: str, arch: Any) -> str:
    """The file ``--pretrained_backbone value`` names: a path as it is
    (``FileNotFoundError`` if missing), or for ``auto``/``download`` the
    torchvision file of ``arch`` (an int depth or a variant name) through
    ``compat.download.download_pretrained``: the cached copy, or a fresh
    download into the cache."""
    if value.lower() in ("auto", "download"):
        from rot_mvgaze_tpu_torch.compat.download import download_pretrained

        return download_pretrained(arch)
    if not os.path.exists(value):
        raise FileNotFoundError(f"--pretrained_backbone {value} does not exist (pass 'auto' to download "
                                f"the ImageNet weights)")
    return value


def load_pretrained_backbone(model: nn.Module, path: str) -> nn.Module:
    """Load a torchvision ResNet checkpoint (a state dict, or a dict holding
    one under ``state_dict``) into ``model._feat_extractor[0]``. Keys left
    over or missing raise ``ValueError``, except the ImageNet head ``fc.*``
    (never called) and the BN ``num_batches_tracked`` counters (older
    torchvision files lack them; JAX keeps none); shapes must match."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    backbone = model._feat_extractor[0]

    def counted(k: str) -> bool:
        return not k.startswith("fc.") and not k.endswith("num_batches_tracked")

    want = {k for k in backbone.state_dict() if counted(k)}
    given = {k for k in sd if counted(k)}
    if given != want:
        raise ValueError(f"{path} is not a torchvision checkpoint of this backbone: leftover keys "
                         f"{sorted(given - want)[:8]}, missing keys {sorted(want - given)[:8]}")
    backbone.load_state_dict({k: sd[k] for k in given}, strict=False)
    return model
