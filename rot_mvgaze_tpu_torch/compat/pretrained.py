"""ImageNet warm start of the backbone (port of ``load_pretrained_backbone``
in ``rot_mvgaze_tpu/compat/torch_convert.py`` and of the cache lookup in
``rot_mvgaze_tpu/compat/download.py``).

A torchvision ResNet state dict has the port backbone's own key names
(``conv1``, ``bn1``, ``layer{L}.{B}.conv{k}``, ``downsample.{0,1}``), so it
loads into ``model._feat_extractor[0]`` as it is. The port has no network
code: ``auto`` takes the file only from the JAX package's download cache,
checked against the sha256 prefix in its torchvision name, and otherwise
says where to fetch it.
"""

from __future__ import annotations

import hashlib
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


def cache_dir() -> str:
    """The JAX package's download cache, ``~/.cache/rot_mvgaze_tpu/pretrained``."""
    return os.path.join(os.path.expanduser("~"), ".cache", "rot_mvgaze_tpu", "pretrained")


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def resolve_pretrained(value: str, arch: Any) -> str:
    """The file ``--pretrained_backbone value`` names: a path as it is
    (``FileNotFoundError`` if missing), or for ``auto``/``download`` the
    cached torchvision file of ``arch`` (an int depth or a variant name)
    whose sha256 starts with the prefix in its name. With no such file it
    raises ``RuntimeError`` naming the address to fetch it from on a
    machine with network access."""
    if value.lower() not in ("auto", "download"):
        if not os.path.exists(value):
            raise FileNotFoundError(f"--pretrained_backbone {value} does not exist")
        return value
    name = f"resnet{arch}" if isinstance(arch, int) else str(arch)
    if name not in MODEL_URLS:
        raise KeyError(f"unknown backbone {arch!r}; known: {sorted(MODEL_URLS)}")
    url = MODEL_URLS[name]
    fname = url.rsplit("/", 1)[-1]
    dest = os.path.join(cache_dir(), fname)
    expected = fname.rsplit("-", 1)[-1].split(".")[0]
    if os.path.exists(dest) and _sha256(dest).startswith(expected):
        return dest
    state = "fails its sha256 check" if os.path.exists(dest) else "is not cached"
    raise RuntimeError(
        f"pretrained weights for {name} ({url}) {state} in {cache_dir()}, and this port makes no "
        f"network calls. This environment appears to have no network egress: download the file "
        f"on a connected machine and pass its path via --pretrained_backbone /path/to/{fname}."
    )


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
