"""Checkpoint conversion and loading (the port's own copy of the key map in
``rot_mvgaze_tpu/compat/torch_convert.py``).

The port's module tree carries the reference checkpoints' names, so a
released ``.pth.tar`` loads with ``load_state_dict(strict=True)`` and needs
no converter (:func:`load_checkpoint`). :func:`state_dict_from_jax` turns the
JAX package's variables, as a tree of numpy arrays, into the same state dict:

- Dense ``kernel (in, out)``         -> Linear ``weight (out, in)``
- Conv ``kernel (kH, kW, I, O)``     -> Conv2d ``weight (O, I, kH, kW)``
- BN ``scale/bias`` (params), ``mean/var`` (batch_stats)
                                     -> ``weight/bias/running_mean/running_var``
- plus ``num_batches_tracked`` (zero) per BN and the never-called backbone
  ``fc`` (zeros), which a strict load requires.

:func:`read_checkpoint` tells the format from a file's contents.
Loading the JAX package's native ``.msgpack`` checkpoints needs flax or
msgpack and is not ported (ROADMAP A9).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

STAGE_SIZES = {
    18: (2, 2, 2, 2),
    34: (3, 4, 6, 3),
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}
BOTTLENECK_DEPTHS = {50, 101, 152}
# grouped/wide variants: same keys as the plain bottleneck nets
ARCH_STAGE_SIZES = {
    "resnext50_32x4d": (3, 4, 6, 3),
    "resnext101_32x8d": (3, 4, 23, 3),
    "wide_resnet50_2": (3, 4, 6, 3),
    "wide_resnet101_2": (3, 4, 23, 3),
}


def _arch_info(backbone: Any) -> Tuple[Tuple[int, ...], bool]:
    """(stage_sizes, is_bottleneck) for an int depth or a variant name."""
    if isinstance(backbone, str) and backbone in ARCH_STAGE_SIZES:
        return ARCH_STAGE_SIZES[backbone], True
    if isinstance(backbone, str):
        backbone = int("".join(c for c in backbone if c.isdigit()))
    return STAGE_SIZES[backbone], backbone in BOTTLENECK_DEPTHS


@dataclass(frozen=True)
class Entry:
    """One torch key prefix <-> JAX variable path pair."""

    torch_key: str  # without the .weight/.bias/... suffix
    jax_path: Tuple[str, ...]  # path under the collection root
    kind: str  # 'conv' | 'bn' | 'linear'


def _resnet_entries(depth: Any, torch_prefix: str, jax_prefix: Tuple[str, ...]) -> List[Entry]:
    stage_sizes, bottleneck = _arch_info(depth)
    expansion = 4 if bottleneck else 1
    entries = [
        Entry(f"{torch_prefix}conv1", jax_prefix + ("conv1",), "conv"),
        Entry(f"{torch_prefix}bn1", jax_prefix + ("bn1",), "bn"),
    ]
    n_convs = 3 if bottleneck else 2
    inplanes = 64
    for stage_i, num_blocks in enumerate(stage_sizes):
        planes = 64 * (2**stage_i)
        stride = 1 if stage_i == 0 else 2
        for block_i in range(num_blocks):
            t = f"{torch_prefix}layer{stage_i + 1}.{block_i}."
            j = jax_prefix + (f"layer{stage_i + 1}_{block_i}",)
            for k in range(1, n_convs + 1):
                entries.append(Entry(f"{t}conv{k}", j + (f"cb{k}", f"conv{k}"), "conv"))
                entries.append(Entry(f"{t}bn{k}", j + (f"cb{k}", f"bn{k}"), "bn"))
            if block_i == 0 and (stride != 1 or inplanes != planes * expansion):
                entries.append(Entry(f"{t}downsample.0", j + ("downsample", "conv"), "conv"))
                entries.append(Entry(f"{t}downsample.1", j + ("downsample", "bn"), "bn"))
            inplanes = planes * expansion
    return entries


def _mlp_entries(torch_prefix: str, jax_prefix: Tuple[str, ...], n_layers: int) -> List[Entry]:
    return [
        Entry(f"{torch_prefix}blocks.{i}.0", jax_prefix + (f"dense_{i}",), "linear")
        for i in range(n_layers)
    ]


def rot_mv_entries(
    backbone_depth: Any = 50, num_iter: int = 3, share_weights: bool = False
) -> List[Entry]:
    """Key map of ``FeatRotationSymm`` on the default path. With
    ``share_weights`` every iteration index maps to the JAX index-0 module,
    as the reference's aliased ``ModuleList`` emits every index."""
    entries = _resnet_entries(backbone_depth, "_feat_extractor.0.", ("backbone",))
    entries += _mlp_entries("_lifter._lifter.", ("lifter", "lifter"), 2)
    for i in range(num_iter):
        j = 0 if share_weights else i
        entries += _mlp_entries(f"_img_fusers.{i}._fuser.", (f"img_fuser_{j}", "fuser"), 2)
        entries += _mlp_entries(f"_gaze_estimators.{i}.", (f"gaze_estimator_{j}",), 2)
    return entries


def _lookup(tree: Mapping[str, Any], path: Sequence[str]) -> np.ndarray:
    node: Any = tree
    for p in path:
        node = node[p]
    return np.asarray(node)


def state_dict_from_jax(
    variables: Mapping[str, Any],
    backbone_depth: Any = 50,
    num_iter: int = 3,
    share_weights: bool = False,
) -> Dict[str, torch.Tensor]:
    """The JAX package's ``{"params", "batch_stats"}`` tree of numpy arrays
    -> the port's ``FeatRotationSymm`` state dict (strict-loadable)."""
    params = variables["params"]
    batch_stats = variables.get("batch_stats", {})
    out: Dict[str, np.ndarray] = {}
    for e in rot_mv_entries(backbone_depth, num_iter, share_weights):
        if e.kind == "conv":
            out[f"{e.torch_key}.weight"] = _lookup(params, e.jax_path + ("kernel",)).transpose(3, 2, 0, 1)
        elif e.kind == "linear":
            out[f"{e.torch_key}.weight"] = _lookup(params, e.jax_path + ("kernel",)).T
            out[f"{e.torch_key}.bias"] = _lookup(params, e.jax_path + ("bias",))
        else:
            out[f"{e.torch_key}.weight"] = _lookup(params, e.jax_path + ("scale",))
            out[f"{e.torch_key}.bias"] = _lookup(params, e.jax_path + ("bias",))
            out[f"{e.torch_key}.running_mean"] = _lookup(batch_stats, e.jax_path + ("mean",))
            out[f"{e.torch_key}.running_var"] = _lookup(batch_stats, e.jax_path + ("var",))
            out[f"{e.torch_key}.num_batches_tracked"] = np.asarray(0, dtype=np.int64)
    _, bottleneck = _arch_info(backbone_depth)
    feat_dim = 512 * (4 if bottleneck else 1)
    out["_feat_extractor.0.fc.weight"] = np.zeros((1000, feat_dim), np.float32)
    out["_feat_extractor.0.fc.bias"] = np.zeros((1000,), np.float32)
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def read_checkpoint(path: str) -> Dict[str, Any]:
    """Read a file written by ``torch.save`` onto the CPU, tensors and plain
    containers only. The format is told from the file's first bytes, not its
    name: a zip archive or a pickle is ``torch.save``'s; anything else (such
    as the JAX package's ``.msgpack``, which the port cannot read yet,
    ROADMAP A9) raises."""
    with open(path, "rb") as f:
        head = f.read(2)
    if not (head == b"PK" or (len(head) == 2 and head[0] == 0x80 and 2 <= head[1] <= 5)):
        raise ValueError(
            f"{path} is not a torch.save file (it starts {head!r}); the JAX "
            f"package's msgpack checkpoints do not load in the port yet"
        )
    return torch.load(path, map_location="cpu", weights_only=True)


def checkpoint_state_dict(ckpt: Mapping[str, Any], prefer_ema: bool = True) -> Dict[str, torch.Tensor]:
    """The model state dict of a checkpoint: a reference ``.pth.tar`` (a
    state dict, or a dict holding one under ``state_dict``) or the port
    Trainer's full state, whose parameter moving average (``ema``, when the
    run kept one) replaces the raw parameters unless ``prefer_ema`` is
    false: the averaged weights are the ones the Trainer evaluates."""
    if "state_dict" not in ckpt:
        return dict(ckpt)
    sd = dict(ckpt["state_dict"])
    if prefer_ema and ckpt.get("ema"):
        sd.update(ckpt["ema"])
    return sd


def load_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The model state dict of the checkpoint at ``path``
    (:func:`read_checkpoint`, :func:`checkpoint_state_dict`)."""
    return checkpoint_state_dict(read_checkpoint(path))
