"""Checkpoint conversion and loading (the port's own copy of the key map in
``rot_mvgaze_tpu/compat/torch_convert.py``).

The port's module tree carries the reference checkpoints' names, so a
released ``.pth.tar`` loads with ``load_state_dict(strict=True)`` and needs
no converter (:func:`load_checkpoint`). :func:`state_dict_from_jax` turns the
JAX package's variables, as a tree of numpy arrays, into the same state dict
(:func:`blocks_state_dict_from_jax` does so for the conv block library):

- Dense ``kernel (in, out)``         -> Linear ``weight (out, in)``
- Conv ``kernel (kH, kW, I, O)``     -> Conv2d ``weight (O, I, kH, kW)``
- BN ``scale/bias`` (params), ``mean/var`` (batch_stats)
                                     -> ``weight/bias/running_mean/running_var``
- ``IntensityBatchNorm`` ``running_mean`` (batch_stats)
                                     -> ``_img_fusers.{i}._batchnorm.running_mean``
- plus ``num_batches_tracked`` (zero) per BN and the never-called backbone
  ``fc`` (zeros), which a strict load requires.

The key map covers every ``FeatRotationSymm`` configuration (the 3-layer
fusers of ``encode_rotmat`` and ``share_feature``, ``share_weights``'
aliases), ``FeatRotationMultiView`` (the stereo tree) and, with
``single_view=True``, ``SingleViewGazeNet``.

:func:`read_checkpoint` reads a ``torch.save`` file or the JAX package's
``.msgpack`` (through :mod:`rot_mvgaze_tpu_torch.compat.msgpack`, without
flax), telling the format from the file's contents; :func:`state_from_jax`
turns a parsed JAX checkpoint (bare variables or a full ``TrainState``)
into the port Trainer's checkpoint: the model's state dict, Adam's moments
and counts, the moving average, the step and the epoch position.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from rot_mvgaze_tpu_torch.compat import msgpack

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
    kind: str  # 'conv' | 'bn' | 'linear' | 'intensity_bn'


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
    backbone_depth: Any = 50,
    num_iter: int = 3,
    share_weights: bool = False,
    encode_rotmat: bool = False,
    share_feature: bool = False,
    ignore_rotmat: bool = False,
    single_view: bool = False,
) -> List[Entry]:
    """Key map of ``FeatRotationSymm`` of the given configuration (and of
    ``FeatRotationMultiView``, whose tree is the stereo one):
    ``encode_rotmat`` and ``share_feature`` have 3-layer fusers,
    ``share_feature`` an ``IntensityBatchNorm`` per fuser. With
    ``share_weights`` every iteration index maps to the JAX index-0 module,
    as the reference's aliased ``ModuleList`` emits every index.
    ``ignore_rotmat`` changes no key. ``single_view``: the key map of
    ``SingleViewGazeNet`` (backbone and a 2-layer ``gaze_estimator``)."""
    entries = _resnet_entries(backbone_depth, "_feat_extractor.0.", ("backbone",))
    if single_view:
        return entries + _mlp_entries("_gaze_estimator.", ("gaze_estimator",), 2)
    entries += _mlp_entries("_lifter._lifter.", ("lifter", "lifter"), 2)
    fuser_layers = 3 if (encode_rotmat or share_feature) else 2
    for i in range(num_iter):
        j = 0 if share_weights else i
        entries += _mlp_entries(f"_img_fusers.{i}._fuser.", (f"img_fuser_{j}", "fuser"), fuser_layers)
        if share_feature:
            entries.append(Entry(f"_img_fusers.{i}._batchnorm", (f"img_fuser_{j}", "batchnorm"),
                                 "intensity_bn"))
        entries += _mlp_entries(f"_gaze_estimators.{i}.", (f"gaze_estimator_{j}",), 2)
    return entries


def conv_entries(backbone_depth: Any = 50) -> List[Entry]:
    """The backbone's convolutions in every model's key map: where a conv's
    int8 activation range lives in both packages (``<torch_key>.act_amax``
    here, ``quant/<jax_path>/act_amax`` in the JAX package's calibration
    files)."""
    return [e for e in _resnet_entries(backbone_depth, "_feat_extractor.0.", ("backbone",)) if e.kind == "conv"]


def _lookup(tree: Mapping[str, Any], path: Sequence[str]) -> np.ndarray:
    node: Any = tree
    for p in path:
        node = node[p]
    if isinstance(node, torch.Tensor):  # a bfloat16 leaf: widened to float32, exactly
        return node.float().numpy()
    return np.asarray(node)


def state_dict_from_jax(
    variables: Mapping[str, Any], backbone_depth: Any = 50, **config: Any
) -> Dict[str, torch.Tensor]:
    """The JAX package's ``{"params", "batch_stats"}`` tree of numpy arrays
    -> the port's state dict (strict-loadable) of the model ``config``
    describes (:func:`rot_mv_entries`' flags)."""
    params = variables["params"]
    batch_stats = variables.get("batch_stats", {})
    out: Dict[str, np.ndarray] = {}
    for e in rot_mv_entries(backbone_depth, **config):
        if e.kind == "intensity_bn":
            out[f"{e.torch_key}.running_mean"] = _lookup(batch_stats, e.jax_path + ("running_mean",))
        elif e.kind == "conv":
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


def blocks_state_dict_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's ``Conv2dNet`` / ``Conv2dTransposeNet`` variables
    (``conv_{i}`` or ``convt_{i}`` kernels and biases, ``bn_{i}`` scales,
    biases and batch statistics; numpy leaves) -> the state dict of the
    port's ``models.blocks`` counterpart: ``blocks.{i}.0`` the layer,
    ``blocks.{i}.1`` its BatchNorm2d. A Conv kernel ``(kH, kW, I, O)`` is
    Conv2d's ``(O, I, kH, kW)``; a ConvTranspose kernel in flax's
    ``transpose_kernel`` layout ``(kH, kW, O, I)`` is ConvTranspose2d's
    ``(I, O, kH, kW)``: the same axis order either way."""
    params = variables["params"]
    batch_stats = variables.get("batch_stats", {})
    out: Dict[str, np.ndarray] = {}
    for name, leaves in params.items():
        kind, i = name.rsplit("_", 1)
        if kind in ("conv", "convt"):
            out[f"blocks.{i}.0.weight"] = np.asarray(leaves["kernel"]).transpose(3, 2, 0, 1)
            out[f"blocks.{i}.0.bias"] = np.asarray(leaves["bias"])
        elif kind == "bn":
            out[f"blocks.{i}.1.weight"] = np.asarray(leaves["scale"])
            out[f"blocks.{i}.1.bias"] = np.asarray(leaves["bias"])
            out[f"blocks.{i}.1.running_mean"] = np.asarray(batch_stats[name]["mean"])
            out[f"blocks.{i}.1.running_var"] = np.asarray(batch_stats[name]["var"])
            out[f"blocks.{i}.1.num_batches_tracked"] = np.asarray(0, dtype=np.int64)
        else:
            raise ValueError(f"not a block of Conv2dNet or Conv2dTransposeNet: {name}")
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def read_checkpoint(path: str) -> Dict[str, Any]:
    """Read a checkpoint onto the CPU, telling the format from the file's
    first bytes, not its name: a zip archive, or a pickle (``0x80`` then its
    protocol, 2 to 5), is ``torch.save``'s (tensors and plain containers
    only); a map whose first key is a string (``0x80 + n`` then a string's
    type byte) is the JAX package's msgpack, returned as the tree flax
    reads (numpy leaves). Anything else raises ``ValueError``."""
    with open(path, "rb") as f:
        head = f.read(2)
    if head == b"PK" or (len(head) == 2 and head[0] == 0x80 and 2 <= head[1] <= 5):
        return torch.load(path, map_location="cpu", weights_only=True)
    is_map, why = msgpack.looks_like_msgpack_map(head)
    if not is_map:
        raise ValueError(f"{path} is not a torch.save file nor a msgpack checkpoint "
                         f"(it starts {head!r}: {why})")
    return msgpack.load(path)


def is_jax_tree(ckpt: Any) -> bool:
    """Whether a read checkpoint is the JAX package's (``params`` at the top
    rather than the port's ``state_dict`` or a bare reference state dict)."""
    return isinstance(ckpt, dict) and "params" in ckpt and isinstance(ckpt["params"], dict)


#: the model attributes that select a key map (rot_mv_entries' flags)
MODEL_FLAGS = ("backbone_depth", "num_iter", "share_weights", "encode_rotmat", "share_feature",
               "ignore_rotmat")


def model_config(model: Any) -> Dict[str, Any]:
    """The key-map flags of a port model (``FeatRotationSymm``,
    ``FeatRotationMultiView``), from its attributes."""
    return {k: getattr(model, k) for k in MODEL_FLAGS if hasattr(model, k)}


def _parameters(converted: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The parameters of a converted state dict (no BN buffers)."""
    buffers = ("running_mean", "running_var", "num_batches_tracked")
    return {k: v for k, v in converted.items() if not k.endswith(buffers)}


def state_from_jax(
    tree: Mapping[str, Any],
    param_names: Optional[Sequence[str]] = None,
    **config: Any,
) -> Dict[str, Any]:
    """A parsed JAX checkpoint (``variables_from_tree``'s input: ``params``,
    ``batch_stats``, and in a full ``TrainState`` ``opt_state``, ``step``,
    optional ``ema_params`` and ``epoch_meta``) as the port Trainer's
    checkpoint (``train/checkpoints.py``):

    - ``state_dict``: the raw parameters and BN statistics
      (:func:`state_dict_from_jax`);
    - ``ema``: ``ema_params`` by state-dict key, when the tree has them;
    - for a full state (``opt_state`` in the tree, whatever the file's
      name): ``optimizer``, Adam's ``state`` by index of ``param_names``
      (the model's ``named_parameters()`` order, which is the optimizer's):
      optax's ``scale_by_adam`` ``mu``/``nu`` as ``exp_avg``/``exp_avg_sq``
      with the weights' transposes, ``count`` as ``step``; parameters JAX
      does not have (the backbone's never-called ``fc``) get no state, as
      Adam gives none to a parameter without a gradient. ``step`` and
      ``epoch_meta`` (when saved) as they are.

    ``config`` holds :func:`rot_mv_entries`' flags (``backbone_depth``,
    ``num_iter``, ``share_weights``, the ablations), as :func:`model_config`
    reads them. A tree with ``params`` and no ``batch_stats`` is refused: pairing
    trained weights with initial BN statistics would evaluate garbage."""
    if "params" not in tree:
        raise ValueError(f"checkpoint has no 'params': {list(tree)}")
    if not tree.get("batch_stats"):
        raise ValueError("checkpoint has no 'batch_stats' but the model uses BatchNorm; refusing to "
                         "pair trained params with freshly initialised statistics")
    batch_stats = tree["batch_stats"]
    out: Dict[str, Any] = {"state_dict": state_dict_from_jax(tree, **config)}
    if tree.get("ema_params") is not None:
        out["ema"] = _parameters(state_dict_from_jax(
            {"params": tree["ema_params"], "batch_stats": batch_stats}, **config))
    if "opt_state" not in tree:
        return out
    if param_names is None:
        raise ValueError("a full JAX state needs param_names (the model's named_parameters order)")
    adam = [s for s in tree["opt_state"].values() if isinstance(s, dict) and "mu" in s]
    if len(adam) != 1:
        raise ValueError("opt_state holds no single scale_by_adam state (count, mu, nu)")
    adam = adam[0]
    mu = state_dict_from_jax({"params": adam["mu"], "batch_stats": batch_stats}, **config)
    nu = state_dict_from_jax({"params": adam["nu"], "batch_stats": batch_stats}, **config)
    count = torch.tensor(float(np.asarray(adam["count"])))
    out["optimizer"] = {"state": {
        i: {"step": count.clone(), "exp_avg": mu[n], "exp_avg_sq": nu[n]}
        for i, n in enumerate(param_names) if not n.startswith("_feat_extractor.0.fc.")
    }}
    out["step"] = int(np.asarray(tree["step"]))
    if tree.get("epoch_meta") is not None:
        out["epoch_meta"] = {k: int(v) for k, v in tree["epoch_meta"].items()}
    return out


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


def load_checkpoint(
    path: str, backbone_depth: Any = 50, num_iter: int = 3, share_weights: bool = False,
    **config: Any,
) -> Dict[str, torch.Tensor]:
    """The model state dict of the checkpoint at ``path``
    (:func:`read_checkpoint`, :func:`checkpoint_state_dict`); a JAX
    checkpoint is converted for the model of the given configuration
    (``config``: the ablation flags of :func:`rot_mv_entries`), its moving
    average preferred."""
    ckpt = read_checkpoint(path)
    if is_jax_tree(ckpt):  # the weights alone: no optimizer state to convert
        weights = {k: v for k, v in ckpt.items() if k != "opt_state"}
        ckpt = state_from_jax(weights, backbone_depth=backbone_depth, num_iter=num_iter,
                              share_weights=share_weights, **config)
    return checkpoint_state_dict(ckpt)
