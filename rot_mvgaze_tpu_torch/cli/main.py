"""The port's command line (port of ``rot_mvgaze_tpu/cli/main.py``), flag
for flag the JAX package's::

    python -m rot_mvgaze_tpu_torch --exp_name {xgaze2mpiinv,mpiinv2xgaze,xgaze,mpiinv}_{known,novel} \\
        --mode {train,test} [--ckpt_resume PATH] [--batch_size N] ... [--device cpu]

It runs on the card (``--device cuda``, the default, raises without one)
unless ``--device cpu`` is given, the one flag the JAX command line lacks.
Under ``torchrun`` it trains data-parallel, one card per process::

    torchrun --nproc_per_node N -m rot_mvgaze_tpu_torch --exp_name ... --dp true

(``--dp false`` with more than one process is refused). The global batch
and the test batch are split over the processes with the JAX command line's
rounding, each process loading its shard (``process_shard``), and rank 0's
output directory is everyone's.
Dataset roots come from ``data_path.yaml`` at the repository root (or
``--data_path``), keys ``xgaze`` and ``mpiinv``; subject lists from
``configs/subject/*.yaml``; both are read by the port's own YAML reader
(``utils/config.py``). With ``--native_loader true`` (the default) batches
come from the packed caches (``data/packed.py``) through the C++ loader
(``data/native.py``), and the pair index is drawn from the packs' row
counts, so a corpus packed elsewhere trains with no ``h5py``.

Every model of the JAX command line is built: the stereo model with its
ablations (``--encode_rotmat``, ``--share_feature``, ``--ignore_rotmat``,
``--share_weights``) and ``--fuse_views``, and with ``--num_views > 2`` the
V-view model, its loss, dataset (HDF5 only, as in JAX) and steps. The
combinations the JAX command line refuses are refused, before any data is
read. ``--bn_stat_subsample``, ``--remat`` and ``--profile_steps`` /
``--profile_dir`` run as in JAX. ``--spatial_partition N`` splits each
image's height over N devices per process (``spatial_mesh``: the cards of
this process's spatial group, or a ``--device`` list such as
``cpu,cpu``), with every option of the stereo model, and data parallelism
over torchrun's processes::

    torchrun --nproc_per_node 2 -m rot_mvgaze_tpu_torch ... --spatial_partition 2   # 4 cards
 Options the port does not have yet are
refused before any data is read too, each naming its ``ROADMAP.md`` item; ``--use_pallas_fusion`` and
``--use_pallas_bn true|false`` parse, so JAX command lines run, and change
nothing: on the card the port always runs its kernels.
"""

from __future__ import annotations

import argparse
import datetime
import os.path as osp
import random
import sys
from types import SimpleNamespace
from typing import Any, Dict, Optional, Tuple

PROJ_DIR = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))

#: exp_name's dataset part -> ((train dataset, colour), (test dataset, colour))
DATASET_SPECS = {
    "xgaze2mpiinv": (("xgaze", "bgr"), ("mpiinv", "rgb")),
    "mpiinv2xgaze": (("mpiinv", "rgb"), ("xgaze", "bgr")),
    "xgaze": (("xgaze", "bgr"), ("xgaze", "bgr")),
    "mpiinv": (("mpiinv", "rgb"), ("mpiinv", "rgb")),
}


def str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


def backbone_arg(v):
    allowed = {"18", "34", "50", "101", "152", "resnext50_32x4d", "resnext101_32x8d",
               "wide_resnet50_2", "wide_resnet101_2"}
    if str(v) not in allowed:
        raise argparse.ArgumentTypeError(f"backbone must be one of {sorted(allowed)}")
    return int(v) if str(v).isdigit() else str(v)


def pallas_bn_arg(v):
    if str(v).lower() == "residual":
        return "residual"
    return str2bool(v)


def get_parser(**kwargs) -> argparse.ArgumentParser:
    """Every option of the JAX command line, with its aliases, types,
    choices and defaults, and ``--device``."""
    p = argparse.ArgumentParser(**kwargs)
    p.add_argument("--mode", type=str, choices=["train", "test"], default="train")
    p.add_argument("--exp_name", type=str)
    p.add_argument("-out", "--output_dir", type=str, default="./logs")
    # --ckpt_pretrained: the name the reference's README documents
    p.add_argument("--ckpt_resume", "--ckpt_pretrained", dest="ckpt_resume", type=str, default=None,
                   help="checkpoint to start from: the port's .pth.tar, a reference state dict or "
                        "the JAX package's .msgpack (a full state continues its run)")
    p.add_argument("--pretrained_backbone", type=str, default=None,
                   help="torchvision ResNet checkpoint for the backbone, or 'auto' for the file "
                        "in the JAX package's download cache (the port makes no network calls)")
    p.add_argument("--print_freq", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num_workers", type=int, default=8, help="host loader threads")
    p.add_argument("--batch_size", type=int, default=50)
    p.add_argument("--test_batch_size", type=int, default=50)
    p.add_argument("--epochs", type=int, default=15)
    p.add_argument("--save_epoch", type=int, default=10)
    p.add_argument("--backbone_depth", type=backbone_arg, default=50,
                   help="18/34/50/101/152 or a variant name (resnext50_32x4d, resnext101_32x8d, "
                        "wide_resnet50_2, wide_resnet101_2)")
    p.add_argument("--num_iter", type=int, default=3)
    p.add_argument("--num_views", type=int, default=2,
                   help="views per sample: 2 is the reference's stereo protocol; >2 trains the "
                        "V-view model (HDF5 loader)")
    p.add_argument("--share_weights", type=str2bool, default=False)
    p.add_argument("--encode_rotmat", type=str2bool, default=False)
    p.add_argument("--share_feature", type=str2bool, default=False)
    p.add_argument("--ignore_rotmat", type=str2bool, default=False)
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--scheduler_step", type=str, default="epoch", choices=["epoch", "iteration"],
                   help="'epoch' reproduces the reference's per-epoch CyclicLR stepping")
    p.add_argument("--bf16", type=str2bool, default=True,
                   help="bfloat16 autocast in the train step (evaluation always runs float32)")
    p.add_argument("--data_path", type=str, default=None, help="path of data_path.yaml")
    p.add_argument("--native_loader", type=str2bool, default=True,
                   help="packed caches through the C++ loader (the HDF5 loader without g++ or "
                        "if the packs cannot be used)")
    p.add_argument("--use_pallas_fusion", type=str2bool, default=False,
                   help="accepted for JAX command lines; on the card the port always runs its kernels")
    p.add_argument("--use_pallas_bn", type=pallas_bn_arg, default=False,
                   help="accepted for JAX command lines (true/false); 'residual' is refused")
    p.add_argument("--bn_stat_subsample", type=int, default=1,
                   help="train-mode BatchNorm statistics from the batch's first B//k images "
                        "(1: every image)")
    p.add_argument("--freeze_bn", type=str2bool, default=False,
                   help="normalise with running statistics during training (a warm-start recipe)")
    p.add_argument("--ema_decay", type=float, default=0.0,
                   help="moving average of the weights (0 disables); evaluation and "
                        "--export_torch use it")
    p.add_argument("--remat", type=str2bool, default=False,
                   help="recompute each backbone block in the backward (less activation memory)")
    p.add_argument("--grad_accum", type=int, default=1,
                   help="micro-batches per update (batch_size is the update's batch)")
    p.add_argument("--fuse_views", type=str2bool, default=False,
                   help="both views through the backbone as one batch in training too (merges "
                        "the views' BatchNorm statistics)")
    p.add_argument("--weights_only", type=str2bool, default=False,
                   help="load only the weights (the moving average when there is one) from "
                        "--ckpt_resume, with a fresh optimizer")
    p.add_argument("--auto_resume_dir", type=str, default=None,
                   help="resume from the newest checkpoint in this directory (the port's .pth.tar "
                        "or the JAX package's .msgpack)")
    p.add_argument("--keep_last_n", type=int, default=0,
                   help="retain only the newest N checkpoints (0 = keep all)")
    p.add_argument("--export_torch", type=str, default=None,
                   help="after the run, save the bare reference state dict to this path")
    p.add_argument("--dp", type=str2bool, default=True,
                   help="data parallelism over the processes torchrun starts (one card each); "
                        "false is refused with more than one process")
    p.add_argument("--spatial_partition", type=int, default=1,
                   help="split each image's height over N devices per process (halo rows between "
                        "strips); needs --dp true and N devices: under torchrun process r takes "
                        "cards r*N .. r*N+N-1")
    p.add_argument("--pairing", type=str, default="reference", choices=["reference", "rng"],
                   help="'reference': the reference's frozen pair index bit for bit; 'rng': a "
                        "seeded numpy generator")
    p.add_argument("--test_breakdown", type=str2bool, default=False,
                   help="in test mode, also report per-camera and per-subject error")
    p.add_argument("--xla_compiler_options", type=str, default=None,
                   help="no counterpart in the port: refused")
    p.add_argument("--profile_steps", type=int, default=0,
                   help="one torch.profiler trace of this many train steps after the first")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="where the trace goes (default <output_dir>/profile; host_NN per process)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the default; raises without a card), cpu, or a comma-separated list "
                        "of this process's devices for --spatial_partition (repeats allowed: "
                        "cuda:0,cuda:0 is a logical mesh on one card)")
    return p


def unported_options(config: Any) -> list:
    """The options ``config`` sets that the port does not have, each with
    the ``ROADMAP.md`` item that holds it."""
    refused = [
        ("--use_pallas_bn residual (ROADMAP North star: on the card every train-mode BN runs "
         "the port's kernels)", config.use_pallas_bn == "residual"),
        ("--xla_compiler_options (no counterpart in the port)", config.xla_compiler_options is not None),
    ]
    return [flag for flag, on in refused if on]


def _load_subjects(name: str) -> list:
    from rot_mvgaze_tpu_torch.utils.config import load_yaml

    return load_yaml(osp.join(PROJ_DIR, "configs", "subject", f"{name}.yaml"))["subject"]


def _load_data_paths(override: Optional[str]) -> Dict[str, Any]:
    from rot_mvgaze_tpu_torch.utils.config import load_yaml

    return load_yaml(override or osp.join(PROJ_DIR, "data_path.yaml"))


def configure_dataset(
    exp_name: str,
    data_paths: Dict[str, Any],
    seed: int = 0,
    pairing: str = "reference",
    packed: bool = False,
    n_views: int = 2,
) -> Tuple[Any, Any]:
    """``exp_name`` -> ``(train_dataset, test_dataset)``, the JAX command
    line's mapping: ``known`` trains and tests on every camera, ``novel`` on
    the split cameras; XGaze's archives are BGR, MPII-NV's RGB. With
    ``pairing="reference"`` one ``random.Random(seed)`` draws the train
    index, then the test index, as the reference builds them.

    ``packed``: ``PackedGazeDataset``s (the pair index from the packs' row
    counts, which equal the archives', so the index is the HDF5 datasets'
    bit for bit, and no archive is opened where its pack is current);
    otherwise ``GazeDataset``s over the HDF5 archives. ``n_views > 2``:
    ``MultiViewGazeDataset``s over the archives (the V-view index is its
    own seeded draw; ``pairing`` and ``packed`` do not apply)."""
    parts = exp_name.split("_")
    if len(parts) != 2:
        raise NotImplementedError(exp_name)
    dataset_setting, headpose_setting = parts
    if headpose_setting == "known":
        cam_train, cam_test = "all", "all"
    elif headpose_setting == "novel":
        cam_train, cam_test = "novel_train", "novel_test"
    else:
        raise NotImplementedError(exp_name)
    if dataset_setting not in DATASET_SPECS:
        raise NotImplementedError(exp_name)
    if n_views > 2:
        from rot_mvgaze_tpu_torch.data.multiview import MultiViewGazeDataset

        return tuple(
            MultiViewGazeDataset(name, data_paths[name], color, _load_subjects(name),
                                 n_views=n_views, camera_tag=cams, seed=seed)
            for (name, color), cams in zip(DATASET_SPECS[dataset_setting], (cam_train, cam_test))
        )
    if packed:
        from rot_mvgaze_tpu_torch.data.native import PackedGazeDataset as Dataset
    else:
        from rot_mvgaze_tpu_torch.data.hdf5 import GazeDataset as Dataset

    pair_rng = random.Random(seed) if pairing == "reference" else None
    out = []
    for (name, color), cams in zip(DATASET_SPECS[dataset_setting], (cam_train, cam_test)):
        out.append(Dataset(
            dataset_name=name, dataset_path=data_paths[name], color_type=color,
            keys_to_use=_load_subjects(name), camera_tag=cams, stereo=True, seed=seed,
            pairing=pairing, pair_rng=pair_rng,
        ))
    return out[0], out[1]


def build_loaders(config: Any, process_shard: Optional[tuple] = None) -> Tuple[Any, Any]:
    """The train and test loaders of ``config``: with ``native_loader``, the
    packs through ``NativeBatchLoader`` over the C++ pool; without ``g++``,
    or if the packs cannot be used, the HDF5 archives through
    ``BatchLoader``, as the JAX command line falls back. Which path serves
    is printed. V-view batches (``--num_views > 2``) come from the HDF5
    archives, as in the JAX command line: the packs hold stereo pairs.
    ``process_shard=(rank, world)``: each loader yields this process's
    shard of every epoch, in batches of ``batch_size // world`` and
    ``test_batch_size // world``."""
    from rot_mvgaze_tpu_torch.data.native import NativeBatchLoader, NativePool
    from rot_mvgaze_tpu_torch.data.pipeline import BatchLoader

    world = process_shard[1] if process_shard else 1
    bs, test_bs = config.batch_size // world, config.test_batch_size // world

    data_paths = _load_data_paths(config.data_path)
    if config.num_views > 2 and config.native_loader:
        print("V-view mode: using the h5py loader (packed cache is stereo)", flush=True)
    elif config.native_loader and not NativePool.available():
        print("native loader unavailable (no g++?); using the h5py loader", flush=True)
    elif config.native_loader:
        try:
            train_ds, test_ds = configure_dataset(config.exp_name, data_paths, seed=config.seed,
                                                  pairing=config.pairing, packed=True)
            # both built before either is returned: a failure falls back as a pair
            loaders = (NativeBatchLoader(train_ds, bs, shuffle=True, seed=config.seed,
                                         drop_last=True, process_shard=process_shard),
                       NativeBatchLoader(test_ds, test_bs, process_shard=process_shard))
            print("using native packed-cache loader (C++ pool)", flush=True)
            return loaders
        except (OSError, ValueError, ImportError) as e:
            print(f"native loader unavailable ({e!r}); using the h5py loader", flush=True)
    train_ds, test_ds = configure_dataset(config.exp_name, data_paths, seed=config.seed,
                                          pairing=config.pairing, n_views=config.num_views)
    return (BatchLoader(train_ds, batch_size=bs, shuffle=True, seed=config.seed,
                        drop_last=True, num_threads=config.num_workers, process_shard=process_shard),
            BatchLoader(test_ds, batch_size=test_bs, shuffle=False,
                        num_threads=config.num_workers, process_shard=process_shard))


def refused_combinations(config: Any) -> Optional[str]:
    """The JAX command line's refusal of ``config``'s flags, or None: the
    stereo-only options at ``--num_views > 2``, and the model's
    unconstructible combinations at 2."""
    nv = config.num_views
    if nv > 2:
        unsupported = [
            ("--grad_accum > 1", config.grad_accum > 1),
            ("--spatial_partition > 1", config.spatial_partition > 1),
            ("--encode_rotmat", config.encode_rotmat),
            ("--share_feature", config.share_feature),
            ("--use_pallas_fusion", config.use_pallas_fusion),
            ("--use_pallas_bn", bool(config.use_pallas_bn)),
            ("--bn_stat_subsample > 1", config.bn_stat_subsample > 1),
            ("--fuse_views", config.fuse_views),
            # the V-view index is its own seeded draw: no reference pairing to replay
            ("--pairing rng", config.pairing != "reference"),
        ]
        bad = [flag for flag, on in unsupported if on]
        return f"--num_views {nv} does not support: {', '.join(bad)}" if bad else None
    if config.ignore_rotmat and config.encode_rotmat:
        return "--ignore_rotmat cannot be combined with --encode_rotmat"
    if config.share_feature and (config.encode_rotmat or config.share_weights):
        return ("--share_feature cannot be combined with --encode_rotmat or --share_weights (these "
                "combinations crash in the reference model and have no trained counterpart)")
    if config.use_pallas_fusion and (config.ignore_rotmat or config.encode_rotmat
                                     or config.share_feature):
        return ("--use_pallas_fusion covers only the default fuser path; with --ignore_rotmat, "
                "--encode_rotmat or --share_feature the JAX command line refuses it")
    return None


def check_config(config: Any, world: int = 1) -> None:
    """The JAX command line's checks, and the refusal of unported options,
    all before any data is read (``SystemExit`` naming the flag). ``world``:
    the processes the run is started over (torchrun's ``WORLD_SIZE``)."""
    if config.num_views < 2:
        raise SystemExit(f"--num_views must be >= 2, got {config.num_views}")
    if world > 1 and not config.dp:
        raise SystemExit(f"--dp false under {world} processes: each process would train its own "
                         f"model on its shard; start one process, or pass --dp true")
    if config.bn_stat_subsample < 1:
        raise SystemExit(f"--bn_stat_subsample must be >= 1, got {config.bn_stat_subsample}")
    bad = unported_options(config)
    if bad:
        raise SystemExit(f"not ported yet: {', '.join(bad)}")
    refused = refused_combinations(config)
    if refused:
        raise SystemExit(refused)
    if config.freeze_bn:
        inert = [("--use_pallas_bn", bool(config.use_pallas_bn)),
                 ("--bn_stat_subsample > 1", config.bn_stat_subsample > 1),
                 ("--fuse_views", config.fuse_views)]
        bad = [flag for flag, on in inert if on]
        if bad:
            raise SystemExit(f"--freeze_bn uses running-stat (eval-mode) normalization; these "
                             f"train-mode-BN options would be silently inert: {', '.join(bad)}")
    if config.weights_only:
        if not config.ckpt_resume:
            raise SystemExit("--weights_only needs --ckpt_resume CKPT (it changes how that "
                             "checkpoint is loaded)")
        if config.auto_resume_dir:
            raise SystemExit("--weights_only contradicts --auto_resume_dir: auto-resume exists to "
                             "CONTINUE a run (optimizer state + step); a weight-only warm start "
                             "discards exactly that")
    if not 0.0 <= config.ema_decay < 1.0:
        raise SystemExit(f"--ema_decay must be in [0, 1), got {config.ema_decay}")


def spatial_mesh(config: Any, world: int) -> Tuple[Any, list]:
    """This process's mesh for ``--spatial_partition`` (None for 1) and the
    visible devices it leaves idle, with the JAX command line's checks in
    its words (``SystemExit``, before any data is read). The visible devices
    are ``--device``'s (``parallel.visible_devices``); the mesh is ``(data
    1, spatial sp)`` over sp of them: the first sp of a ``--device`` list,
    else under torchrun process r's cards ``r·sp .. r·sp+sp−1``
    (``parallel.global_mesh``), and data parallelism runs over the
    processes."""
    from rot_mvgaze_tpu_torch import parallel

    sp = max(config.spatial_partition, 1)
    visible = parallel.visible_devices(config.device)
    if sp <= 1:
        return None, []
    if not (config.dp and len(visible) > 1):
        raise SystemExit(f"--spatial_partition {sp} needs the mesh path: --dp true and >1 visible "
                         f"device (have {len(visible)})")
    if config.image_size % sp:
        raise SystemExit(f"--spatial_partition {sp} must divide --image_size {config.image_size} "
                         f"(even height shards)")
    listed = "," in config.device
    if listed and len(visible) < sp:
        raise SystemExit(f"--spatial_partition {sp} takes {sp} devices per process, {len(visible)} listed")
    try:
        mesh = parallel.make_mesh(visible[:sp], spatial=sp) if listed else parallel.global_mesh(sp)
    except ValueError as e:
        raise SystemExit(f"--spatial_partition {sp} takes {sp} devices per process: {e}")
    idle = (visible[sp:] if listed else [d for d in visible if d not in mesh.grid[0]]) if world == 1 else []
    return mesh, idle


def build_experiment(config: Any):
    """Datasets, loaders, model, loss and ``Trainer`` of ``config`` (a
    namespace from :func:`get_parser`; the JAX command line's
    ``build_experiment``), on one process or, under torchrun, data-parallel
    over its processes (one card each)."""
    import torch

    from rot_mvgaze_tpu_torch import parallel
    from rot_mvgaze_tpu_torch.losses import IterationLoss, MultiViewL1Loss, StereoL1Loss
    from rot_mvgaze_tpu_torch.models import FeatRotationMultiView, FeatRotationSymm
    from rot_mvgaze_tpu_torch.train import Trainer
    from rot_mvgaze_tpu_torch.utils.device import resolve_device
    from rot_mvgaze_tpu_torch.utils.seed import set_seed

    check_config(config, parallel.configured_world_size())
    device = resolve_device(config.device.split(",")[0])
    mesh, idle = spatial_mesh(config, parallel.configured_world_size())
    sp = max(config.spatial_partition, 1)
    parallel.initialize(device.type, spatial=1 if "," in config.device else sp)
    world = parallel.process_count()
    if mesh is not None:
        device = mesh.first_device
        if idle:
            print(f"{len(idle)} visible device(s) idle ({', '.join(map(str, idle))}): this process "
                  f"takes {sp}; torchrun --nproc_per_node {len(idle) // sp + 1} -m "
                  f"rot_mvgaze_tpu_torch ... --spatial_partition {sp} would use them", flush=True)
    elif device.type == "cuda" and world > 1:
        device = torch.device("cuda", parallel.local_rank())
    elif device.type == "cuda" and torch.cuda.device_count() > 1:
        print(f"{torch.cuda.device_count()} cards visible; this process trains on one (start "
              f"the command line under torchrun --nproc_per_node N for data parallelism)",
              flush=True)
    if world > 1:
        # every process writes under rank 0's (time-stamped) directory
        config.output_dir = parallel.broadcast_object(config.output_dir)
    ga = max(config.grad_accum, 1)
    if world > 1:
        # the batch divides over the ranks; with gradient accumulation each
        # of the A micro-batches must too -> world * A
        for attr, div in (("batch_size", world * ga), ("test_batch_size", world)):
            bs = getattr(config, attr)
            if bs % div:
                rounded = max(bs // div, 1) * div
                print(f"{attr} {bs} -> {rounded} (multiple of {div})")
                setattr(config, attr, rounded)
        print(f"data-parallel: {world} processes, rank {parallel.process_index()} on {device}; "
              f"global batch {config.batch_size}", flush=True)
    elif ga > 1 and config.batch_size % ga:
        rounded = max(config.batch_size // ga, 1) * ga
        print(f"batch_size {config.batch_size} -> {rounded} (multiple of grad_accum={ga})")
        config.batch_size = rounded
    if mesh is not None:
        print(f"data-parallel mesh: {world * sp} devices across {world} process(es), spatial "
              f"partition {sp} (dp {world}); global batch {config.batch_size}", flush=True)
    set_seed(config.seed, "cpu")
    process_shard = (parallel.process_index(), world) if world > 1 else None
    train_loader, test_loader = build_loaders(config, process_shard)
    if config.num_views > 2:
        model = FeatRotationMultiView(
            backbone_depth=config.backbone_depth, num_iter=config.num_iter,
            share_weights=config.share_weights, ignore_rotmat=config.ignore_rotmat,
            remat=config.remat,
        )
        # view 0 weighted 1.0, every partner view reference_decay: StereoL1Loss at V=2
        loss = MultiViewL1Loss(rel_weight=0.01, reference_decay=1.0)
    else:
        model = FeatRotationSymm(
            backbone_depth=config.backbone_depth, num_iter=config.num_iter,
            share_weights=config.share_weights, encode_rotmat=config.encode_rotmat,
            share_feature=config.share_feature, ignore_rotmat=config.ignore_rotmat,
            fuse_views=config.fuse_views, bn_stat_subsample=config.bn_stat_subsample,
            remat=config.remat,
        )
        loss = StereoL1Loss(rel_weight=0.01, reference_decay=1.0, distance_metric="angular_error")
    metrics = IterationLoss(loss=loss, iter_decay=0.5)
    return Trainer(config, model, metrics, train_loader, test_loader, device=device, mesh=mesh)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    parser = get_parser()
    args, unknown = parser.parse_known_args(argv)
    if unknown:
        # tolerated for the reference's command lines, but never silently: a
        # misspelled hyperparameter must not train a long run at defaults
        print(f"WARNING: ignoring unrecognized arguments: {unknown}", file=sys.stderr)
    now = datetime.datetime.now()
    args.output_dir = osp.join(args.output_dir, now.strftime("%Y-%m-%d"), now.strftime("%H-%M-%S"))
    config = SimpleNamespace(**vars(args))
    if not args.exp_name:
        parser.error("--exp_name is required (e.g. xgaze2mpiinv_known)")
    if config.mode == "test" and not (config.ckpt_resume or config.auto_resume_dir):
        parser.error("--mode test requires --ckpt_resume CKPT (or --auto_resume_dir DIR)")
    if config.profile_dir and not config.profile_steps:
        parser.error("--profile_dir requires --profile_steps N (how many steady-state train "
                     "steps to trace)")
    if any(a.split("=")[0] in ("--use_pallas_fusion", "--use_pallas_bn") for a in argv):
        print("--use_pallas_fusion/--use_pallas_bn change nothing here: on the card the port "
              "always runs its kernels", flush=True)

    trainer = build_experiment(config)
    if config.mode == "train":
        trainer.train()
    else:
        trainer.test(-1)
        if config.test_breakdown:
            trainer.test_breakdown()
    if config.export_torch:
        path = trainer.export_torch_checkpoint(config.export_torch)
        print(f"exported reference-format checkpoint: {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
