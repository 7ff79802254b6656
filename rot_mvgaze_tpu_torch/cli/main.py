"""The port's command line (port of ``rot_mvgaze_tpu/cli/main.py``), flag
for flag the JAX package's::

    python -m rot_mvgaze_tpu_torch --exp_name {xgaze2mpiinv,mpiinv2xgaze,xgaze,mpiinv}_{known,novel} \\
        --mode {train,test} [--ckpt_resume PATH] [--batch_size N] ... [--device cpu]

It runs on the card (``--device cuda``, the default, raises without one)
unless ``--device cpu`` is given, the one flag the JAX command line lacks.
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
read. Options the port does not have yet are refused there too, each
naming its ``ROADMAP.md`` item; ``--use_pallas_fusion`` and
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
    p.add_argument("--bn_stat_subsample", type=int, default=1, help="not ported: only 1")
    p.add_argument("--freeze_bn", type=str2bool, default=False,
                   help="normalise with running statistics during training (a warm-start recipe)")
    p.add_argument("--ema_decay", type=float, default=0.0,
                   help="moving average of the weights (0 disables); evaluation and "
                        "--export_torch use it")
    p.add_argument("--remat", type=str2bool, default=False, help="not ported: only false")
    p.add_argument("--grad_accum", type=int, default=1,
                   help="micro-batches per update (batch_size is the update's batch)")
    p.add_argument("--fuse_views", type=str2bool, default=False,
                   help="both views through the backbone as one batch in training too (merges "
                        "the views' BatchNorm statistics)")
    p.add_argument("--weights_only", type=str2bool, default=False,
                   help="load only the weights (the moving average when there is one) from "
                        "--ckpt_resume, with a fresh optimizer")
    p.add_argument("--auto_resume_dir", type=str, default=None,
                   help="resume from the newest .pth.tar in this directory")
    p.add_argument("--keep_last_n", type=int, default=0,
                   help="retain only the newest N checkpoints (0 = keep all)")
    p.add_argument("--export_torch", type=str, default=None,
                   help="after the run, save the bare reference state dict to this path")
    p.add_argument("--dp", type=str2bool, default=True,
                   help="data parallelism is not ported: one card trains the global batch")
    p.add_argument("--spatial_partition", type=int, default=1, help="not ported: only 1")
    p.add_argument("--pairing", type=str, default="reference", choices=["reference", "rng"],
                   help="'reference': the reference's frozen pair index bit for bit; 'rng': a "
                        "seeded numpy generator")
    p.add_argument("--test_breakdown", type=str2bool, default=False,
                   help="in test mode, also report per-camera and per-subject error")
    p.add_argument("--xla_compiler_options", type=str, default=None,
                   help="no counterpart in the port: refused")
    p.add_argument("--profile_steps", type=int, default=0, help="not ported: only 0")
    p.add_argument("--profile_dir", type=str, default=None, help="not ported")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    return p


def unported_options(config: Any) -> list:
    """The options ``config`` sets that the port does not have, each with
    the ``ROADMAP.md`` item that holds it."""
    refused = [
        ("--bn_stat_subsample > 1 (ROADMAP A17)", config.bn_stat_subsample > 1),
        ("--remat (ROADMAP A18)", config.remat),
        ("--spatial_partition > 1 (ROADMAP A13)", config.spatial_partition > 1),
        ("--use_pallas_bn residual (ROADMAP North star: on the card every train-mode BN runs "
         "the port's kernels)", config.use_pallas_bn == "residual"),
        ("--profile_steps/--profile_dir (ROADMAP A19)",
         bool(config.profile_steps) or config.profile_dir is not None),
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


def build_loaders(config: Any) -> Tuple[Any, Any]:
    """The train and test loaders of ``config``: with ``native_loader``, the
    packs through ``NativeBatchLoader`` over the C++ pool; without ``g++``,
    or if the packs cannot be used, the HDF5 archives through
    ``BatchLoader``, as the JAX command line falls back. Which path serves
    is printed. V-view batches (``--num_views > 2``) come from the HDF5
    archives, as in the JAX command line: the packs hold stereo pairs."""
    from rot_mvgaze_tpu_torch.data.native import NativeBatchLoader, NativePool
    from rot_mvgaze_tpu_torch.data.pipeline import BatchLoader

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
            loaders = (NativeBatchLoader(train_ds, config.batch_size, shuffle=True, seed=config.seed,
                                         drop_last=True),
                       NativeBatchLoader(test_ds, config.test_batch_size))
            print("using native packed-cache loader (C++ pool)", flush=True)
            return loaders
        except (OSError, ValueError, ImportError) as e:
            print(f"native loader unavailable ({e!r}); using the h5py loader", flush=True)
    train_ds, test_ds = configure_dataset(config.exp_name, data_paths, seed=config.seed,
                                          pairing=config.pairing, n_views=config.num_views)
    return (BatchLoader(train_ds, batch_size=config.batch_size, shuffle=True, seed=config.seed,
                        drop_last=True, num_threads=config.num_workers),
            BatchLoader(test_ds, batch_size=config.test_batch_size, shuffle=False,
                        num_threads=config.num_workers))


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


def check_config(config: Any) -> None:
    """The JAX command line's checks, and the refusal of unported options,
    all before any data is read (``SystemExit`` naming the flag)."""
    if config.num_views < 2:
        raise SystemExit(f"--num_views must be >= 2, got {config.num_views}")
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


def build_experiment(config: Any):
    """Datasets, loaders, model, loss and ``Trainer`` of ``config`` (a
    namespace from :func:`get_parser`; the JAX command line's
    ``build_experiment``, on one device)."""
    import torch

    from rot_mvgaze_tpu_torch.losses import IterationLoss, MultiViewL1Loss, StereoL1Loss
    from rot_mvgaze_tpu_torch.models import FeatRotationMultiView, FeatRotationSymm
    from rot_mvgaze_tpu_torch.train import Trainer
    from rot_mvgaze_tpu_torch.utils.device import resolve_device
    from rot_mvgaze_tpu_torch.utils.seed import set_seed

    check_config(config)
    device = resolve_device(config.device)
    if device.type == "cuda" and config.dp and torch.cuda.device_count() > 1:
        print(f"--dp: {torch.cuda.device_count()} cards visible, but data parallelism is not "
              f"ported (ROADMAP A13); training on one card, global batch {config.batch_size}",
              flush=True)
    ga = max(config.grad_accum, 1)
    if ga > 1 and config.batch_size % ga:
        rounded = max(config.batch_size // ga, 1) * ga
        print(f"batch_size {config.batch_size} -> {rounded} (multiple of grad_accum={ga})")
        config.batch_size = rounded
    set_seed(config.seed, "cpu")
    train_loader, test_loader = build_loaders(config)
    if config.num_views > 2:
        model = FeatRotationMultiView(
            backbone_depth=config.backbone_depth, num_iter=config.num_iter,
            share_weights=config.share_weights, ignore_rotmat=config.ignore_rotmat,
        )
        # view 0 weighted 1.0, every partner view reference_decay: StereoL1Loss at V=2
        loss = MultiViewL1Loss(rel_weight=0.01, reference_decay=1.0)
    else:
        model = FeatRotationSymm(
            backbone_depth=config.backbone_depth, num_iter=config.num_iter,
            share_weights=config.share_weights, encode_rotmat=config.encode_rotmat,
            share_feature=config.share_feature, ignore_rotmat=config.ignore_rotmat,
            fuse_views=config.fuse_views,
        )
        loss = StereoL1Loss(rel_weight=0.01, reference_decay=1.0, distance_metric="angular_error")
    metrics = IterationLoss(loss=loss, iter_decay=0.5)
    return Trainer(config, model, metrics, train_loader, test_loader, device=device)


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
