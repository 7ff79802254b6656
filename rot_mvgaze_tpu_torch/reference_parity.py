"""The four-protocol reference-parity table (port of
``scripts/reference_parity.py``).

The table is the mean angular error (degrees) of ``xgaze2mpiinv_known``,
``xgaze2mpiinv_novel``, ``mpiinv2xgaze_known`` and ``mpiinv2xgaze_novel``:
the port's ``Trainer.test`` from a reference ``.pth.tar`` per protocol
(loaded strictly), over the protocol's test corpus and the reference's
frozen pair index, and optionally the reference's own eval, executed in
place from its checkout over the same corpus and pair index, with each
protocol's delta held to the 0.1 degree budget::

    python -m rot_mvgaze_tpu_torch.reference_parity \\
        --ckpt_dir CKPTS --xgaze_dir XGAZE --mpiinv_dir MPIINV [--run_reference] [--device cpu]

with ``CKPTS/<protocol>.pth.tar`` per protocol (or ``--ckpt
protocol=path``). Subject lists come from ``configs/subject/*.yaml``. The
corpora are read as the command line reads them: packs through the C++
loader where they are usable (``<dir>/_rmgpack/<dataset>``; a machine
without ``h5py`` reads nothing else), else the HDF5 archives. Both routes
give the same table, bit for bit. ``--run_reference --reference_dir DIR``
imports the reference from its checkout at ``DIR``; without
``--reference_dir``, or where ``DIR`` is not a directory, it exits 2. It
runs on the card unless ``--device cpu`` is given.

    python -m rot_mvgaze_tpu_torch.reference_parity --rehearse [--device cpu]

writes two small synthetic corpora as packs (:func:`rehearsal_corpora`),
trains the port's R18 (2 iterations, 32x32, batch 9) for one epoch on the
xgaze corpus, saves its state dict as a ``.pth.tar`` and runs the whole
table from it, with the reference column empty and exit code 0. With
``--run_reference --reference_dir DIR`` the corpora are written as HDF5
archives too, the reference trains the checkpoint, as the JAX script's
rehearsal does, and a delta over 0.1 degree exits 1.

The pair index: one ``random.Random(seed)`` draws the train index, then
the test index, as the reference's globally seeded ``random`` does when it
builds its train dataset before its test dataset; so each protocol builds
both. The reference's test transform (ToTensor, Resize to the eval size,
Normalize) is replaced by an exact stand-in where the stored patches are
at the eval size already (true of the released corpora and the
rehearsal's).
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import random
import sys
import tempfile
from types import SimpleNamespace
from typing import Any, Optional, Tuple

import numpy as np

from rot_mvgaze_tpu_torch.cli.main import DATASET_SPECS, PROJ_DIR

PROTOCOLS = (
    "xgaze2mpiinv_known",
    "xgaze2mpiinv_novel",
    "mpiinv2xgaze_known",
    "mpiinv2xgaze_novel",
)
BUDGET_DEG = 0.1


def protocol_spec(exp_name: str):
    """``exp_name`` -> ``((train_name, train_color), (test_name,
    test_color), cam_train, cam_test)``, the command line's mapping
    (``cli/main.py::configure_dataset``)."""
    dataset_setting, headpose_setting = exp_name.split("_")
    cams = {"known": ("all", "all"), "novel": ("novel_train", "novel_test")}[headpose_setting]
    if dataset_setting not in ("xgaze2mpiinv", "mpiinv2xgaze"):
        raise KeyError(exp_name)
    train, test = DATASET_SPECS[dataset_setting]
    return train, test, cams[0], cams[1]


def load_subjects(dataset_name: str) -> list:
    """The subject archives of ``configs/subject/<dataset_name>.yaml``."""
    from rot_mvgaze_tpu_torch.utils.config import load_yaml

    return list(load_yaml(osp.join(PROJ_DIR, "configs", "subject", f"{dataset_name}.yaml"))["subject"])


# ---------------------------------------------------------------- our side
def protocol_datasets(exp_name: str, roots: dict, subjects: dict, seed: int, packed: bool) -> Tuple[Any, Any]:
    """The protocol's train then test dataset, both indices drawn from one
    ``random.Random(seed)``: ``PackedGazeDataset`` with ``packed``, else
    ``GazeDataset`` over the archives."""
    if packed:
        from rot_mvgaze_tpu_torch.data.native import PackedGazeDataset as Dataset
    else:
        from rot_mvgaze_tpu_torch.data.hdf5 import GazeDataset as Dataset

    spec = protocol_spec(exp_name)
    pair_rng = random.Random(seed)
    return tuple(
        Dataset(name, roots[name], color, subjects[name], camera_tag=cams, seed=seed,
                pairing="reference", pair_rng=pair_rng)
        for (name, color), cams in zip(spec[:2], spec[2:])
    )


def protocol_loaders(exp_name: str, roots: dict, subjects: dict, batch_size: int, seed: int,
                     native_loader: bool = True) -> Tuple[Any, Any, str]:
    """``(train_loader, test_loader, route)``, the command line's choice:
    with ``native_loader`` and the C++ pool, the packs (``route``
    ``"packed"``); otherwise, or where the packs cannot be used, the HDF5
    archives (``"hdf5"``)."""
    from rot_mvgaze_tpu_torch.data.native import NativeBatchLoader, NativePool
    from rot_mvgaze_tpu_torch.data.pipeline import BatchLoader

    if native_loader and NativePool.available():
        try:
            train, test = protocol_datasets(exp_name, roots, subjects, seed, packed=True)
            return (NativeBatchLoader(train, batch_size, shuffle=True, seed=seed, drop_last=True),
                    NativeBatchLoader(test, batch_size), "packed")
        except (OSError, ValueError, ImportError) as e:
            print(f"packed corpus unavailable ({e!r}); using the HDF5 archives", flush=True)
    train, test = protocol_datasets(exp_name, roots, subjects, seed, packed=False)
    return (BatchLoader(train, batch_size=batch_size, shuffle=True, seed=seed, drop_last=True),
            BatchLoader(test, batch_size=batch_size), "hdf5")


def _close(*loaders: Any) -> None:
    for loader in loaders:
        close = getattr(loader.dataset, "close", None)
        if close is not None:
            close()


def run_our_eval(
    exp_name: str,
    ckpt: str,
    roots: dict,
    subjects: dict,
    model_cfg: dict,
    image_size: int,
    batch_size: int,
    seed: int,
    out_dir: str,
    device: Any = "cuda",
    native_loader: bool = True,
) -> float:
    """The port's ``--mode test`` over the protocol's corpus and frozen pair
    index: ``Trainer.test(-1)`` from ``ckpt`` (``ckpt_resume``, a strict
    load), float32, with explicit subject lists so that one function serves
    the released and the rehearsal corpora."""
    from rot_mvgaze_tpu_torch.losses import IterationLoss, StereoL1Loss
    from rot_mvgaze_tpu_torch.models import FeatRotationSymm
    from rot_mvgaze_tpu_torch.train import Trainer

    train_loader, test_loader, route = protocol_loaders(exp_name, roots, subjects, batch_size, seed,
                                                        native_loader)
    print(f"[{exp_name}] {route} corpus: {len(test_loader.dataset)} test pairs", flush=True)
    cfg = SimpleNamespace(
        mode="test", exp_name=exp_name, output_dir=out_dir, ckpt_resume=ckpt, print_freq=10**9,
        seed=seed, batch_size=batch_size, test_batch_size=batch_size, epochs=1, save_epoch=10**9,
        image_size=image_size, scheduler_step="epoch",
    )
    metrics = IterationLoss(StereoL1Loss(rel_weight=0.01), iter_decay=0.5)
    try:
        trainer = Trainer(cfg, FeatRotationSymm(**model_cfg), metrics, train_loader, test_loader,
                          device=device)
        return float(trainer.test(-1))
    finally:
        _close(train_loader, test_loader)


# ---------------------------------------------------------- reference side
def _reference_transform(image_size: int):
    """The reference's test transform (ToTensor, Resize, Normalize) for
    patches stored at the eval size, where Resize is the identity."""
    import torch

    mean = torch.tensor([0.485, 0.456, 0.406]).view(3, 1, 1)
    std = torch.tensor([0.229, 0.224, 0.225]).view(3, 1, 1)

    def transform(img_uint8_hwc):
        if img_uint8_hwc.shape[:2] != (image_size, image_size):
            raise ValueError(f"stored patch is {img_uint8_hwc.shape[:2]}, eval size is {image_size}: "
                             "the identity-Resize stand-in does not apply; store patches at the "
                             "eval size")
        x = torch.from_numpy(np.ascontiguousarray(img_uint8_hwc.transpose(2, 0, 1))).float() / 255.0
        return (x - mean) / std

    return transform


def _reference_modules(reference_dir: str):
    from rot_mvgaze_tpu_torch.compat.reference import (
        import_reference_dataset,
        import_reference_models,
        import_reference_trainer,
    )

    ref_gaze = import_reference_dataset(reference_dir)
    ref_trainer_mod = import_reference_trainer(reference_dir)
    ref_rot_mv, _ = import_reference_models(reference_dir)
    import losses.stereo_loss as ref_stereo  # type: ignore

    return ref_gaze, ref_trainer_mod, ref_rot_mv, ref_stereo


def _reference_trainer(reference_dir: str, model_cfg: dict, train_ds, test_ds, batch_size: int,
                       seed: int, out_dir: str):
    from torch.utils.data import DataLoader

    _, ref_trainer_mod, ref_rot_mv, ref_stereo = _reference_modules(reference_dir)
    metrics = ref_stereo.IterationLoss(
        loss=ref_stereo.StereoL1Loss(rel_weight=0.01, reference_decay=1.0,
                                     distance_metric="angular_error", pred_gaze_key="pred_gaze"),
        iter_decay=0.5,
    )
    config = SimpleNamespace(ckpt_resume=None, batch_size=batch_size, output_dir=out_dir,
                             print_freq=10**9, save_epoch=10**9, seed=seed)
    return ref_trainer_mod.Trainer(
        config=config, model=ref_rot_mv.FeatRotationSymm(**model_cfg), metrics=metrics,
        train_loader=DataLoader(train_ds, batch_size=batch_size, shuffle=True, num_workers=0),
        test_loader=DataLoader(test_ds, batch_size=batch_size, shuffle=False, num_workers=0),
    )


def _seed_globals(seed: int) -> None:
    import torch

    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def run_reference_eval(
    exp_name: str,
    ckpt: str,
    roots: dict,
    subjects: dict,
    model_cfg: dict,
    image_size: int,
    batch_size: int,
    seed: int,
    out_dir: str,
    reference_dir: str,
) -> float:
    """The reference's own eval (its ``Trainer.test``), executed in place on
    the CPU: its global generators seeded, then its train dataset and its
    test dataset built, in that order, as its ``main.py`` does."""
    import torch

    ref_gaze = _reference_modules(reference_dir)[0]
    (train_name, train_color), (test_name, test_color), cam_train, cam_test = protocol_spec(exp_name)
    _seed_globals(seed)
    transform = _reference_transform(image_size)
    ref_train = ref_gaze.GazeDataset(
        dataset_name=train_name, dataset_path=roots[train_name], color_type=train_color,
        image_transform=transform, keys_to_use=subjects[train_name], camera_tag=cam_train, stereo=True,
    )
    ref_test = ref_gaze.GazeDataset(
        dataset_name=test_name, dataset_path=roots[test_name], color_type=test_color,
        image_transform=transform, keys_to_use=subjects[test_name], camera_tag=cam_test, stereo=True,
    )
    trainer = _reference_trainer(reference_dir, model_cfg, ref_train, ref_test, batch_size, seed, out_dir)
    trainer.model.load_state_dict(torch.load(ckpt, map_location="cpu", weights_only=True), strict=True)
    return float(trainer.test(-1))


# ------------------------------------------------------------- rehearsal
def rehearsal_corpora(work_dir: str, image_size: int, seed: int = 0, learnable: bool = False,
                      archives: bool = False) -> Tuple[dict, dict]:
    """The rehearsal's two synthetic corpora under ``work_dir/{xgaze,mpiinv}``,
    2 subjects x 3 frames x 18 cameras each (xgaze BGR, mpiinv RGB), as
    packs; with ``archives`` (for the reference, which reads HDF5; needs
    ``h5py``) as HDF5 archives too, written first so that the packs are
    current. Returns ``(roots, subjects)``."""
    from rot_mvgaze_tpu_torch.data.synthetic import write_synthetic_corpus, write_synthetic_dataset

    roots, subjects = {}, {}
    for name, color, tag in (("xgaze", "bgr", "x"), ("mpiinv", "rgb", "m")):
        roots[name] = osp.join(work_dir, name)
        os.makedirs(roots[name], exist_ok=True)
        names = [f"{tag}00.h5", f"{tag}01.h5"]
        if archives:
            write_synthetic_dataset(roots[name], names, n_frames=3, image_size=image_size, seed=seed,
                                    learnable=learnable)
        subjects[name] = write_synthetic_corpus(roots[name], names, n_frames=3, image_size=image_size,
                                                seed=seed, learnable=learnable, dataset_name=name,
                                                color_type=color)
    return roots, subjects


def build_rehearsal_assets(
    work_dir: str,
    model_cfg: dict,
    image_size: int,
    batch_size: int,
    seed: int,
    device: Any = "cuda",
    reference_dir: Optional[str] = None,
) -> Tuple[dict, dict, dict]:
    """:func:`rehearsal_corpora` (HDF5 archives too, given
    ``reference_dir``) and one checkpoint for all four protocols (eval parity
    does not depend on which protocol trained the weights): the port's model
    trained one epoch on the xgaze corpus, or, given ``reference_dir``, the
    reference's, as the JAX script's rehearsal does. Returns ``(roots,
    subjects, {protocol: checkpoint})``."""
    import torch

    roots, subjects = rehearsal_corpora(work_dir, image_size, archives=reference_dir is not None)
    ckpt = osp.join(work_dir, "rehearsal.pth.tar")
    out_dir = osp.join(work_dir, "rehearsal_train_logs")
    os.makedirs(out_dir, exist_ok=True)
    if reference_dir is not None:
        ref_gaze = _reference_modules(reference_dir)[0]
        _seed_globals(seed)
        train_ds = ref_gaze.GazeDataset(
            dataset_name="xgaze", dataset_path=roots["xgaze"], color_type="bgr",
            image_transform=_reference_transform(image_size), keys_to_use=subjects["xgaze"],
            camera_tag="all", stereo=True,
        )
        trainer = _reference_trainer(reference_dir, model_cfg, train_ds, train_ds, batch_size, seed, out_dir)
        trainer.train_one_epoch(0)
        torch.save(trainer.model.state_dict(), ckpt)
        return roots, subjects, {p: ckpt for p in PROTOCOLS}

    from rot_mvgaze_tpu_torch.losses import IterationLoss, StereoL1Loss
    from rot_mvgaze_tpu_torch.models import FeatRotationSymm
    from rot_mvgaze_tpu_torch.train import Trainer

    # the xgaze corpus as a known-camera protocol's train split
    train_loader, test_loader, _ = protocol_loaders("xgaze2mpiinv_known", roots, subjects, batch_size, seed)
    cfg = SimpleNamespace(mode="train", output_dir=out_dir, ckpt_resume=None, print_freq=10**9,
                          seed=seed, batch_size=batch_size, epochs=1, save_epoch=10**9,
                          image_size=image_size, scheduler_step="epoch")
    torch.manual_seed(seed)
    try:
        trainer = Trainer(cfg, FeatRotationSymm(**model_cfg),
                          IterationLoss(StereoL1Loss(rel_weight=0.01), iter_decay=0.5),
                          train_loader, None, device=device)
        trainer.train_one_epoch(0)
    finally:
        _close(train_loader, test_loader)
    torch.save({k: v.detach().cpu() for k, v in trainer.model.state_dict().items()}, ckpt)
    return roots, subjects, {p: ckpt for p in PROTOCOLS}


# ------------------------------------------------------------------ main
def format_table(rows: list) -> str:
    """The table as Markdown, an empty reference column as a dash."""
    fmt = lambda v: "—" if v is None else f"{v:.4f}"  # noqa: E731
    lines = ["| Protocol | reference (deg) | ours (deg) | delta (deg) |", "|---|---|---|---|"]
    lines += [f"| {r['protocol']} | {fmt(r['reference_deg'])} | {fmt(r['ours_deg'])} | "
              f"{fmt(r['delta_deg'])} |" for r in rows]
    return "\n".join(lines)


def get_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ckpt_dir", default=None, help="directory with <protocol>.pth.tar checkpoints")
    ap.add_argument("--ckpt", action="append", default=[], metavar="PROTOCOL=PATH",
                    help="per-protocol checkpoint override (repeatable)")
    ap.add_argument("--xgaze_dir", default=None, help="XGaze root (archives or _rmgpack/xgaze packs)")
    ap.add_argument("--mpiinv_dir", default=None, help="MPII-NV root (archives or _rmgpack/mpiinv packs)")
    ap.add_argument("--run_reference", action="store_true",
                    help="also run the reference's eval in place (needs --reference_dir and h5py)")
    ap.add_argument("--rehearse", action="store_true",
                    help="the whole chain on synthetic corpora and a checkpoint trained here")
    ap.add_argument("--protocols", nargs="+", default=list(PROTOCOLS), choices=list(PROTOCOLS))
    ap.add_argument("--backbone_depth", type=int, default=50)
    ap.add_argument("--num_iter", type=int, default=3)
    ap.add_argument("--image_size", type=int, default=224)
    ap.add_argument("--batch_size", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="also write the table as JSON here")
    ap.add_argument("--reference_dir", default=None,
                    help="the reference's checkout, for --run_reference")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    return ap


def main(argv=None) -> int:
    ap = get_parser()
    args = ap.parse_args(argv)
    from rot_mvgaze_tpu_torch.compat.reference import reference_available
    from rot_mvgaze_tpu_torch.utils.device import resolve_device

    if args.run_reference and args.reference_dir is None:
        ap.error("--run_reference needs --reference_dir, the reference's checkout")
    if args.run_reference and not reference_available(args.reference_dir):
        ap.error(f"--run_reference needs the reference's checkout, and {args.reference_dir} is not a "
                 f"directory")
    model_cfg = dict(backbone_depth=args.backbone_depth, num_iter=args.num_iter, share_weights=False,
                     encode_rotmat=False, share_feature=False, ignore_rotmat=False)
    if args.rehearse:
        # small enough for minutes on a CPU, large enough to train
        args.image_size, args.batch_size = 32, 9
        model_cfg.update(backbone_depth=18, num_iter=2)
    else:
        if not (args.xgaze_dir and args.mpiinv_dir):
            ap.error("--xgaze_dir and --mpiinv_dir are required (or --rehearse)")
        overrides = dict(kv.split("=", 1) for kv in args.ckpt)
        unknown = set(overrides) - set(PROTOCOLS)
        if unknown:
            ap.error(f"unknown protocol(s) in --ckpt: {sorted(unknown)}")
        ckpts = {}
        for p in args.protocols:
            path = overrides.get(p, osp.join(args.ckpt_dir or "", f"{p}.pth.tar"))
            if not osp.isfile(path):
                ap.error(f"no checkpoint for {p}: {path} (use --ckpt_dir with <protocol>.pth.tar files "
                         f"or --ckpt {p}=PATH)")
            ckpts[p] = path
    device = resolve_device(args.device)
    reference_dir = args.reference_dir if args.run_reference else None

    with tempfile.TemporaryDirectory(prefix="reference_parity_") as work:
        if args.rehearse:
            print(f"[rehearse] building synthetic assets under {work} ...", flush=True)
            roots, subjects, ckpts = build_rehearsal_assets(
                work, model_cfg, args.image_size, args.batch_size, args.seed, device, reference_dir)
        else:
            roots = {"xgaze": args.xgaze_dir, "mpiinv": args.mpiinv_dir}
            subjects = {n: load_subjects(n) for n in ("xgaze", "mpiinv")}
        rows = []
        for p in args.protocols:
            print(f"\n=== {p} (ckpt: {ckpts[p]}) ===", flush=True)
            ref_err = None
            if reference_dir is not None:
                print(f"[{p}] reference eval (executed in place) ...", flush=True)
                ref_err = run_reference_eval(p, ckpts[p], roots, subjects, model_cfg, args.image_size,
                                             args.batch_size, args.seed, osp.join(work, f"ref_{p}"),
                                             reference_dir)
            print(f"[{p}] our eval ...", flush=True)
            our_err = run_our_eval(p, ckpts[p], roots, subjects, model_cfg, args.image_size,
                                   args.batch_size, args.seed, osp.join(work, f"ours_{p}"), device)
            delta = None if ref_err is None else abs(our_err - ref_err)
            rows.append({"protocol": p, "reference_deg": ref_err, "ours_deg": our_err, "delta_deg": delta})

    print("\n" + format_table(rows))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "budget_deg": BUDGET_DEG, "rehearsal": bool(args.rehearse),
                       "device": str(device)}, f, indent=2)
        print(f"\nwrote {args.out}")
    bad = [r["protocol"] for r in rows if r["delta_deg"] is not None and r["delta_deg"] > BUDGET_DEG]
    if bad:
        print(f"\nPARITY VIOLATED (>{BUDGET_DEG} deg): {bad}", file=sys.stderr)
        return 1
    if reference_dir is not None:
        print(f"\nall protocols within the {BUDGET_DEG} deg budget")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
