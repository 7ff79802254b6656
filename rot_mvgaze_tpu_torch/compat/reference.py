"""Import the reference implementation (the upstream PyTorch code base) in
place, for ``reference_parity --run_reference``.

The reference imports several packages it never uses on the eval path
(albumentations, omegaconf, torchvision, torchsummary, ...). The real module
is imported where it is installed; only the missing ones are stubbed, then
the reference's own modules are imported from its checkout and run as they
are: nothing of the reference is copied. ``h5py`` must be the real one (the
reference's dataset reads its archives).
"""

from __future__ import annotations

import os
import sys
import types

# modules the reference imports; stubbed only where not installed
_MAYBE_STUB_MODULES = [
    "albumentations",
    "cv2",
    "h5py",
    "omegaconf",
    "torchsummary",
    "torchvision",
    "torchvision.models",
    "torchvision.transforms",
    "torchvision.utils",
    "rich",
    "rich.progress",
    "tqdm",
]


def reference_available(reference_dir: str) -> bool:
    """Whether ``reference_dir`` holds a checkout to import."""
    return os.path.isdir(reference_dir)


def _install_stubs() -> None:
    for name in _MAYBE_STUB_MODULES:
        if name in sys.modules:
            continue
        try:
            __import__(name)
            continue
        except ImportError:
            pass
        mod = types.ModuleType(name)
        if name == "omegaconf":
            class _OmegaConf:  # the surface the reference's trainer touches
                @staticmethod
                def save(config, path):
                    with open(path, "w") as f:
                        f.write(repr(config))

                @staticmethod
                def create(obj=None):
                    return obj

            mod.OmegaConf = _OmegaConf
            mod.ListConfig = object
            mod.DictConfig = object
        if name == "torchsummary":
            mod.summary = lambda *a, **kw: None
        if name == "torchvision.utils":
            mod.make_grid = lambda *a, **kw: None
        if name == "rich.progress":
            mod.track = lambda x, **kw: x
        if name == "tqdm":
            mod.tqdm = lambda x, **kw: x
        sys.modules[name] = mod
    for parent, child in (("torchvision", "models"), ("torchvision", "transforms"),
                          ("torchvision", "utils"), ("rich", "progress")):
        full = f"{parent}.{child}"
        if parent in sys.modules and full in sys.modules and not hasattr(sys.modules[parent], child):
            setattr(sys.modules[parent], child, sys.modules[full])


def _enter(reference_dir: str) -> None:
    if not reference_available(reference_dir):
        raise FileNotFoundError(f"no reference checkout at {reference_dir}")
    _install_stubs()
    if reference_dir not in sys.path:
        sys.path.insert(0, reference_dir)


def import_reference_models(reference_dir: str):
    """The reference's ``models.rot_mv`` and ``models.resnet``, with the
    backbone constructors it calls swapped for ``pretrained=False`` ones (it
    asks for ImageNet weights, a download)."""
    _enter(reference_dir)
    import models.resnet as ref_resnet  # type: ignore
    import models.rot_mv as ref_rot_mv  # type: ignore

    ref_rot_mv.resnet18 = lambda pretrained=True: ref_resnet.resnet18(False)
    ref_rot_mv.resnet50 = lambda pretrained=True: ref_resnet.resnet50(False)
    return ref_rot_mv, ref_resnet


def import_reference_dataset(reference_dir: str):
    """The reference's ``dataset.gaze``, over the real ``h5py``."""
    import h5py  # noqa: F401  (the real module, not a stub)

    _enter(reference_dir)
    import dataset.gaze as ref_gaze  # type: ignore

    return ref_gaze


def import_reference_trainer(reference_dir: str):
    """The reference's ``trainer`` module. Its ``utils.helper`` lacks the
    ``recover_image`` that ``trainer.py`` imports; a no-op of that name is
    put there first."""
    _enter(reference_dir)
    import utils.helper as ref_helper  # type: ignore

    if not hasattr(ref_helper, "recover_image"):
        ref_helper.recover_image = lambda *a, **kw: None
    import trainer as ref_trainer  # type: ignore

    return ref_trainer
