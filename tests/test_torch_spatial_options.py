"""The port's train step under spatial meshes with every option the JAX
command line takes with ``--spatial_partition``, against the same option
unsharded (port against port, on the CPU; tests/test_torch_spatial.py holds
the strips against JAX): one SGD update of R18 x 1 at 64x64 from seeded
weights, under ``(data 1, spatial 2)`` unless named otherwise.

- ``grad_accum 2``, ``freeze_bn``, ``ema_decay`` (the moving average within
  1e-6 too), ``fuse_views``, ``bn_stat_subsample 2``,
  ``remat``, ``share_feature`` (IntensityBatchNorm after the pool), the
  stereo ablations, and the meshes ``(data 2, spatial 2)`` (in-process
  data replicas) and ``(data 1, spatial 4)``: loss at rtol 1e-5, every
  gradient within atol 1e-5 / rtol 1e-4, BN buffers within 1e-5,
  num_batches_tracked equal.
- With augmentation on, the strips are cut after the draws: the previews
  of both runs are the same bits.
- The eval step under a mesh (a batch the data replicas do not divide is
  padded and trimmed) and ``evaluate_gaze(mesh=)``.
"""

import numpy as np
import pytest
import torch

from rot_mvgaze_tpu_torch.evaluate import evaluate_gaze
from rot_mvgaze_tpu_torch.losses import IterationLoss, StereoL1Loss
from rot_mvgaze_tpu_torch.models import FeatRotationSymm
from rot_mvgaze_tpu_torch.models.resnet import resnet18
from rot_mvgaze_tpu_torch.parallel import make_mesh, with_spatial_floor
from rot_mvgaze_tpu_torch.parallel.spatial import shard_images
from rot_mvgaze_tpu_torch.train import init_ema, make_eval_step, make_train_step

SIZE, BATCH = 64, 4
CFG = {"backbone_depth": 18, "num_iter": 1}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _batch(seed, augmented=True, n=BATCH):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    if augmented:
        imgs = {v: rng.normal(size=(n, SIZE, SIZE, 3)).astype(f32) for v in ("img_0", "img_1")}
    else:
        imgs = {v: rng.integers(0, 256, (n, SIZE + 8, SIZE + 8, 3), dtype=np.uint8) for v in ("img_0", "img_1")}
    return {k: torch.from_numpy(v) for k, v in {
        **imgs,
        "gt_gaze": rng.uniform(-1, 1, (n, 2)).astype(f32),
        "gt_gaze_1": rng.uniform(-1, 1, (n, 2)).astype(f32),
        "head_pose_0": rng.uniform(-0.8, 0.8, (n, 2)).astype(f32),
        "head_pose_1": rng.uniform(-0.8, 0.8, (n, 2)).astype(f32)}.items()}


def _model(mesh, flags):
    torch.manual_seed(0)
    model = FeatRotationSymm(**CFG, **flags).to(memory_format=torch.channels_last)
    return with_spatial_floor(model, mesh)


def _steps(mesh, batch, flags=None, n_steps=1, generator=None, **step_kw):
    """n_steps SGD updates; returns the stats, the model and the first
    update's gradients."""
    model = _model(mesh, flags or {})
    metrics = IterationLoss(StereoL1Loss(rel_weight=0.01, reference_decay=1.0), iter_decay=0.5)
    if step_kw.get("ema_decay"):
        step_kw = {**step_kw, "ema": init_ema(model)}
        model.ema = step_kw["ema"]  # kept beside the model for the comparison
    step = make_train_step(model, metrics, torch.optim.SGD(model.parameters(), lr=5e-2), image_size=SIZE,
                           mesh=mesh, augment=generator is not None, **step_kw)
    stats, grads = [], None
    for i in range(n_steps):
        stats.append(step(batch, generator, step=i))
        if grads is None:
            grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    return stats, model, grads


OPTIONS = {  # name -> (model flags, step options, mesh devices, spatial)
    "grad_accum_2": ({}, {"grad_accum": 2}, 2, 2),
    "freeze_bn": ({}, {"freeze_bn": True}, 2, 2),
    "ema_decay": ({}, {"ema_decay": 0.9}, 2, 2),
    "fuse_views": ({"fuse_views": True}, {}, 2, 2),
    "bn_stat_subsample_2": ({"bn_stat_subsample": 2}, {}, 2, 2),
    "remat": ({"remat": True}, {}, 2, 2),
    "share_feature": ({"share_feature": True}, {}, 2, 2),
    "share_weights": ({"share_weights": True}, {}, 2, 2),
    "ignore_rotmat": ({"ignore_rotmat": True}, {}, 2, 2),
    "encode_rotmat": ({"encode_rotmat": True}, {}, 2, 2),
    "data2_spatial2": ({}, {}, 4, 2),
    "data2_spatial2_subsample_2": ({"bn_stat_subsample": 2}, {}, 4, 2),
    "spatial4": ({}, {}, 4, 4),
}


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_option_under_strips_matches_unsharded(name):
    """One SGD update with the option, under the mesh and without."""
    flags, step_kw, n_dev, sp = OPTIONS[name]
    batch = _batch(seed=2)
    ((sa,), ma, ga), ((sb,), mb, gb) = (
        _steps(mesh, batch, flags, **step_kw) for mesh in (None, make_mesh(["cpu"] * n_dev, spatial=sp)))
    np.testing.assert_allclose(float(sb["loss_gaze"]), float(sa["loss_gaze"]), rtol=1e-5)
    assert ga.keys() == gb.keys()
    for k in ga:
        torch.testing.assert_close(gb[k], ga[k], atol=1e-5, rtol=1e-4, msg=lambda m, k=k: f"{k}: {m}")
    want = dict(ma.named_buffers())
    for k, v in mb.named_buffers():
        if k.endswith("num_batches_tracked"):
            assert int(v) == int(want[k]), k
        else:
            torch.testing.assert_close(v, want[k], atol=1e-5, rtol=1e-5, msg=lambda m, k=k: f"{k}: {m}")
    if step_kw.get("ema_decay"):
        for k, v in ma.ema.items():
            torch.testing.assert_close(mb.ema[k], v, atol=1e-6, rtol=1e-5, msg=lambda m, k=k: f"ema {k}: {m}")
    if step_kw.get("freeze_bn"):
        assert all(int(v) == 0 for k, v in mb.named_buffers() if k.endswith("num_batches_tracked"))


def test_strips_are_cut_after_the_augmentation_draws():
    """Augmentation on, the draws folded by the step: the step under (data
    1, spatial 2) draws what the unsharded step draws from the same
    generator (previews bit for bit), then trains alike."""
    batch = _batch(seed=4, augmented=False)
    runs = [_steps(mesh, batch, n_steps=2, generator=torch.Generator().manual_seed(11), with_images=True,
                   fold_key_by_step=True)[0]
            for mesh in (None, make_mesh(["cpu"] * 2, spatial=2))]
    for a, b in zip(*runs):
        assert torch.equal(a["img_0"], b["img_0"]) and torch.equal(a["img_1"], b["img_1"])
        np.testing.assert_allclose(float(b["loss_gaze"]), float(a["loss_gaze"]), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("devices,sp", [(2, 2), (4, 2)], ids=["data1_spatial2", "data2_spatial2"])
def test_eval_step_under_a_mesh(devices, sp):
    """The eval step over the mesh predicts what the unsharded one does
    (atol 1e-5), on 5 pairs, which 2 data replicas do not divide; its
    previews are the full-height preprocessed rows."""
    batch = {k: v for k, v in _batch(seed=5, augmented=False, n=5).items() if not k.startswith("gt")}
    mesh = make_mesh(["cpu"] * devices, spatial=sp)
    want = make_eval_step(_model(None, {}), SIZE)(batch)
    got = make_eval_step(_model(mesh, {}), SIZE, mesh=mesh)(batch)
    assert got["pred_gaze"].shape == (5, 2)
    torch.testing.assert_close(got["pred_gaze"], want["pred_gaze"], atol=1e-5, rtol=0)
    assert torch.equal(got["img_0"], want["img_0"])


def test_evaluate_gaze_over_a_mesh():
    batch = {k: v.numpy() for k, v in _batch(seed=6, augmented=False, n=6).items()}
    loader = [batch, {k: v[:3] for k, v in batch.items()}]
    mesh = make_mesh(["cpu"] * 2, spatial=2)
    want = evaluate_gaze(_model(None, {}), loader, image_size=SIZE)
    got = evaluate_gaze(_model(mesh, {}), loader, image_size=SIZE, mesh=mesh)
    assert abs(got - want) < 1e-3


def test_strips_need_the_floor():
    model = resnet18()
    with pytest.raises(ValueError, match="spatial floor"):
        model(shard_images(torch.zeros(1, 32, 32, 3), [["cpu"] * 2]))
