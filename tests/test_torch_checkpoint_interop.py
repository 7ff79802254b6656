"""The JAX package's checkpoints in the port, on the CPU: the msgpack reader
(rot_mvgaze_tpu_torch.compat.msgpack) against flax's own, the format told
by content, a JAX TrainState resumed by the port's Trainer against the JAX
Trainer's own resume (the next update on one numpy batch, as
tests/test_torch_train.py's trajectory test takes it), weights-only loads,
the export, and the ImageNet backbone warm start."""

import glob
import os
import shutil
import socket
import urllib.error
import urllib.request
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from rot_mvgaze_tpu.compat import load_pretrained_backbone as jax_load_pretrained_backbone
from rot_mvgaze_tpu.data import BatchLoader as JaxBatchLoader
from rot_mvgaze_tpu.data import GazeDataset as JaxGazeDataset
from rot_mvgaze_tpu.losses import IterationLoss as JaxIterationLoss
from rot_mvgaze_tpu.losses import StereoL1Loss as JaxStereoL1Loss
from rot_mvgaze_tpu.models import FeatRotationSymm as JaxFeatRotationSymm
from rot_mvgaze_tpu.train import Trainer as JaxTrainer
from rot_mvgaze_tpu.train.checkpoints import save_state as jax_save_state
from rot_mvgaze_tpu.train.steps import make_train_step as jax_make_train_step
from rot_mvgaze_tpu_torch.compat import (
    load_checkpoint,
    load_pretrained_backbone,
    read_checkpoint,
    state_dict_from_jax,
    state_from_jax,
)
from rot_mvgaze_tpu_torch.compat import msgpack
from rot_mvgaze_tpu_torch.compat.pretrained import MODEL_URLS, resolve_pretrained
from rot_mvgaze_tpu_torch.data import BatchLoader, GazeDataset, write_synthetic_dataset
from rot_mvgaze_tpu_torch.losses import IterationLoss, StereoL1Loss
from rot_mvgaze_tpu_torch.models import FeatRotationSymm
from rot_mvgaze_tpu_torch.models.resnet import resnet18
from rot_mvgaze_tpu_torch.serving import GazePredictor
from rot_mvgaze_tpu_torch.train import Trainer, make_train_step

CFG = {"backbone_depth": 18, "num_iter": 2}
PALLAS = {"use_pallas_bn": True, "use_pallas_fusion": True}
SIZE, EMA = 32, 0.9


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# the JAX run whose checkpoint every test reads
# ---------------------------------------------------------------------------


def _config(out, **overrides):
    """The trajectory test's learning rates (1e-6 up to 1e-4): an Adam step
    moves a parameter by about lr whatever its gradient's size, so its 2e-5
    parameter bar presumes them (tests/test_torch_train.py)."""
    cfg = dict(mode="train", output_dir=str(out), ckpt_resume=None, print_freq=100, seed=0,
               batch_size=9, epochs=1, save_epoch=1, image_size=SIZE, scheduler_step="epoch",
               ema_decay=EMA, base_lr=1e-6, max_lr=1e-4)
    cfg.update(overrides)
    return SimpleNamespace(**cfg)


def _jax_trainer(corpus, out, **overrides):
    loaders = (JaxBatchLoader(JaxGazeDataset("xgaze", corpus, "bgr", ["s00.h5"], seed=0), 9,
                              shuffle=True, drop_last=True),
               JaxBatchLoader(JaxGazeDataset("mpiinv", corpus, "rgb", ["s00.h5"], seed=0), 18))
    return JaxTrainer(_config(out, **overrides), JaxFeatRotationSymm(**CFG),
                      JaxIterationLoss(loss=JaxStereoL1Loss(rel_weight=0.01), iter_decay=0.5), *loaders)


def _port_trainer(corpus, out, **overrides):
    loaders = (BatchLoader(GazeDataset("xgaze", corpus, "bgr", ["s00.h5"], seed=0), 9, shuffle=True,
                           drop_last=True),
               BatchLoader(GazeDataset("mpiinv", corpus, "rgb", ["s00.h5"], seed=0), 18))
    torch.manual_seed(0)
    return Trainer(_config(out, **overrides), FeatRotationSymm(**CFG),
                   IterationLoss(StereoL1Loss(rel_weight=0.01), iter_decay=0.5), *loaders,
                   device="cpu")


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX Trainer, 1 epoch of 2 updates (one subject, 1 frame x 18
    cameras, drop-last batches of 9) with ema_decay 0.9: its full TrainState
    .msgpack, saved by rot_mvgaze_tpu.train.checkpoints.save_state."""
    root = tmp_path_factory.mktemp("interop")
    corpus = str(root / "corpus")
    write_synthetic_dataset(corpus, ["s00.h5"], n_frames=1, image_size=SIZE, learnable=True)
    trainer = _jax_trainer(corpus, root / "jax_run")
    trainer.train()
    (path,) = glob.glob(str(root / "jax_run" / "ckpt" / "*.msgpack"))
    yield {"root": root, "corpus": corpus, "path": path}
    shutil.rmtree(root, ignore_errors=True)  # checkpoints with Adam's state: a few hundred MB


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# the msgpack reader against flax's
# ---------------------------------------------------------------------------


def _small_variables():
    data = {"img_0": jnp.zeros((2, SIZE, SIZE, 3)), "img_1": jnp.zeros((2, SIZE, SIZE, 3)),
            "rot_0": jnp.broadcast_to(jnp.eye(3), (2, 3, 3)),
            "rot_1": jnp.broadcast_to(jnp.eye(3), (2, 3, 3))}
    return _np(JaxFeatRotationSymm(backbone_depth=18, num_iter=1).init(jax.random.PRNGKey(1), data))


def _read_and_remove(path):
    with open(path, "rb") as f:
        data = f.read()
    os.remove(path)
    return data


def _bytes_full_state(jax_run, tmp_path, monkeypatch):
    return open(jax_run["path"], "rb").read()


def _bytes_full_state_without_ema(jax_run, tmp_path, monkeypatch):
    tree = msgpack.load(jax_run["path"])
    tree.pop("ema_params")
    path = jax_save_state(str(tmp_path / "no_ema.msgpack"), tree)
    return _read_and_remove(path)


def _bytes_bare_variables(jax_run, tmp_path, monkeypatch):
    path = jax_save_state(str(tmp_path / "vars.msgpack"), _small_variables())
    return _read_and_remove(path)


def _bytes_bf16_leaf(jax_run, tmp_path, monkeypatch):
    return serialization.to_bytes({"w": jnp.arange(12, dtype=jnp.bfloat16).reshape(3, 4) / 7,
                                   "s": np.asarray(jnp.bfloat16(1.5)), "f": np.ones(2, np.float32)})


def _bytes_scalars(jax_run, tmp_path, monkeypatch):
    return serialization.to_bytes({
        "step": np.int32(3), "f64": np.float64(2.5), "f16": np.float16(-1.5), "u64": np.uint64(2**63 + 5),
        "i8": np.int8(-7), "flag": np.bool_(True), "small": 5, "neg": -3, "i16": -300, "u16": 60000,
        "i32": -(2**31), "u32": 2**32 - 1, "i64": -(2**40), "u64py": 2**64 - 1, "pi": 3.25,
        "none": None, "yes": True, "no": False, "text": "é" * 40, "long": "x" * 300,
        "blob": b"\x00\x01" * 200, "z": complex(1.5, -2.0), "list": [1, "a", [2.0]],
        "empty": {}, "big": {str(i): i for i in range(20)},
        "f32": np.arange(6, dtype=np.float32).reshape(2, 3), "i64arr": np.arange(4, dtype=np.int64),
        "empty_arr": np.zeros((0, 3), np.float32),
    })


def _bytes_chunked(jax_run, tmp_path, monkeypatch):
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    return serialization.to_bytes({"a": np.arange(100, dtype=np.float32).reshape(4, 25),
                                   "nested": {"b": np.arange(50, dtype=np.int64)},
                                   "small": np.ones(3, np.float32)})


MSGPACK_CASES = {
    "full_state_with_ema": _bytes_full_state,
    "full_state_without_ema": _bytes_full_state_without_ema,
    "bare_variables": _bytes_bare_variables,
    "bf16_leaf": _bytes_bf16_leaf,
    "scalars_and_containers": _bytes_scalars,
    "chunked_arrays": _bytes_chunked,
}


def _assert_same_tree(got, want, path="."):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _assert_same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same_tree(g, w, f"{path}/{i}")
    elif isinstance(want, (np.ndarray, np.generic)) and want.dtype == jnp.bfloat16:
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16, path
        assert tuple(got.shape) == np.shape(want), path
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32), err_msg=path)
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, path


@pytest.mark.parametrize("case", sorted(MSGPACK_CASES))
def test_msgpack_reads_what_flax_reads(jax_run, tmp_path, monkeypatch, case):
    data = MSGPACK_CASES[case](jax_run, tmp_path, monkeypatch)
    if case == "chunked_arrays":
        assert b"__msgpack_chunked_array__" in data
    _assert_same_tree(msgpack.loads(data), serialization.msgpack_restore(data))


def test_msgpack_refuses_malformed_input():
    with pytest.raises(ValueError, match="truncated"):
        msgpack.loads(b"\x85\xa4step\x03")
    with pytest.raises(ValueError, match="after the msgpack object"):
        msgpack.loads(b"\x80\x00")
    with pytest.raises(ValueError, match="extension type 9"):
        msgpack.loads(b"\xd4\x09\x00")
    with pytest.raises(ValueError, match="type byte 0xc1"):
        msgpack.loads(b"\xc1")


def _pickle(tmp_path, protocol):
    path = str(tmp_path / "state.pth.tar")
    torch.save({"step": torch.tensor(3)}, path, _use_new_zipfile_serialization=False,
               pickle_protocol=protocol)
    return path, "torch"


def _fixmap(tmp_path, n):
    path = str(tmp_path / "state.pth.tar")  # the name says nothing: the bytes decide
    with open(path, "wb") as f:
        f.write(serialization.to_bytes({f"k{i:02d}": np.int32(i) for i in range(n)}))
    return path, "msgpack"


FORMATS = {**{f"pickle_protocol_{p}": (_pickle, p) for p in (2, 3, 4, 5)},
           **{f"msgpack_fixmap_{n}_keys": (_fixmap, n) for n in (1, 5, 15)}}


@pytest.mark.parametrize("case", sorted(FORMATS))
def test_read_checkpoint_tells_pickle_from_msgpack_by_content(tmp_path, monkeypatch, case):
    """Both can start with 0x80: a pickle then has its protocol (2-5) and
    goes to torch.load, a flax map a string key's type byte (0xa0-0xbf) and
    goes to the msgpack reader."""
    import rot_mvgaze_tpu_torch.compat.convert as convert

    build, arg = FORMATS[case]
    path, kind = build(tmp_path, arg)
    head = open(path, "rb").read(2)
    assert 0x80 <= head[0] <= 0x8F
    monkeypatch.setattr(convert.torch, "load", lambda *a, **k: "torch.load")
    got = read_checkpoint(path)
    if kind == "torch":
        assert got == "torch.load"
    else:
        assert got == {f"k{i:02d}": np.int32(i) for i in range(arg)}
    monkeypatch.undo()
    if kind == "torch" and arg == 2:  # torch's own legacy format reads back
        assert torch.equal(read_checkpoint(path)["step"], torch.tensor(3))


def test_read_checkpoint_refuses_other_files(tmp_path):
    path = tmp_path / "x.pth.tar"
    path.write_bytes(b"\x80\x09garbage")
    with pytest.raises(ValueError, match="not a torch.save file nor a msgpack"):
        read_checkpoint(str(path))


# ---------------------------------------------------------------------------
# a JAX TrainState resumed by the port
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def resumed(jax_run):
    """The port's and the JAX Trainer's resume from the same .msgpack (epochs
    2), then one more update each on one numpy batch, augment off, the JAX
    step on its Pallas kernels in interpret mode, as the trajectory test."""
    root, corpus, path = jax_run["root"], jax_run["corpus"], jax_run["path"]
    port = _port_trainer(corpus, root / "port_resume", epochs=2, ckpt_resume=path)
    ref = _jax_trainer(corpus, root / "jax_resume", epochs=2, ckpt_resume=path)
    at_resume = {"port_state": {k: v.clone() for k, v in port.model.state_dict().items()},
                 "port_ema": {k: v.clone() for k, v in port.ema.items()},
                 "port_adam": {i: {k: v.clone() for k, v in s.items()}
                               for i, s in port.optimizer.state_dict()["state"].items()},
                 "jax_state": _np(ref.state)}
    rng = np.random.default_rng(1)
    batch = {
        "img_0": rng.normal(size=(4, SIZE, SIZE, 3)).astype(np.float32),
        "img_1": rng.normal(size=(4, SIZE, SIZE, 3)).astype(np.float32),
        **{k: rng.uniform(-0.5, 0.5, (4, 2)).astype(np.float32)
           for k in ("head_pose_0", "head_pose_1", "gt_gaze", "gt_gaze_1")},
    }
    metrics = JaxIterationLoss(JaxStereoL1Loss(rel_weight=0.01, reference_decay=1.0), iter_decay=0.5)
    jax_step = jax.jit(jax_make_train_step(
        JaxFeatRotationSymm(**CFG, **PALLAS), metrics, ref.tx, image_size=SIZE,
        schedule=ref.schedule, augment=False, ema_decay=EMA))
    new_state, jax_stats = jax_step(ref.state, jax.tree.map(jnp.asarray, batch), jax.random.PRNGKey(0))
    step = make_train_step(
        port.model, IterationLoss(StereoL1Loss(rel_weight=0.01, reference_decay=1.0), iter_decay=0.5),
        port.optimizer, image_size=SIZE, schedule=port.schedule, augment=False,
        ema_decay=EMA, ema=port.ema)
    port_stats = step({k: torch.from_numpy(v) for k, v in batch.items()}, step=port.step)
    return {"port": port, "ref": ref, "at_resume": at_resume, "port_stats": port_stats,
            "jax_stats": jax.tree.map(np.asarray, jax_stats), "jax_new": _np(new_state)}


def test_resume_restores_the_jax_state(resumed):
    """Step, epoch position, Adam's moments and count, and the EMA as the JAX
    Trainer restores them (converted by the weights' transposes, exactly)."""
    port, ref, at = resumed["port"], resumed["ref"], resumed["at_resume"]
    state = at["jax_state"]
    assert port.step == int(state.step) == 2
    assert (port._start_epoch, port._start_batch) == (ref._start_epoch, ref._start_batch) == (1, 0)
    assert port.train_loader.epoch == ref.train_loader.epoch == 1
    adam = state.opt_state[1]
    mu = state_dict_from_jax({"params": adam.mu, "batch_stats": state.batch_stats}, **CFG)
    nu = state_dict_from_jax({"params": adam.nu, "batch_stats": state.batch_stats}, **CFG)
    names = [n for n, _ in port.model.named_parameters()]
    assert sorted(at["port_adam"]) == [i for i, n in enumerate(names) if ".fc." not in n]
    for i, s in at["port_adam"].items():
        assert float(s["step"]) == float(adam.count) == 2
        assert torch.equal(s["exp_avg"], mu[names[i]]) and torch.equal(s["exp_avg_sq"], nu[names[i]])
    ema = state_dict_from_jax({"params": state.ema_params, "batch_stats": state.batch_stats}, **CFG)
    for n, v in at["port_ema"].items():
        assert torch.equal(v, ema[n]), n
    raw = state_dict_from_jax({"params": state.params, "batch_stats": state.batch_stats}, **CFG)
    # a full resume continues from the raw weights
    for n, v in at["port_state"].items():
        assert torch.equal(v, raw[n]), n


def test_the_next_update_matches_the_jax_trainers(resumed):
    """Loss at rtol 1e-4, every parameter and EMA entry within 2e-5 (the
    trajectory test's bars), running statistics within 1e-4."""
    port, new = resumed["port"], resumed["jax_new"]
    np.testing.assert_allclose(float(resumed["port_stats"]["loss_gaze"]),
                               float(resumed["jax_stats"]["loss_gaze"]), rtol=1e-4)
    np.testing.assert_allclose(resumed["port_stats"]["lr"], float(resumed["jax_stats"]["lr"]), rtol=1e-6)
    want = state_dict_from_jax({"params": new.params, "batch_stats": new.batch_stats}, **CFG)
    worst = 0.0
    for n, v in port.model.state_dict().items():
        if "num_batches_tracked" in n or ".fc." in n:
            continue
        atol = 1e-4 if "running" in n else 2e-5
        np.testing.assert_allclose(v.numpy(), want[n].numpy(), atol=atol, err_msg=n)
        if "running" not in n:
            worst = max(worst, float((v - want[n]).abs().max()))
    print(f"max |parameter difference| after the resumed update {worst:.3e}")
    ema = state_dict_from_jax({"params": new.ema_params, "batch_stats": new.batch_stats}, **CFG)
    for n, v in port.ema.items():
        np.testing.assert_allclose(v.numpy(), ema[n].numpy(), atol=2e-5, err_msg=n)


def test_auto_resume_over_jax_checkpoints(resumed, jax_run):
    """--auto_resume_dir over the JAX run's checkpoint directory (its
    .msgpack alone) resumes from that file, to the state --ckpt_resume
    restores, and the next update on the same batch matches the JAX
    Trainer's at the trajectory bars: loss rtol 1e-4, parameters within
    2e-5, running statistics within 1e-4."""
    root, corpus, path = jax_run["root"], jax_run["corpus"], jax_run["path"]
    port = _port_trainer(corpus, root / "port_auto_resume", epochs=2,
                         auto_resume_dir=os.path.dirname(path))
    assert port._resume_path == path
    assert port.step == 2 and (port._start_epoch, port._start_batch) == (1, 0)
    for n, v in resumed["at_resume"]["port_state"].items():
        assert torch.equal(port.model.state_dict()[n], v), n
    rng = np.random.default_rng(1)  # the resumed fixture's batch
    batch = {
        "img_0": rng.normal(size=(4, SIZE, SIZE, 3)).astype(np.float32),
        "img_1": rng.normal(size=(4, SIZE, SIZE, 3)).astype(np.float32),
        **{k: rng.uniform(-0.5, 0.5, (4, 2)).astype(np.float32)
           for k in ("head_pose_0", "head_pose_1", "gt_gaze", "gt_gaze_1")},
    }
    step = make_train_step(
        port.model, IterationLoss(StereoL1Loss(rel_weight=0.01, reference_decay=1.0), iter_decay=0.5),
        port.optimizer, image_size=SIZE, schedule=port.schedule, augment=False,
        ema_decay=EMA, ema=port.ema)
    stats = step({k: torch.from_numpy(v) for k, v in batch.items()}, step=port.step)
    np.testing.assert_allclose(float(stats["loss_gaze"]), float(resumed["jax_stats"]["loss_gaze"]), rtol=1e-4)
    new = resumed["jax_new"]
    want = state_dict_from_jax({"params": new.params, "batch_stats": new.batch_stats}, **CFG)
    for n, v in port.model.state_dict().items():
        if "num_batches_tracked" in n or ".fc." in n:
            continue
        np.testing.assert_allclose(v.numpy(), want[n].numpy(), atol=1e-4 if "running" in n else 2e-5,
                                   err_msg=n)


def test_weights_only_loads_keep_a_fresh_adam(jax_run):
    """--weights_only from a full state: the EMA weights (preferred for
    weight-only loads), step 0, no optimizer state, the full epoch budget;
    a bare-variables file is weights-only by content, and one without
    batch_stats is refused."""
    root, corpus, path = jax_run["root"], jax_run["corpus"], jax_run["path"]
    tree = msgpack.load(path)
    ema = state_dict_from_jax({"params": tree["ema_params"], "batch_stats": tree["batch_stats"]}, **CFG)
    trainer = _port_trainer(corpus, root / "weights_only", epochs=2, ckpt_resume=path, weights_only=True,
                            ema_decay=0.0)
    assert trainer.step == 0 and trainer._start_epoch == 0 and trainer.ema is None
    assert trainer.optimizer.state_dict()["state"] == {}
    for n, v in trainer.model.state_dict().items():
        assert torch.equal(v, ema[n]), n
    bare = jax_save_state(str(root / "bare.msgpack"),
                          {"params": tree["params"], "batch_stats": tree["batch_stats"]})
    trainer = _port_trainer(corpus, root / "bare", ckpt_resume=bare, ema_decay=0.0)
    assert trainer.step == 0 and trainer.optimizer.state_dict()["state"] == {}
    assert torch.equal(trainer.model.state_dict()["_gaze_estimators.1.blocks.0.0.weight"],
                       torch.from_numpy(np.array(tree["params"]["gaze_estimator_1"]["dense_0"]["kernel"].T)))
    no_stats = jax_save_state(str(root / "no_stats.msgpack"), {"params": tree["params"]})
    with pytest.raises(ValueError, match="batch_stats"):
        _port_trainer(corpus, root / "no_stats", ckpt_resume=no_stats)
    assert state_from_jax({"params": tree["params"], "batch_stats": tree["batch_stats"]}, **CFG).keys() \
        == {"state_dict"}


def test_export_and_load_checkpoint_take_the_moving_average(resumed, tmp_path):
    """export_torch_checkpoint writes the bare reference state dict with the
    EMA weights, which GazePredictor loads with strict=True; load_checkpoint
    converts a JAX .msgpack, its EMA preferred."""
    port = resumed["port"]
    path = port.export_torch_checkpoint(str(tmp_path / "export.pth.tar"))
    sd = torch.load(path, weights_only=True)
    assert set(sd) == set(port.model.state_dict())
    for n, v in port.ema.items():
        assert torch.equal(sd[n], v), n
    pred = GazePredictor(path, micro_batch=4, image_size=SIZE, dtype=torch.float32, device="cpu", **CFG)
    assert pred.model._gaze_estimators[0].blocks[0][0].weight.dtype == torch.float32
    tree = msgpack.load(resumed["ref"]._resume_path)
    want = state_dict_from_jax({"params": tree["ema_params"], "batch_stats": tree["batch_stats"]}, **CFG)
    got = load_checkpoint(resumed["ref"]._resume_path, **CFG)
    assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)


# ---------------------------------------------------------------------------
# the ImageNet backbone
# ---------------------------------------------------------------------------


@pytest.fixture
def torchvision_file(tmp_path):
    """A torchvision-layout ResNet-18 state dict (seeded random weights,
    running statistics moved off their initial values), with its fc."""
    torch.manual_seed(3)
    net = resnet18()
    sd = net.state_dict()
    for k, v in sd.items():
        if v.is_floating_point():
            sd[k] = v + 0.01 * torch.randn_like(v)
    path = str(tmp_path / "resnet18-test.pth")
    torch.save(sd, path)
    return path, sd


def test_pretrained_backbone_matches_the_jax_packages(torchvision_file):
    path, sd = torchvision_file
    model = load_pretrained_backbone(FeatRotationSymm(**CFG), path)
    got = model.state_dict()
    for k, v in sd.items():
        if not k.startswith("fc."):
            assert torch.equal(got[f"_feat_extractor.0.{k}"], v), k
    variables = jax_load_pretrained_backbone(_small_variables_cfg(), path, 18)
    want = state_dict_from_jax(_np(variables), **CFG)
    for k, v in want.items():
        if k.startswith("_feat_extractor.0.") and ".fc." not in k and "num_batches" not in k:
            assert torch.equal(got[k], v), k


def _small_variables_cfg():
    data = {"img_0": jnp.zeros((2, SIZE, SIZE, 3)), "img_1": jnp.zeros((2, SIZE, SIZE, 3)),
            "rot_0": jnp.broadcast_to(jnp.eye(3), (2, 3, 3)),
            "rot_1": jnp.broadcast_to(jnp.eye(3), (2, 3, 3))}
    return _np(JaxFeatRotationSymm(**CFG).init(jax.random.PRNGKey(2), data))


@pytest.mark.parametrize("change", ["missing_key", "leftover_key"])
def test_pretrained_backbone_refuses_other_layouts(torchvision_file, tmp_path, change):
    path, sd = torchvision_file
    sd = dict(sd)
    if change == "missing_key":
        del sd["layer2.0.bn1.running_var"]
    else:
        sd["layer5.0.conv1.weight"] = torch.zeros(1)
    bad = str(tmp_path / "bad.pth")
    torch.save(sd, bad)
    with pytest.raises(ValueError, match="leftover keys|missing keys"):
        load_pretrained_backbone(FeatRotationSymm(**CFG), bad)


def test_pretrained_auto_makes_no_network_call(tmp_path, monkeypatch):
    """'auto' with an empty cache goes through urlopen (patched here to fail
    as a machine without egress does, and no socket is opened): the
    zero-egress message naming the address; a cached file failing its
    checksum is deleted and fetched again, not used."""
    monkeypatch.setenv("HOME", str(tmp_path))

    def no_network(*args, **kwargs):
        raise AssertionError("a network call was made")

    def no_egress(url, timeout=60):
        raise urllib.error.URLError("no route to host")

    monkeypatch.setattr(socket, "socket", no_network)
    monkeypatch.setattr(socket, "create_connection", no_network)
    monkeypatch.setattr(urllib.request, "urlopen", no_egress)
    with pytest.raises(RuntimeError, match="no network egress") as e:
        resolve_pretrained("auto", 50)
    assert MODEL_URLS["resnet50"] in str(e.value)
    cache = tmp_path / ".cache" / "rot_mvgaze_tpu" / "pretrained"
    (cache / "resnet18-5c106cde.pth").write_bytes(b"not the weights")
    with pytest.raises(RuntimeError, match="no network egress"):
        resolve_pretrained("download", 18)
    assert not (cache / "resnet18-5c106cde.pth").exists()
    with pytest.raises(FileNotFoundError):
        resolve_pretrained(str(tmp_path / "absent.pth"), 18)


def test_trainer_warm_starts_the_backbone(jax_run, torchvision_file):
    path, sd = torchvision_file
    trainer = _port_trainer(jax_run["corpus"], jax_run["root"] / "pretrained", pretrained_backbone=path,
                            ema_decay=0.0)
    got = trainer.model.state_dict()
    assert torch.equal(got["_feat_extractor.0.layer3.1.conv2.weight"], sd["layer3.1.conv2.weight"])
    assert os.path.exists(os.path.join(trainer.output_dir, "config.yaml"))
