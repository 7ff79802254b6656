"""int8 serving under a device mesh (rot_mvgaze_tpu_torch.serving with
``mesh=`` and ``int8=True|"static"``) against the port's unsharded int8
predictor and the JAX package's mesh predictor, on the CPU: the port's
meshes over ``["cpu"] * n`` (and ``cpu:0, cpu:1``, distinct devices),
JAX's over its 8 virtual CPU devices (tests/conftest.py). R18 x 1
iteration, 32x32, micro-batch 4, seeded numpy requests, a .msgpack of
JAX-initialised variables with random BN running statistics.

The JAX package quantizes each conv's input with one abs-max over the
whole array, so under a mesh one scale spans every data replica's rows and
every height strip. The requests here make the blocks' own abs-max differ:
the first data replica's rows dark (pixels in [0, 32)), the second's full
range, and the top half of every image dark.

Bars:
- against the unsharded port: the static ranges bit for bit, predictions
  at the model bar (atol 2e-4 / rtol 1e-3; the pool's sum order and the
  heads' batch differ, every other backbone op is exact once the scale is
  shared);
- against JAX's mesh predictor, every row within FLIP_BAR, as
  tests/test_torch_serving_surface.py holds the unsharded predictors: XLA
  fuses the input normalisation into one multiply-add where PyTorch rounds
  twice, and the ulp that leaves flips an int8 step in one package only,
  with any BN statistics, the identity fold of tests/test_torch_quant.py
  too, and unsharded as well.

The answer per-block scales would give (each block's own abs-max, computed
with the plain ops) lies outside the model bar: a wrong implementation
fails these tests.
"""

import os
import tempfile
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rot_mvgaze_tpu.models import FeatRotationSymm as JaxFeatRotationSymm
from rot_mvgaze_tpu.parallel.mesh import make_mesh as jax_make_mesh
from rot_mvgaze_tpu.serving import GazePredictor as JaxGazePredictor
from rot_mvgaze_tpu.serving import MultiViewGazePredictor as JaxMultiViewGazePredictor
from rot_mvgaze_tpu.train.checkpoints import save_state as jax_save_state
from rot_mvgaze_tpu_torch.models.resnet import QuantConv2d
from rot_mvgaze_tpu_torch.ops import quant
from rot_mvgaze_tpu_torch.parallel import make_mesh, spatial
from rot_mvgaze_tpu_torch.serving import BatchingPredictor, GazePredictor, MultiViewGazePredictor

SIZE = 32
MB = 4
CFG = {"backbone_depth": 18, "num_iter": 1}
KW = dict(**CFG, micro_batch=MB, image_size=SIZE)
MODEL_BAR = dict(atol=2e-4, rtol=1e-3)
FLIP_BAR = 0.03  # as tests/test_torch_quant.py
MODES = {"dynamic": True, "static": "static"}
LAYOUTS = {  # name -> (port devices, spatial); JAX takes as many of its devices
    "data2": (["cpu"] * 2, 1),
    "data1_spatial2": (["cpu"] * 2, 2),
    "data2_spatial2": (["cpu"] * 4, 2),
    "data1_spatial4": (["cpu"] * 4, 4),
    "cpu0_cpu1": (["cpu:0", "cpu:1"], 1),
}
JAX_LAYOUTS = [name for name in LAYOUTS if name != "cpu0_cpu1"]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ckpt():
    """JAX-initialised R18 x 1 variables with random BN running statistics,
    as a .msgpack (both packages load it)."""
    s = jnp.zeros((1, SIZE, SIZE, 3))
    eye = jnp.broadcast_to(jnp.eye(3), (1, 3, 3))
    v = jax.tree.map(np.asarray, JaxFeatRotationSymm(**CFG).init(
        jax.random.PRNGKey(0), {"img_0": s, "img_1": s, "rot_0": eye, "rot_1": eye}))
    rng = np.random.default_rng(1)

    def stats(path, a):
        name = jax.tree_util.keystr(path)
        if "'mean'" in name:
            return rng.normal(0.0, 0.1, a.shape).astype(np.float32)
        if "'var'" in name:
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return a

    v["batch_stats"] = jax.tree_util.tree_map_with_path(stats, v["batch_stats"])
    with tempfile.TemporaryDirectory() as root:  # an R18 file is large: not left behind
        yield jax_save_state(f"{root}/model.msgpack", dict(v))


def _dark_rows(n):
    """The first data replica's rows of each micro-batch (of two replicas)."""
    return (np.arange(n) % MB) < MB // 2


def contrast_request(n, seed):
    """A two-view request whose blocks' abs-max differ: dark rows (the first
    replica's) and a dark top half, pixels in [0, 32); the rest [0, 256)."""
    rng = np.random.default_rng(seed)
    dark = np.zeros((n, SIZE, SIZE, 1), bool)
    dark[_dark_rows(n)] = True
    dark[:, :SIZE // 2] = True

    def view():
        return np.where(dark, rng.integers(0, 32, (n, SIZE, SIZE, 3)),
                        rng.integers(0, 256, (n, SIZE, SIZE, 3))).astype(np.uint8)

    return (view(), view(), rng.uniform(-0.5, 0.5, (n, 2)).astype(np.float32),
            rng.uniform(-0.5, 0.5, (n, 2)).astype(np.float32))


CALIB, REQ = contrast_request(8, seed=1), contrast_request(8, seed=2)


def port(ckpt, int8, layout=None, **kw):
    mesh = None
    if layout is not None:
        devices, sp = LAYOUTS[layout]
        mesh = make_mesh(devices, spatial=sp)
    return GazePredictor(ckpt, **KW, dtype=torch.float32, int8=int8, mesh=mesh,
                         **({} if mesh else {"device": "cpu"}), **kw)


def jax_predictor(ckpt, int8, layout):
    devices, sp = LAYOUTS[layout]
    return JaxGazePredictor(ckpt, **KW, dtype=jnp.float32, int8=int8,
                            mesh=jax_make_mesh(jax.devices()[:len(devices)], spatial=sp))


def ranges(pred):
    return [float(c.act_amax) for _, c in pred._quant_convs]


def serve(pred, int8, calib, req):
    """Static: calibrate on ``calib`` first; then ``req``'s predictions."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # calibration on fewer than 64 samples
        if int8 == "static":
            pred.calibrate(*calib)
        return pred.predict(*req)


# ------------------------------------------------------------ the unsharded port


@pytest.fixture(scope="module")
def unsharded(ckpt):
    """The unsharded port's predictions of REQ (static: calibrated on CALIB)
    and static ranges, by mode."""
    out = {}
    for mode, int8 in MODES.items():
        pred = port(ckpt, int8)
        out[mode] = (serve(pred, int8, CALIB, REQ), ranges(pred) if int8 == "static" else None)
    return out


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_mesh_int8_matches_the_unsharded_port(ckpt, unsharded, layout, mode):
    """8 pairs (two micro-batches) through the mesh predictor and the
    unsharded one: static ranges bit for bit (every copy of the model
    too), predictions at the model bar."""
    int8 = MODES[mode]
    want, want_ranges = unsharded[mode]
    pred = port(ckpt, int8, layout)
    assert pred.micro_batch == MB
    assert pred._threaded == (layout == "cpu0_cpu1")  # a copy of the model and a thread per device
    got = serve(pred, int8, CALIB, REQ)
    assert got.shape == (8, 2) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **MODEL_BAR)
    if int8 == "static":
        assert pred._calibrated and ranges(pred) == want_ranges and min(want_ranges) > 0
        for convs in pred._copy_convs:
            assert [float(c.act_amax) for c in convs] == want_ranges


def _per_block_scales(self, x):
    """A wrong QuantConv2d over blocks: each output strip's window (the
    whole map of a replica of one strip) quantized with its own abs-max,
    by the plain int8 conv."""
    k, s, p = self.weight.shape[-1], self.stride[0], self.padding[0]
    return spatial._windowed(x, k, s, p, 0.0, lambda rows, dev, hp: quant.int8_conv(
        rows, self.weight, (s, s), (hp, p), self.groups))


@pytest.mark.parametrize("layout", JAX_LAYOUTS)
def test_per_block_scales_fall_outside_the_bar(ckpt, unsharded, layout, monkeypatch):
    """The answer per-block scales give is not the unsharded one within the
    model bar (the mesh predictor's is: the test above)."""
    monkeypatch.setattr(QuantConv2d, "_forward_blocks", _per_block_scales)
    wrong = port(ckpt, True, layout).predict(*REQ)
    want = unsharded["dynamic"][0]
    assert not np.allclose(wrong, want, **MODEL_BAR), np.abs(wrong - want).max()


def test_one_replicas_ranges_are_not_the_micro_batchs(ckpt, unsharded):
    """Static ranges recorded on one data replica's rows alone lie below the
    micro-batch's (so ranges kept per replica would be wrong)."""
    one = port(ckpt, "static")
    serve(one, "static", tuple(a[_dark_rows(8)] for a in CALIB), CALIB)
    whole = unsharded["static"][1]
    assert all(a <= b for a, b in zip(ranges(one), whole))
    assert sum(a < b for a, b in zip(ranges(one), whole)) >= 10


# ------------------------------------------------------------ JAX's mesh predictor


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("layout", JAX_LAYOUTS)
def test_mesh_int8_tracks_jax(ckpt, layout, mode):
    """The same layout in both packages, each calibrating its own static
    ranges: every row within FLIP_BAR."""
    int8 = MODES[mode]
    want = serve(jax_predictor(ckpt, int8, layout), int8, CALIB, REQ)
    delta = np.abs(serve(port(ckpt, int8, layout), int8, CALIB, REQ) - want).max(axis=1)
    assert delta.max() <= FLIP_BAR, delta


@pytest.mark.parametrize("mode", sorted(MODES))
def test_multiview_int8_on_a_data_mesh(ckpt, mode):
    """V=3 over (data 2): the unsharded port's predictions at the model bar
    (static ranges bit for bit), JAX's mesh predictor's within FLIP_BAR."""
    int8 = MODES[mode]
    rng = np.random.default_rng(8)

    def stacked(n):
        dark = _dark_rows(n)[:, None, None, None, None]
        return (np.where(dark, rng.integers(0, 32, (n, 3, SIZE, SIZE, 3)),
                         rng.integers(0, 256, (n, 3, SIZE, SIZE, 3))).astype(np.uint8),
                rng.uniform(-0.5, 0.5, (n, 3, 2)).astype(np.float32))

    calib, req = stacked(8), stacked(6)
    kw = dict(**KW, dtype=torch.float32, int8=int8)
    ours = MultiViewGazePredictor(ckpt, 3, mesh=make_mesh(["cpu"] * 2), **kw)
    single = MultiViewGazePredictor(ckpt, 3, device="cpu", **kw)
    theirs = JaxMultiViewGazePredictor(ckpt, 3, **KW, dtype=jnp.float32, int8=int8,
                                       mesh=jax_make_mesh(jax.devices()[:2]))
    got = serve(ours, int8, calib, req)
    assert got.shape == (6, 2)
    np.testing.assert_allclose(got, serve(single, int8, calib, req), **MODEL_BAR)
    delta = np.abs(got - serve(theirs, int8, calib, req)).max(axis=1)
    assert delta.max() <= FLIP_BAR, delta
    if int8 == "static":
        assert ranges(ours) == ranges(single)


# ------------------------------------------------------------ static calibration


def test_calibration_written_under_a_mesh_loads_everywhere(ckpt, unsharded):
    """A (data 2, spatial 2) predictor's calibration file, in the JAX
    package's format: the port's unsharded predictor loads it and predicts
    as the mesh predictor does (the model bar); JAX's loads the same ranges
    and predicts within FLIP_BAR."""
    meshed = port(ckpt, "static", "data2_spatial2")
    got = serve(meshed, "static", CALIB, REQ)
    with tempfile.TemporaryDirectory() as d:
        path = meshed.save_calibration(os.path.join(d, "ranges.msgpack"))
        single = port(ckpt, "static", calibration_path=path)
        theirs = JaxGazePredictor(ckpt, **KW, dtype=jnp.float32, int8="static", calibration_path=path)
    assert single._calibrated and theirs._calibrated and ranges(single) == ranges(meshed)
    leaves = jax.tree_util.tree_flatten_with_path(theirs.variables["quant"])[0]
    loaded = {tuple(k.key for k in p[:-1]): float(v) for p, v in leaves}
    assert {tuple(p): float(c.act_amax) for p, c in meshed._quant_convs} == loaded
    np.testing.assert_allclose(single.predict(*REQ), got, **MODEL_BAR)
    delta = np.abs(theirs.predict(*REQ) - got).max(axis=1)
    assert delta.max() <= FLIP_BAR, delta


def test_calibration_acts_on_every_copy(ckpt):
    """cpu:0 and cpu:1 are distinct devices (a copy of the model each, a
    host thread per replica): warmup and reset_calibration leave every copy
    at zero and uncalibrated; calibrate and load_calibration give every copy
    the same ranges."""
    assert torch.device("cpu", 1) != torch.device("cpu")
    pred = port(ckpt, "static", "cpu0_cpu1")
    assert pred._threaded and len(pred._copy_convs) == 1

    def every_copy():
        return [ranges(pred)] + [[float(c.act_amax) for c in convs] for convs in pred._copy_convs]

    pred.warmup()
    assert not pred._calibrated and all(v == 0.0 for r in every_copy() for v in r)
    pred.calibrate(*CALIB)
    first, second = every_copy()
    assert pred._calibrated and first == second and min(first) > 0
    with tempfile.TemporaryDirectory() as d:
        path = pred.save_calibration(os.path.join(d, "ranges.msgpack"))
        pred.reset_calibration()
        assert not pred._calibrated and all(v == 0.0 for r in every_copy() for v in r)
        pred.warmup()
        assert not pred._calibrated and all(v == 0.0 for r in every_copy() for v in r)
        pred.load_calibration(path)
    assert pred._calibrated and every_copy() == [first, first]


def test_batching_predictor_over_mesh_int8(ckpt):
    pred = port(ckpt, True, "data2_spatial2")
    req = tuple(a[:6] for a in REQ)
    want = pred.predict(*req)
    batching = BatchingPredictor(pred)
    try:
        np.testing.assert_array_equal(batching.predict(*req), want)
    finally:
        batching.close()
