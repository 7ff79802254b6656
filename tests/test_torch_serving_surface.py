"""The port's serving surface (rot_mvgaze_tpu_torch.serving, .serve) against
the JAX package's (rot_mvgaze_tpu.serving, scripts/serve.py) on the CPU: the
ablation predictors, the V-view predictor, requests at other resolutions,
int8 serving and the static-calibration contract, the bf16 predictor's
distance from float32, and serve.py's refusals. R18, 2 fusion iterations,
reference-format .pth.tar checkpoints made from JAX-initialised variables
with non-trivial BN running statistics, seeded numpy requests.

Bars: float32 predictors at the model bar, atol 2e-4 / rtol 1e-3
(tests/test_model_parity.py:120). int8 predictors: each quantizer turns a
float32 ulp into an int8 step at a rounding boundary, and the two packages'
preprocessing and BatchNorm round otherwise (tests/test_torch_quant.py,
which holds the int8 model at the model bar where the float path is the same
IEEE operations); here every row within FLIP_BAR of JAX's (at the
predictor a static scale that moved by an ulp shifts every row: up to 1.4e-2
measured). Calibration ranges rtol 1e-5 (a range is a max of |x|, which
those ulps move by at most one). bf16: the port's bf16 no farther from JAX
float32 than JAX's own bf16 is, plus 0.1 deg (mean and max angle).
"""

import tempfile
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rot_mvgaze_tpu.compat import flax_to_torch_state_dict
from rot_mvgaze_tpu.models import FeatRotationSymm as JaxFeatRotationSymm
from rot_mvgaze_tpu.serving import GazePredictor as JaxGazePredictor
from rot_mvgaze_tpu.serving import MultiViewGazePredictor as JaxMultiViewGazePredictor
from rot_mvgaze_tpu_torch import serve, serving
from rot_mvgaze_tpu_torch.augment import eval_preprocess
from rot_mvgaze_tpu_torch.geometry import angular_error_numpy
from rot_mvgaze_tpu_torch.models.resnet import QuantConv2d

BASE = {"backbone_depth": 18, "num_iter": 2}
SIZE = 32
MB = 4
MODEL_BAR = dict(atol=2e-4, rtol=1e-3)
FLIP_BAR = 0.03  # as tests/test_torch_quant.py
ABLATIONS = {
    "default": {},
    "share_weights": {"share_weights": True},
    "ignore_rotmat": {"ignore_rotmat": True},
    "encode_rotmat": {"encode_rotmat": True},
    "share_feature": {"share_feature": True},
}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def write_reference_checkpoint(path, cfg, size, seed=1):
    """A reference-format .pth.tar of JAX-initialised variables of ``cfg``,
    BN running statistics drawn from ``seed``."""
    s = jnp.zeros((1, size, size, 3))
    eye = jnp.broadcast_to(jnp.eye(3), (1, 3, 3))
    variables = JaxFeatRotationSymm(**cfg).init(
        jax.random.PRNGKey(0), {"img_0": s, "img_1": s, "rot_0": eye, "rot_1": eye})
    sd = flax_to_torch_state_dict(jax.tree.map(np.asarray, variables), strict_compatible=True, **cfg)
    rng = np.random.default_rng(seed)
    for k in sd:
        if k.endswith("running_mean"):
            sd[k] = rng.normal(0.0, 0.1, sd[k].shape).astype(np.float32)
        elif k.endswith("running_var"):
            sd[k] = rng.uniform(0.5, 1.5, sd[k].shape).astype(np.float32)
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, path)
    return path


@pytest.fixture
def tmp_dir():
    """A directory removed after the test: an R18 checkpoint here is over
    100 MB, too much to leave in pytest's kept temporary directories."""
    with tempfile.TemporaryDirectory() as d:
        yield Path(d)


@pytest.fixture(scope="module")
def ckpts():
    with tempfile.TemporaryDirectory() as root:
        yield {name: write_reference_checkpoint(f"{root}/{name}.pth.tar", {**BASE, **flags}, SIZE)
               for name, flags in ABLATIONS.items()}


def stereo_request(n, seed=0, size=SIZE):
    rng = np.random.default_rng(seed)
    return (
        rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8),
        rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8),
        rng.uniform(-0.5, 0.5, (n, 2)).astype(np.float32),
        rng.uniform(-0.5, 0.5, (n, 2)).astype(np.float32),
    )


def stacked_request(n, v, seed=0, size=SIZE):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, v, size, size, 3), dtype=np.uint8),
            rng.uniform(-0.5, 0.5, (n, v, 2)).astype(np.float32))


def port_predictor(ckpt, flags=(), **kw):
    return serving.GazePredictor(ckpt, **BASE, **dict(flags), micro_batch=MB, image_size=SIZE,
                                 dtype=kw.pop("dtype", torch.float32), device="cpu", **kw)


def jax_predictor(ckpt, flags=(), **kw):
    return JaxGazePredictor(ckpt, **BASE, **dict(flags), micro_batch=MB, image_size=SIZE,
                            dtype=kw.pop("dtype", jnp.float32), **kw)


# ------------------------------------------------------------ predictors


@pytest.mark.parametrize("name", list(ABLATIONS))
def test_ablation_predictor_matches_jax(ckpts, name):
    """N=6 over micro-batch 4 (the last one padded on both sides)."""
    flags = ABLATIONS[name]
    req = stereo_request(6, seed=len(name))
    got = port_predictor(ckpts[name], flags).predict(*req)
    want = jax_predictor(ckpts[name], flags).predict(*req)
    assert got.shape == (6, 2) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **MODEL_BAR)


@pytest.mark.parametrize("v", [3, 4])
@pytest.mark.parametrize("name", ["default", "share_weights", "ignore_rotmat"])
def test_multiview_predictor_matches_jax(ckpts, name, v):
    """Any stereo checkpoint at any V, in both packages."""
    flags = ABLATIONS[name]
    req = stacked_request(5, v, seed=v)
    got = serving.MultiViewGazePredictor(ckpts[name], num_views=v, **BASE, **flags, micro_batch=MB,
                                         image_size=SIZE, dtype=torch.float32, device="cpu")
    want = JaxMultiViewGazePredictor(ckpts[name], num_views=v, **BASE, **flags, micro_batch=MB,
                                     image_size=SIZE, dtype=jnp.float32)
    np.testing.assert_allclose(got.predict(*req), want.predict(*req), **MODEL_BAR)


def test_multiview_predictor_at_v2_is_the_stereo_predictor(ckpts):
    imgs, poses = stacked_request(6, 2, seed=2)
    mv = serving.MultiViewGazePredictor(ckpts["default"], num_views=2, **BASE, micro_batch=MB,
                                        image_size=SIZE, dtype=torch.float32, device="cpu")
    st = port_predictor(ckpts["default"])
    got = mv.predict(imgs, poses)
    want = st.predict(imgs[:, 0], imgs[:, 1], poses[:, 0], poses[:, 1])
    assert angular_error_numpy(got.astype(np.float64), want.astype(np.float64)).max() <= 1e-3
    np.testing.assert_allclose(got, want, **MODEL_BAR)


def test_multiview_predictor_refusals(ckpts):
    """num_views < 2 and the stereo-only ablations are refused, as in JAX
    (whose V-view predictor has no encode_rotmat / share_feature either)."""
    common = dict(micro_batch=MB, image_size=SIZE)
    with pytest.raises(ValueError):
        serving.MultiViewGazePredictor(ckpts["default"], num_views=1, **BASE, **common, device="cpu")
    for flag in ("encode_rotmat", "share_feature"):
        with pytest.raises(TypeError):
            serving.MultiViewGazePredictor(ckpts["default"], num_views=3, **BASE, **common, device="cpu",
                                           **{flag: True})
        with pytest.raises(TypeError):
            JaxMultiViewGazePredictor(ckpts["default"], num_views=3, **BASE, **common, **{flag: True})


def test_multiview_predictor_validates_requests(ckpts):
    mv = serving.MultiViewGazePredictor(ckpts["default"], num_views=3, **BASE, micro_batch=MB,
                                        image_size=SIZE, dtype=torch.float32, device="cpu")
    imgs, poses = stacked_request(2, 3)
    for bad in ((imgs[:, :2], poses[:, :2]), (imgs.astype(np.float32), poses), (imgs, poses[:1]),
                (imgs[..., :2], poses)):
        with pytest.raises(ValueError):
            mv.predict(*bad)
    assert mv.predict(imgs[:0], poses[:0]).shape == (0, 2)


def test_batching_predictor_serves_the_multiview_predictor(ckpts):
    import threading

    mv = serving.MultiViewGazePredictor(ckpts["default"], num_views=3, **BASE, micro_batch=MB,
                                        image_size=SIZE, dtype=torch.float32, device="cpu")
    batching = serving.BatchingPredictor(mv, max_delay_ms=20.0)
    reqs = [stacked_request(n, 3, seed=30 + n) for n in (1, 3, 2)]
    out = [None] * len(reqs)

    def call(i):
        out[i] = batching.predict(*reqs[i])

    threads = [threading.Thread(target=call, args=(i,)) for i in range(len(reqs))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        batching.close()
    for req, got in zip(reqs, out):
        np.testing.assert_allclose(got, mv.predict(*req), atol=1e-5, rtol=1e-5)


def test_default_devices_without_card_raise(ckpts, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serving.MultiViewGazePredictor(ckpts["default"], num_views=3, **BASE, image_size=SIZE)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serving.GazePredictor(ckpts["default"], **BASE, image_size=SIZE, int8=True)


# ------------------------------------------------------------ resolution


@pytest.mark.parametrize("size", [48, 20], ids=["downscale", "upscale"])
def test_direct_predict_resizes_other_resolutions(ckpts, size):
    """An off-size request equals the same images resized first and then
    served at image_size (bit for bit: the same resize), and JAX's predictor
    on the off-size request at the model bar. BatchingPredictor still pins
    the resolution (test_torch_serving.py)."""
    port = port_predictor(ckpts["default"])
    req = stereo_request(5, seed=size, size=size)
    got = port.predict(*req)
    # eval_preprocess resizes the float image, then normalises
    pre = [eval_preprocess(torch.from_numpy(img), SIZE) for img in req[:2]]
    with torch.no_grad():
        direct = port.model({"img_0": pre[0], "img_1": pre[1],
                             "rot_0": serving.rotation_matrix_2d(torch.from_numpy(req[2])),
                             "rot_1": serving.rotation_matrix_2d(torch.from_numpy(req[3]))})["pred_gaze"]
    np.testing.assert_array_equal(got[:MB], direct[:MB].numpy())
    np.testing.assert_allclose(got, jax_predictor(ckpts["default"]).predict(*req), **MODEL_BAR)


# ------------------------------------------------------------ int8


@pytest.mark.parametrize("int8", [True, "static"], ids=["dynamic", "static"])
def test_int8_predictor_tracks_jax(ckpts, int8):
    """Static: both calibrate on the same 8 pairs, then serve 8 others."""
    calib, req = stereo_request(8, seed=40), stereo_request(8, seed=41)
    port = port_predictor(ckpts["default"], int8=int8)
    jaxp = jax_predictor(ckpts["default"], int8=int8)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if int8 == "static":
            port.calibrate(*calib)
            jaxp.calibrate(*calib)
        got, want = port.predict(*req), jaxp.predict(*req)
    delta = np.abs(got - want).max(axis=1)
    assert delta.max() <= FLIP_BAR, delta
    assert sum(isinstance(m, QuantConv2d) for m in port.model.modules()) == 20


def _ranges(pred):
    return {tuple(p): float(c.act_amax) for p, c in pred._quant_convs}


def _jax_ranges(pred):
    leaves = jax.tree_util.tree_flatten_with_path(pred.variables["quant"])[0]
    return {tuple(k.key for k in p[:-1]): float(v) for p, v in leaves}


def test_static_calibration_ranges_match_jax(ckpts):
    calib = stereo_request(8, seed=42)
    port = port_predictor(ckpts["default"], int8="static")
    jaxp = jax_predictor(ckpts["default"], int8="static")
    port.calibrate(*calib)
    jaxp.calibrate(*calib)
    got, want = _ranges(port), _jax_ranges(jaxp)
    assert got.keys() == want.keys() and len(got) == 20
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5)


def test_auto_calibration_warns_below_64_samples(ckpts, tmp_dir):
    path = str(tmp_dir / "ranges.msgpack")
    port = port_predictor(ckpts["default"], int8="static", calibration_path=path)
    req = stereo_request(6, seed=43)
    with pytest.warns(UserWarning, match="only 6 sample"):
        first = port.predict(*req)
    assert port._calibrated and all(v > 0 for v in _ranges(port).values())
    ranges = _ranges(port)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        second = port.predict(*req)  # frozen: no warning, ranges unchanged
    assert _ranges(port) == ranges and first.shape == second.shape == (6, 2)
    # saved after the first calibration; a restarted predictor starts frozen
    restarted = port_predictor(ckpts["default"], int8="static", calibration_path=path)
    assert restarted._calibrated and _ranges(restarted) == ranges
    np.testing.assert_array_equal(restarted.predict(*req), second)


def test_empty_batches_never_calibrate(ckpts):
    port = port_predictor(ckpts["default"], int8="static")
    empty = stereo_request(0)
    assert port.predict(*empty).shape == (0, 2)
    assert not port._calibrated
    with pytest.raises(ValueError, match="at least 1 sample"):
        port.calibrate(*empty)
    assert not port._calibrated


def test_warmup_discards_the_noise_ranges(ckpts):
    port = port_predictor(ckpts["default"], int8="static")
    port.warmup()
    assert not port._calibrated and all(v == 0.0 for v in _ranges(port).values())
    calibrated = port_predictor(ckpts["default"], int8="static")
    calibrated.calibrate(*stereo_request(4, seed=44))
    ranges = _ranges(calibrated)
    calibrated.warmup()  # already calibrated: ranges untouched
    assert calibrated._calibrated and _ranges(calibrated) == ranges


def test_save_load_reset_calibration(ckpts, tmp_dir):
    calib, req = stereo_request(8, seed=45), stereo_request(5, seed=46)
    first = port_predictor(ckpts["default"], int8="static")
    first.calibrate(*calib)
    path = first.save_calibration(str(tmp_dir / "c.msgpack"))
    second = port_predictor(ckpts["default"], int8="static")
    second.load_calibration(path)
    assert second._calibrated
    np.testing.assert_array_equal(second.predict(*req), first.predict(*req))
    second.reset_calibration()
    assert not second._calibrated and all(v == 0.0 for v in _ranges(second).values())


def test_calibration_api_refusals(ckpts, tmp_dir):
    with pytest.raises(ValueError, match="requires int8='static'"):
        port_predictor(ckpts["default"], int8=True, calibration_path=str(tmp_dir / "x.msgpack"))
    dyn = port_predictor(ckpts["default"], int8=True)
    for call in (lambda: dyn.calibrate(*stereo_request(2)), lambda: dyn.save_calibration("x"),
                 lambda: dyn.load_calibration("x")):
        with pytest.raises(RuntimeError):
            call()
    dyn.reset_calibration()  # a no-op off the static path, as in JAX
    # a calibration of another architecture is refused
    r18 = port_predictor(ckpts["default"], int8="static")
    r18.calibrate(*stereo_request(2))
    path = r18.save_calibration(str(tmp_dir / "r18.msgpack"))
    other = tmp_dir / "r34.pth.tar"
    write_reference_checkpoint(str(other), {**BASE, "backbone_depth": 34}, SIZE)
    r34 = serving.GazePredictor(str(other), backbone_depth=34, num_iter=2, micro_batch=MB,
                                image_size=SIZE, dtype=torch.float32, int8="static", device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        r34.load_calibration(path)
    with pytest.raises(ValueError, match="not a calibration file"):
        r18.load_calibration(ckpts["default"])


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_calibration_files_load_in_the_other_package(ckpts, tmp_dir, writer):
    calib = stereo_request(8, seed=47)
    port = port_predictor(ckpts["default"], int8="static")
    jaxp = jax_predictor(ckpts["default"], int8="static")
    path = str(tmp_dir / f"{writer}.msgpack")
    if writer == "port":
        port.calibrate(*calib)
        port.save_calibration(path)
        jaxp.load_calibration(path)
    else:
        jaxp.calibrate(*calib)
        jaxp.save_calibration(path)
        port.load_calibration(path)
    assert port._calibrated and jaxp._calibrated
    assert _ranges(port) == _jax_ranges(jaxp)


def test_multiview_static_calibration_uses_the_stereo_format(ckpts, tmp_dir):
    """A V-view predictor's calibration file is the stereo one's (the same
    backbone paths), so it loads into a stereo predictor."""
    mv = serving.MultiViewGazePredictor(ckpts["default"], num_views=3, **BASE, micro_batch=MB,
                                        image_size=SIZE, dtype=torch.float32, int8="static", device="cpu")
    mv.calibrate(*stacked_request(4, 3, seed=48))
    path = mv.save_calibration(str(tmp_dir / "mv.msgpack"))
    st = port_predictor(ckpts["default"], int8="static")
    st.load_calibration(path)
    assert _ranges(st) == _ranges(mv)


# ------------------------------------------------------------ bf16


def test_bf16_is_no_farther_from_jax_f32_than_jax_bf16(tmp_dir):
    """tests/test_torch_serving.py's fixture (R18, 2 iterations, 64x64, the
    same checkpoint and its 16-pair request at seed 0). The margin is thin
    on this random network: over five seeds of 64 pairs the port's mean
    angle was 0.264-0.306 deg against JAX's 0.195-0.227 (ROADMAP Queue C),
    while every earlier stage of the port's bf16 is closer to float32 than
    JAX's bf16 is."""
    size = 64
    ckpt = write_reference_checkpoint(str(tmp_dir / "m.pth.tar"), BASE, size)
    req = stereo_request(16, seed=0, size=size)

    def run(cls, dtype):
        return cls(ckpt, **BASE, micro_batch=8, image_size=size, dtype=dtype,
                   **({"device": "cpu"} if cls is serving.GazePredictor else {})).predict(*req)

    jax_f32 = run(JaxGazePredictor, jnp.float32).astype(np.float64)
    jax_bf16 = angular_error_numpy(run(JaxGazePredictor, jnp.bfloat16).astype(np.float64), jax_f32)
    port_bf16 = angular_error_numpy(run(serving.GazePredictor, torch.bfloat16).astype(np.float64), jax_f32)
    assert port_bf16.mean() <= jax_bf16.mean() + 0.1, (port_bf16.mean(), jax_bf16.mean())
    assert port_bf16.max() <= jax_bf16.max() + 0.1, (port_bf16.max(), jax_bf16.max())


# ------------------------------------------------------------ serve.py


@pytest.mark.parametrize(
    "argv, names",
    [
        # --dp is ported (serving over a mesh, int8 too); the V-view server's
        # mesh is data-parallel only, as JAX's
        (["--dp", "--num_views", "3", "--spatial_partition", "2", "--device", "cpu,cpu"],
         "--num_views 3 with --spatial_partition > 1"),
        # ported: with one visible device, JAX's server refuses it too
        (["--spatial_partition", "2", "--device", "cpu"], "--spatial_partition 2 needs >1 visible device"),
        (["--num_views", "3", "--encode_rotmat"], "--num_views 3 with --encode_rotmat"),
        (["--num_views", "4", "--share_feature"], "--num_views 4 with --share_feature"),
        (["--num_views", "1"], "--num_views 1 (must be >= 2)"),
    ],
    ids=["dp", "spatial_partition", "v3_encode_rotmat", "v4_share_feature", "v1"],
)
def test_serve_refusals_exit_before_loading(argv, names):
    """Refused before anything loads: the checkpoint does not exist."""
    args = serve.get_parser().parse_args(["--ckpt", "/nonexistent.pth.tar", *argv])
    assert any(names in r for r in serve.refused(args))
    with pytest.raises(SystemExit) as e:
        serve.main(["--ckpt", "/nonexistent.pth.tar", "--device", "cpu", *argv])
    assert e.value.code not in (0, None) and names in str(e.value.code)


def test_serve_accepts_the_stereo_ablations_and_int8_flags():
    for argv in (["--share_weights", "--ignore_rotmat"], ["--encode_rotmat"], ["--share_feature"],
                 ["--num_views", "3", "--share_weights", "--ignore_rotmat"], ["--int8"],
                 ["--int8_static", "--calibration", "c.msgpack"]):
        args = serve.get_parser().parse_args(["--ckpt", "x", *argv])
        assert serve.refused(args) == []
