"""Device meshes in the port (rot_mvgaze_tpu_torch.parallel.mesh) and the
paths that take them (serving, serve.py, the Trainer and the command line)
against the JAX package's on the CPU, the port's meshes over ``["cpu"] *
n`` beside JAX's 8 virtual CPU devices (tests/conftest.py).

- ``make_mesh`` shapes and guards, ``min_spatial_shard_rows`` against
  JAX's over h <= 64 and n <= 8, the strip split, ``with_spatial_floor``,
  the batch placement rule.
- ``GazePredictor(mesh=)`` on ``(data 8)`` and ``(data 4, spatial 2)``
  against JAX's predictors on the same meshes (the model bar, atol 2e-4 /
  rtol 1e-3) and against the port's single-device predictor (atol 1e-5,
  JAX's own bar); micro-batches 6 -> 8 and 3 -> 4; the "not divisible"
  refusal; ``MultiViewGazePredictor`` data-parallel, a spatial mesh
  refused; ``BatchingPredictor`` in front (int8 under a mesh:
  tests/test_torch_int8_mesh.py).
- serve.py's ``--dp`` / ``--spatial_partition`` checks in JAX's words, and
  its HTTP answers over a CPU mesh, float32 and static int8.
- The command line: ``--spatial_partition 2`` end to end on a logical CPU
  mesh (``--device cpu,cpu``: train, evaluate, checkpoint, rc 0, then test
  mode from the checkpoint), and the refusals in JAX's words beside JAX's.
"""

import glob
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rot_mvgaze_tpu.models import FeatRotationSymm as JaxFeatRotationSymm
from rot_mvgaze_tpu.models.resnet import min_spatial_shard_rows as jax_min_rows
from rot_mvgaze_tpu.parallel.mesh import make_mesh as jax_make_mesh
from rot_mvgaze_tpu.serving import GazePredictor as JaxGazePredictor
from rot_mvgaze_tpu.train.checkpoints import save_state as jax_save_state
from rot_mvgaze_tpu_torch import parallel, serve
from rot_mvgaze_tpu_torch.cli import main as cli
from rot_mvgaze_tpu_torch.data import write_synthetic_dataset
from rot_mvgaze_tpu_torch.losses import IterationLoss, MultiViewL1Loss
from rot_mvgaze_tpu_torch.models import FeatRotationMultiView, FeatRotationSymm
from rot_mvgaze_tpu_torch.parallel import (
    DATA_AXIS,
    SPATIAL_AXIS,
    Sharded,
    dp_size,
    make_mesh,
    min_spatial_shard_rows,
    shard_batch,
    spatial_size,
    split_sizes,
    visible_devices,
    with_spatial_floor,
)
from rot_mvgaze_tpu_torch.serving import BatchingPredictor, GazePredictor, MultiViewGazePredictor
from rot_mvgaze_tpu_torch.train import Trainer
from rot_mvgaze_tpu_torch.utils.config import load_yaml

jax_cli = importlib.import_module("rot_mvgaze_tpu.cli.main")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 32
KW = dict(backbone_depth=18, num_iter=1, image_size=SIZE)
MODEL_BAR = dict(atol=2e-4, rtol=1e-3)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------ the mesh


def test_make_mesh_shapes():
    cpus = ["cpu"] * 8
    m1 = make_mesh(cpus)
    assert m1.axis_names == (DATA_AXIS,) and m1.shape == {"data": 8}
    assert dp_size(m1) == 8 and spatial_size(m1) == 1 and m1.devices.shape == (8,)
    m2 = make_mesh([f"cpu:{i}" for i in range(8)], spatial=2)
    assert m2.axis_names == (DATA_AXIS, SPATIAL_AXIS) and m2.devices.shape == (4, 2)
    assert dp_size(m2) == 4 and spatial_size(m2) == 2
    # halo partners are consecutive devices, as make_mesh groups them in JAX
    assert [str(d) for d in m2.grid[0]] == ["cpu:0", "cpu:1"] and str(m2.grid[1][0]) == "cpu:2"
    assert dp_size(None) == 1 and spatial_size(None) == 1
    # the same shapes as JAX's over its 8 devices
    jm = jax_make_mesh(jax.devices(), spatial=2)
    assert tuple(jm.shape.values()) == tuple(m2.shape.values())


@pytest.mark.parametrize("devices,spatial,match", [(["cpu"] * 8, 3, "divide the device count"),
                                                   ([], 1, "no devices")],
                         ids=["spatial_must_divide", "empty"])
def test_make_mesh_guards(devices, spatial, match):
    with pytest.raises(ValueError, match=match):
        make_mesh(devices, spatial=spatial)


def test_make_mesh_defaults_to_the_visible_cards():
    if torch.cuda.is_available():
        assert make_mesh().shape == {"data": torch.cuda.device_count()}
    else:
        with pytest.raises(ValueError, match="no card is visible"):
            make_mesh()


@pytest.mark.parametrize("n", range(1, 9))
def test_min_spatial_shard_rows_is_jaxs(n):
    for h in range(1, 65):
        assert min_spatial_shard_rows(h, n) == jax_min_rows(h, n), (h, n)


@pytest.mark.parametrize("h,n,sizes", [(224, 2, [112, 112]), (7, 2, [4, 3]), (10, 4, [3, 3, 3, 1]),
                                        (56, 4, [14, 14, 14, 14]), (13, 4, [4, 4, 4, 1])])
def test_split_sizes(h, n, sizes):
    assert split_sizes(h, n) == sizes and sizes[-1] == min_spatial_shard_rows(h, n)


def test_split_sizes_refuses_an_empty_strip():
    with pytest.raises(ValueError, match="empty strip"):
        split_sizes(9, 4)  # 3, 3, 3, 0


def test_with_spatial_floor():
    class NoFloor:
        pass

    model = NoFloor()
    assert with_spatial_floor(model, None) is model
    assert with_spatial_floor(model, make_mesh(["cpu"] * 2)) is model
    with pytest.raises(ValueError, match="spatial_unshard"):
        with_spatial_floor(model, make_mesh(["cpu"] * 2, spatial=2))
    stereo = FeatRotationSymm(backbone_depth=18, num_iter=1)
    assert stereo.spatial_unshard is None
    assert with_spatial_floor(stereo, make_mesh(["cpu"] * 4, spatial=2)) is stereo
    assert stereo.spatial_unshard == 2 and stereo._feat_extractor[0].spatial_unshard == 2
    with pytest.raises(ValueError, match="spatial_unshard"):
        with_spatial_floor(FeatRotationMultiView(backbone_depth=18, num_iter=1),
                           make_mesh(["cpu"] * 2, spatial=2))


@pytest.mark.parametrize("devices,spatial,blocks", [
    (["cpu"] * 8, 2, [[(2, 32, 64, 3)] * 2] * 4),
    (["cpu"] * 8, 1, [[(1, 64, 64, 3)]] * 8),
    (["cpu"], 1, None),
    (None, 1, None),
], ids=["data4_spatial2", "data8", "one_device", "no_mesh"])
def test_batch_placement(devices, spatial, blocks):
    mesh = None if devices is None else make_mesh(devices, spatial=spatial)
    img = torch.arange(8 * 64 * 64 * 3, dtype=torch.float32).reshape(8, 64, 64, 3)
    gaze, step = torch.zeros(8, 2), torch.zeros(())
    placed = shard_batch({"img_0": img, "gt_gaze": gaze, "step": step}, mesh)
    # only the images are cut; the rest stays whole on the first device
    assert placed["gt_gaze"] is gaze and placed["step"] is step
    if blocks is None:
        assert placed["img_0"] is img
        return
    assert isinstance(placed["img_0"], Sharded) and placed["img_0"].shape == (8, 64, 64, 3)
    assert [[tuple(t.shape) for t in row] for row in placed["img_0"].rows] == blocks
    last = placed["img_0"].rows[-1][-1]
    torch.testing.assert_close(last, img[-last.shape[0]:, 64 - last.shape[1]:], rtol=0, atol=0)
    assert all(t.is_contiguous() for t in placed["img_0"].blocks())


# ------------------------------------------------------------ serving


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A .msgpack of JAX-initialised R18 x 1 variables (both packages load it)."""
    data = {"img_0": jnp.zeros((1, SIZE, SIZE, 3)), "img_1": jnp.zeros((1, SIZE, SIZE, 3)),
            "rot_0": jnp.eye(3)[None], "rot_1": jnp.eye(3)[None]}
    variables = JaxFeatRotationSymm(backbone_depth=18, num_iter=1).init(jax.random.PRNGKey(0), data)
    return jax_save_state(str(tmp_path_factory.mktemp("mesh_ckpt") / "model.msgpack"), dict(variables))


def _request(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, SIZE, SIZE, 3), dtype=np.uint8),
            rng.integers(0, 256, (n, SIZE, SIZE, 3), dtype=np.uint8),
            rng.uniform(-0.5, 0.5, (n, 2)).astype(np.float32),
            rng.uniform(-0.5, 0.5, (n, 2)).astype(np.float32))


MESHES = {  # name -> (port devices, spatial, micro_batch asked, rounded)
    "data8": (8, 1, 6, 8),
    "data4_spatial2": (8, 2, 3, 4),
}


@pytest.mark.parametrize("name", sorted(MESHES))
def test_mesh_predictor_matches_jax_and_single(ckpt, name):
    """11 pairs (a full and a padded micro-batch) through the port's mesh
    predictor, JAX's on the same mesh, and the port's single-device one."""
    n_dev, sp, asked, rounded = MESHES[name]
    args = _request(11, seed=1)
    port = GazePredictor(ckpt, micro_batch=asked, mesh=make_mesh(["cpu"] * n_dev, spatial=sp),
                         dtype=torch.float32, **KW)
    assert port.micro_batch == rounded  # a multiple of the data axis, not of the device count
    assert port.model.spatial_unshard == (sp if sp > 1 else None)
    jax_pred = JaxGazePredictor(ckpt, micro_batch=asked, mesh=jax_make_mesh(jax.devices(), spatial=sp),
                                dtype=jnp.float32, **KW)
    assert jax_pred.micro_batch == rounded
    single = GazePredictor(ckpt, micro_batch=8, dtype=torch.float32, device="cpu", **KW)
    got = port.predict(*args)
    assert got.shape == (11, 2) and np.isfinite(got).all()
    np.testing.assert_allclose(got, jax_pred.predict(*args), **MODEL_BAR)
    np.testing.assert_allclose(got, single.predict(*args), atol=1e-5, rtol=0)
    assert port.micro_batches_run == -(-11 // rounded)
    batching = BatchingPredictor(port)
    try:
        np.testing.assert_allclose(batching.predict(*args), got, atol=1e-6, rtol=0)
    finally:
        batching.close()


def test_spatial_predictor_refuses_an_uneven_split(ckpt):
    with pytest.raises(ValueError, match="not divisible"):
        GazePredictor(ckpt, micro_batch=4, mesh=make_mesh(["cpu"] * 4, spatial=4), dtype=torch.float32,
                      backbone_depth=18, num_iter=1, image_size=30)


def test_multiview_predictor_is_data_parallel_only(ckpt):
    rng = np.random.default_rng(3)
    imgs = rng.integers(0, 256, (5, 3, SIZE, SIZE, 3), dtype=np.uint8)
    poses = rng.uniform(-0.5, 0.5, (5, 3, 2)).astype(np.float32)
    mesh_pred = MultiViewGazePredictor(ckpt, 3, micro_batch=3, mesh=make_mesh(["cpu"] * 4),
                                       dtype=torch.float32, **KW)
    assert mesh_pred.micro_batch == 4
    single = MultiViewGazePredictor(ckpt, 3, micro_batch=4, dtype=torch.float32, device="cpu", **KW)
    np.testing.assert_allclose(mesh_pred.predict(imgs, poses), single.predict(imgs, poses), atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="does not support spatial meshes"):
        MultiViewGazePredictor(ckpt, 3, micro_batch=4, mesh=make_mesh(["cpu"] * 2, spatial=2), **KW)


# ------------------------------------------------------------ serve.py

SERVE_REFUSALS = {  # name -> (flags, JAX's words)
    "spatial_one_device": (["--spatial_partition", "2", "--device", "cpu"], "needs >1 visible device (have 1)"),
    "spatial_must_divide": (["--spatial_partition", "3", "--device", "cpu,cpu,cpu"],
                            "--spatial_partition 3 must divide --image_size 224"),
    "v3_spatial": (["--num_views", "3", "--spatial_partition", "2", "--device", "cpu,cpu"],
                   "--num_views 3 with --spatial_partition > 1"),
}


@pytest.mark.parametrize("name", sorted(SERVE_REFUSALS))
def test_serve_mesh_refusals(name):
    flags, words = SERVE_REFUSALS[name]
    with pytest.raises(SystemExit) as e:
        serve.main(["--ckpt", "/nonexistent.pth.tar", *flags])
    assert words in str(e.value.code)


def test_serve_mesh_flags():
    parse = serve.get_parser().parse_args
    args = parse(["--ckpt", "x", "--dp", "--device", "cpu"])
    assert serve.refused(args) == [] and not serve.serves_on_a_mesh(args)  # one device: no mesh
    args = parse(["--ckpt", "x", "--dp", "--spatial_partition", "2", "--device", "cpu,cpu,cpu,cpu"])
    assert serve.refused(args) == [] and serve.serves_on_a_mesh(args)
    assert [str(d) for d in visible_devices("cuda:0,cuda:0")] == ["cuda:0", "cuda:0"]
    assert len(visible_devices("cuda")) == torch.cuda.device_count()
    assert [str(d) for d in visible_devices("cpu")] == ["cpu"]


# ------------------------------------------------------------ the Trainer and the command line


def test_trainer_refuses_a_spatial_mesh_at_v3():
    model = FeatRotationMultiView(backbone_depth=18, num_iter=1)
    metrics = IterationLoss(MultiViewL1Loss(rel_weight=0.01, reference_decay=1.0), iter_decay=0.5)
    config = type("C", (), {"num_views": 3, "output_dir": "unused"})()
    with pytest.raises(ValueError, match="--spatial_partition is not supported with --num_views > 2"):
        Trainer(config, model, metrics, mesh=make_mesh(["cpu"] * 2, spatial=2))


def test_rank_cards_follow_the_spatial_group(monkeypatch):
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert [str(d) for d in parallel.rank_cards(2)] == ["cuda:2", "cuda:3"]
    assert str(parallel.rank_device(2)) == "cuda:2" and str(parallel.rank_device()) == "cuda:1"
    if torch.cuda.device_count() < 4:
        with pytest.raises(ValueError, match="local rank 1 needs cards 2..3"):
            parallel.global_mesh(2)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_cli")
    subjects = load_yaml(os.path.join(REPO, "configs", "subject", "mpiinv.yaml"))["subject"]
    write_synthetic_dataset(str(root / "mpiinv"), subjects, n_frames=1, image_size=SIZE, learnable=True)
    path = root / "data_path.yaml"
    path.write_text(f"xgaze: '{root / 'xgaze'}'\nmpiinv: '{root / 'mpiinv'}'\n")
    return str(path)


def _base(corpus, out):
    return ["--exp_name", "mpiinv_known", "--data_path", corpus, "-out", str(out), "--image_size", str(SIZE),
            "--backbone_depth", "18", "--num_iter", "1", "--native_loader", "false", "--num_workers", "2"]


def test_cli_spatial_partition_end_to_end(corpus, tmp_path, capsys):
    """--spatial_partition 2 over --device cpu,cpu,cpu: one process takes
    two of the devices (the third is named idle), trains an epoch of 270
    pairs in batches of 64, evaluates before and after, saves, exits 0;
    test mode from its checkpoint gives the run's last error."""
    out = tmp_path / "train"
    argv = [*_base(corpus, out), "--device", "cpu,cpu,cpu", "--spatial_partition", "2", "--bf16", "false",
            "--batch_size", "64", "--test_batch_size", "100", "--epochs", "1", "--save_epoch", "1",
            "--print_freq", "2"]
    assert cli.main(argv) == 0
    printed = capsys.readouterr().out
    assert "data-parallel mesh: 2 devices across 1 process(es), spatial partition 2 (dp 1)" in printed
    assert "1 visible device(s) idle (cpu): this process takes 2" in printed
    (results,) = glob.glob(os.path.join(out, "*", "*", "test_results.txt"))
    lines = open(results).read().strip().splitlines()
    assert len(lines) == 2 and all(np.isfinite(float(line.rsplit(" ", 1)[-1])) for line in lines)
    (ckpt,) = glob.glob(os.path.join(out, "*", "*", "ckpt", "*.pth.tar"))
    test_out = tmp_path / "test"
    assert cli.main([*_base(corpus, test_out), "--device", "cpu,cpu", "--spatial_partition", "2", "--mode",
                     "test", "--ckpt_resume", ckpt, "--test_batch_size", "100"]) == 0
    (test_results,) = glob.glob(os.path.join(test_out, "*", "*", "test_results.txt"))
    last = float(lines[-1].rsplit(" ", 1)[-1])
    assert abs(float(open(test_results).read().split("error: ")[1].split()[0]) - last) < 1e-3


CLI_REFUSALS = {  # name -> (port flags, JAX flags, JAX's words)
    "dp_false": (["--device", "cpu,cpu", "--spatial_partition", "2", "--dp", "false"],
                 ["--spatial_partition", "2", "--dp", "false"], "needs the mesh path"),
    "one_device": (["--device", "cpu", "--spatial_partition", "2"], None, "needs the mesh path"),
    "must_divide": (["--device", "cpu,cpu,cpu", "--spatial_partition", "3"], ["--spatial_partition", "3"],
                    "must divide"),
}


@pytest.mark.parametrize("name", sorted(CLI_REFUSALS))
def test_cli_spatial_refusals_in_jaxs_words(corpus, tmp_path, name):
    port_flags, jax_flags, words = CLI_REFUSALS[name]
    with pytest.raises(SystemExit, match=words):
        cli.main([*_base(corpus, tmp_path / "port"), *port_flags])
    assert not os.path.exists(tmp_path / "port")
    if jax_flags is not None:
        args = jax_cli.get_parser().parse_args([*_base(corpus, tmp_path / "jax"), *jax_flags])
        with pytest.raises(SystemExit, match=words):
            jax_cli.build_experiment(args)


def test_serve_py_answers_over_a_cpu_mesh(ckpt, tmp_path):
    """serve.py's build_predictor behind its HTTP handler on 127.0.0.1:
    with --dp --spatial_partition 2 over four CPU devices ((data 2, spatial
    2)), and with --dp --int8_static --calibration over two (data 2; the
    first request calibrates and saves the ranges); the second reply equals
    a direct predict."""
    import http.client
    import io
    import threading
    from http.server import ThreadingHTTPServer

    common = ["--ckpt", ckpt, "--f32", "--backbone_depth", "18", "--num_iter", "1", "--image_size", str(SIZE),
              "--micro_batch", "3"]
    calibration = str(tmp_path / "ranges.msgpack")
    for flags, shape in ((["--dp", "--spatial_partition", "2", "--device", "cpu,cpu,cpu,cpu"],
                          {"data": 2, "spatial": 2}),
                         (["--dp", "--int8_static", "--calibration", calibration, "--device", "cpu,cpu"],
                          {"data": 2})):
        args = serve.get_parser().parse_args(common + flags)
        assert serve.refused(args) == []
        pred = serve.build_predictor(args)
        assert pred.mesh.shape == shape and pred.micro_batch == 4
        batching = BatchingPredictor(pred)
        httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve.build_handler(batching, {"requests": 0, "samples": 0,
                                                                                      "time": 0.0}))
        server = threading.Thread(target=httpd.serve_forever, daemon=True)
        server.start()
        req = _request(5, seed=9)
        try:
            buf = io.BytesIO()
            np.savez(buf, **dict(zip(pred.request_fields, req)))
            conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=120)
            for _ in range(2):  # static int8: the first request calibrates, the second is served frozen
                conn.request("POST", "/predict", body=buf.getvalue())
                reply = conn.getresponse()
                assert reply.status == 200
                got = np.load(io.BytesIO(reply.read()))["pred_gaze"]
            conn.close()
        finally:
            httpd.shutdown()
            httpd.server_close()
            server.join(timeout=30)
            batching.close()
        np.testing.assert_allclose(got, pred.predict(*req), atol=1e-6, rtol=0)
    assert pred._calibrated and os.path.exists(calibration)
