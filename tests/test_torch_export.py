"""The port's serving artifacts (rot_mvgaze_tpu_torch.export, .export_model)
on the CPU: an exported program served by AotGazePredictor predicts what the
live predictor predicts, bit for bit (the program runs the same operations
on the same inputs; its 4-D weights are loaded channels_last, as the live
model holds them), and JAX's predictor at the model bar, atol 2e-4 / rtol
1e-3 (tests/test_model_parity.py:120); static int8 and a wrong checkpoint
are refused; the artifact holds no weights; loading it needs the fuser's
operator library and no model code. R18, 2 fusion iterations, 32x32.
"""

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rot_mvgaze_tpu.serving import GazePredictor as JaxGazePredictor
from rot_mvgaze_tpu.train.checkpoints import save_state as jax_save_state
from rot_mvgaze_tpu_torch import export, export_model, serving

from test_torch_serving_surface import (  # noqa: E402  (tests/ is on sys.path under pytest)
    BASE,
    MB,
    MODEL_BAR,
    SIZE,
    stacked_request,
    stereo_request,
    tmp_dir,  # noqa: F401  (a fixture)
    write_reference_checkpoint,
)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ckpt():
    with tempfile.TemporaryDirectory() as root:
        yield write_reference_checkpoint(f"{root}/m.pth.tar", BASE, SIZE)


def live(ckpt, **kw):
    return serving.GazePredictor(ckpt, **BASE, micro_batch=MB, image_size=SIZE,
                                 dtype=kw.pop("dtype", torch.float32), device="cpu", **kw)


def round_trip(pred, path, num_views=None):
    export.export_serving_artifact(pred.model, str(path), micro_batch=MB, image_size=SIZE, num_views=num_views)
    return str(path)


@pytest.mark.parametrize(
    "flags",
    [{}, {"int8": True}, {"share_weights": True}, {"encode_rotmat": True}, {"share_feature": True}],
    ids=["default", "int8_dynamic", "share_weights", "encode_rotmat", "share_feature"],
)
def test_round_trip_predicts_what_the_live_predictor_predicts(tmp_dir, flags):
    cfg = {**BASE, **{k: v for k, v in flags.items() if k != "int8"}}
    path = write_reference_checkpoint(str(tmp_dir / "m.pth.tar"), cfg, SIZE)
    pred = serving.GazePredictor(path, **cfg, micro_batch=MB, image_size=SIZE, dtype=torch.float32,
                                 int8=flags.get("int8", False), device="cpu")
    artifact = round_trip(pred, tmp_dir / "a.pt2")
    aot = export.AotGazePredictor(artifact, path, device="cpu")
    req = stereo_request(6, seed=1)
    np.testing.assert_array_equal(aot.predict(*req), pred.predict(*req))


def test_round_trip_matches_jax(ckpt, tmp_dir):
    aot = export.AotGazePredictor(round_trip(live(ckpt), tmp_dir / "a.pt2"), ckpt, device="cpu")
    req = stereo_request(6, seed=2)
    want = JaxGazePredictor(ckpt, **BASE, micro_batch=MB, image_size=SIZE, dtype=jnp.float32).predict(*req)
    np.testing.assert_allclose(aot.predict(*req), want, **MODEL_BAR)


def test_multiview_round_trip(ckpt, tmp_dir):
    mv = serving.MultiViewGazePredictor(ckpt, num_views=3, **BASE, micro_batch=MB, image_size=SIZE,
                                        dtype=torch.float32, device="cpu")
    artifact = round_trip(mv, tmp_dir / "mv.pt2", num_views=3)
    aot = export.AotGazePredictor(artifact, ckpt, device="cpu")
    assert aot.num_views == 3 and aot.request_fields == ("imgs", "head_poses")
    req = stacked_request(5, 3, seed=3)
    np.testing.assert_array_equal(aot.predict(*req), mv.predict(*req))
    with pytest.raises(ValueError):
        aot.predict(*stereo_request(2))


def test_bf16_artifact_casts_the_checkpoint(ckpt, tmp_dir):
    """A float32 checkpoint serves a bf16 artifact (cast to each input's
    dtype, BatchNorm kept in float32 as the live predictor keeps it)."""
    pred = live(ckpt, dtype=torch.bfloat16)
    meta_path = round_trip(pred, tmp_dir / "b.pt2")
    meta = json.loads(Path(meta_path + ".json").read_text())
    dtypes = {k: d for k, _, d in meta["state"]}
    assert dtypes["_feat_extractor.0.conv1.weight"] == "bfloat16"
    assert dtypes["_feat_extractor.0.bn1.running_var"] == "float32"
    aot = export.AotGazePredictor(meta_path, ckpt, device="cpu")
    req = stereo_request(6, seed=4)
    np.testing.assert_array_equal(aot.predict(*req), pred.predict(*req))


def test_artifact_holds_no_weights_and_one_fuser_node_per_call(ckpt, tmp_dir):
    pred = live(ckpt)
    program = export.export_serving_artifact(pred.model, str(tmp_dir / "a.pt2"), micro_batch=MB,
                                             image_size=SIZE)
    weight_bytes = sum(v.numel() * v.element_size() for v in pred.model.state_dict().values())
    assert os.path.getsize(tmp_dir / "a.pt2") < weight_bytes / 10
    assert len(program.state_dict) == 0
    fusers = [n for n in program.graph.nodes if "mvgaze.rotate_concat_matmul_relu" in str(n.target)]
    assert len(fusers) == 2 * BASE["num_iter"]  # 2 views x num_iter iterations


def test_static_int8_is_refused(ckpt, tmp_dir):
    pred = live(ckpt, int8="static")
    with pytest.raises(ValueError, match="static-int8"):
        export.export_serving_artifact(pred.model, str(tmp_dir / "s.pt2"), micro_batch=MB, image_size=SIZE)


def test_wrong_checkpoint_is_refused(ckpt, tmp_dir):
    artifact = round_trip(live(ckpt), tmp_dir / "a.pt2")
    r34 = write_reference_checkpoint(str(tmp_dir / "r34.pth.tar"), {**BASE, "backbone_depth": 34}, SIZE)
    with pytest.raises(ValueError, match="wrong checkpoint"):
        export.AotGazePredictor(artifact, r34, device="cpu")
    iter3 = write_reference_checkpoint(str(tmp_dir / "i3.pth.tar"), {**BASE, "num_iter": 1}, SIZE)
    with pytest.raises(ValueError, match="wrong checkpoint"):
        export.AotGazePredictor(artifact, iter3, device="cpu")
    os.remove(artifact + ".json")
    with pytest.raises(FileNotFoundError):
        export.AotGazePredictor(artifact, ckpt, device="cpu")


def test_multiview_export_needs_num_views(ckpt, tmp_dir):
    mv = serving.MultiViewGazePredictor(ckpt, num_views=3, **BASE, micro_batch=MB, image_size=SIZE,
                                        dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError):
        export.export_serving_artifact(mv.model, str(tmp_dir / "x.pt2"), micro_batch=MB, image_size=SIZE)
    with pytest.raises(ValueError):
        export.export_serving_artifact(live(ckpt).model, str(tmp_dir / "y.pt2"), num_views=3)


def test_a_jax_msgpack_serves_the_artifact(ckpt, tmp_dir):
    """The sidecar's configuration converts a JAX checkpoint."""
    from rot_mvgaze_tpu.compat import convert_rot_mv_state_dict, load_torch_state_dict

    variables = convert_rot_mv_state_dict(load_torch_state_dict(ckpt), **BASE)
    msgpack_path = str(tmp_dir / "v.msgpack")
    jax_save_state(msgpack_path, variables)
    pred = live(ckpt)
    aot = export.AotGazePredictor(round_trip(pred, tmp_dir / "a.pt2"), msgpack_path, device="cpu")
    req = stereo_request(5, seed=5)
    np.testing.assert_array_equal(aot.predict(*req), pred.predict(*req))


def test_aot_predictor_default_device_without_card_raises(ckpt, tmp_dir, monkeypatch):
    artifact = round_trip(live(ckpt), tmp_dir / "a.pt2")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        export.AotGazePredictor(artifact, ckpt)


def test_export_model_command_line(ckpt, tmp_dir, capsys):
    out = str(tmp_dir / "cli.pt2")
    assert export_model.main(["--ckpt", ckpt, "--out", out, "--micro_batch", str(MB), "--image_size",
                              str(SIZE), "--device", "cpu", "--backbone_depth", "18", "--num_iter", "2",
                              "--f32"]) == 0
    assert "exported" in capsys.readouterr().out
    aot = export.AotGazePredictor(out, ckpt, device="cpu")
    req = stereo_request(4, seed=6)
    np.testing.assert_array_equal(aot.predict(*req), live(ckpt).predict(*req))
    with pytest.raises(SystemExit):
        export_model.main(["--ckpt", ckpt, "--out", out, "--num_views", "3", "--share_feature"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        real = torch.cuda.is_available
        torch.cuda.is_available = lambda: False
        try:
            export_model.main(["--ckpt", ckpt, "--out", out])
        finally:
            torch.cuda.is_available = real


def test_loading_an_artifact_needs_the_operator_library_only(ckpt, tmp_dir):
    """A fresh process that imports ops.fusion (and no model code) loads the
    program and runs it with a state dict read by torch.load."""
    pred = live(ckpt)
    artifact = round_trip(pred, tmp_dir / "a.pt2")
    req = stereo_request(MB, seed=7)
    np.savez(tmp_dir / "req.npz", *req)
    want = pred.predict(*req)
    code = f"""
import json, sys, numpy as np, torch
import rot_mvgaze_tpu_torch.ops.fusion
program = torch.export.load({artifact!r}).module()
meta = json.load(open({artifact!r} + ".json"))
sd = torch.load({ckpt!r}, weights_only=True)
state = {{k: sd[k].to(getattr(torch, d)).contiguous(memory_format=torch.channels_last if len(s) == 4
         else torch.contiguous_format) for k, s, d in meta["state"]}}
req = np.load({str(tmp_dir / 'req.npz')!r})
args = [torch.from_numpy(req[f"arr_{{i}}"]) for i in range(4)]
out = program(state, *args).numpy()
np.save({str(tmp_dir / 'out.npy')!r}, out)
print(json.dumps(sorted(m for m in sys.modules if m.startswith("rot_mvgaze_tpu_torch"))))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    assert not any(m.startswith(("rot_mvgaze_tpu_torch.models", "rot_mvgaze_tpu_torch.serving")) for m in loaded)
    np.testing.assert_array_equal(np.load(tmp_dir / "out.npy"), want)
