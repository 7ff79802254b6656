"""The port's command line at --num_views > 2 (rot_mvgaze_tpu_torch.cli.
main with the V-view Trainer) against the JAX package's on the CPU:
synthetic HDF5 archives of MPII-NV's 15 subjects at 32x32, R18 x 1. Test
mode on one .msgpack of JAX V-view variables within 1e-4 deg of JAX's test
mode; a train run and test mode from its checkpoint; every combination the
JAX command line refuses exits non-zero in both."""

import glob
import importlib
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rot_mvgaze_tpu.models.multiview import FeatRotationMultiView as JaxFeatRotationMultiView
from rot_mvgaze_tpu.train.checkpoints import save_state as jax_save_state
from rot_mvgaze_tpu_torch.cli import main as cli
from rot_mvgaze_tpu_torch.data import write_synthetic_dataset
from rot_mvgaze_tpu_torch.utils.config import load_yaml

jax_cli = importlib.import_module("rot_mvgaze_tpu.cli.main")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--backbone_depth", "18", "--num_iter", "1", "--image_size", "32", "--num_views", "3"]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """MPII-NV's 15 subjects, 1 frame x 18 cameras at 32x32 each (270
    V-view samples), and a .msgpack of R18 x 1 V-view variables whose BN
    statistics are not the initial ones."""
    root = tmp_path_factory.mktemp("mv_cli")
    subjects = load_yaml(os.path.join(REPO, "configs", "subject", "mpiinv.yaml"))["subject"]
    mpiinv = str(root / "mpiinv")
    write_synthetic_dataset(mpiinv, subjects, n_frames=1, image_size=32, learnable=True)
    data_path = root / "data_path.yaml"
    data_path.write_text(f"xgaze: '{root / 'xgaze'}'\nmpiinv: '{mpiinv}'\n")
    init = {"imgs": jnp.zeros((2, 3, 32, 32, 3)), "rots": jnp.broadcast_to(jnp.eye(3), (2, 3, 3, 3))}
    variables = jax.tree.map(np.asarray, JaxFeatRotationMultiView(backbone_depth=18, num_iter=1).init(
        jax.random.PRNGKey(6), init))
    rng = np.random.default_rng(7)

    def perturb(path, x):
        if path[-1].key == "var":
            return rng.uniform(0.5, 2.0, x.shape).astype(x.dtype)
        return rng.normal(0.0, 0.1, x.shape).astype(x.dtype)

    variables["batch_stats"] = jax.tree_util.tree_map_with_path(perturb, variables["batch_stats"])
    ckpt = jax_save_state(str(root / "mv_vars.msgpack"), variables)
    yield {"root": root, "data_path": str(data_path), "ckpt": ckpt}
    shutil.rmtree(root, ignore_errors=True)


def _mean_error(out_dir):
    (path,) = glob.glob(os.path.join(out_dir, "*", "*", "test_results.txt"))
    with open(path) as f:
        return float(f.read().split("error: ")[1].split()[0])


def test_test_mode_matches_the_jax_command_line(setup, capsys):
    """The same .msgpack through both command lines' test mode at V=3: the
    mean error (view 0) within 1e-4 deg; the HDF5 loader serves, as in
    JAX, and the breakdown groups by view 0's camera."""
    root = setup["root"]
    common = ["--exp_name", "mpiinv_known", "--mode", "test", "--data_path", setup["data_path"],
              "--ckpt_resume", setup["ckpt"], "--test_batch_size", "100", *SMALL]
    port_out, jax_out = str(root / "port_test"), str(root / "jax_test")
    assert cli.main([*common, "-out", port_out, "--device", "cpu", "--test_breakdown", "true"]) == 0
    assert "V-view mode: using the h5py loader (packed cache is stereo)" in capsys.readouterr().out
    assert jax_cli.main([*common, "-out", jax_out, "--dp", "false"]) == 0
    got, want = _mean_error(port_out), _mean_error(jax_out)
    assert abs(got - want) < 1e-4, (got, want)
    print(f"V=3 test mode: port {got:.8f} deg, JAX {want:.8f} deg")
    (results,) = glob.glob(os.path.join(port_out, "*", "*", "test_results.txt"))
    report = open(results).read()
    assert "per_camera:" in report and "per_subject:" in report


def test_train_then_test_through_the_command_line(setup, capsys):
    """One epoch of V=3 training from the .msgpack (weights only), then
    test mode from the run's checkpoint: the run's last evaluation."""
    root = setup["root"]
    common = ["--exp_name", "mpiinv_known", "--data_path", setup["data_path"], "--device", "cpu",
              "--test_batch_size", "100", "--bf16", "false", *SMALL]
    train_out = str(root / "train_run")
    assert cli.main([*common, "--mode", "train", "-out", train_out, "--epochs", "1", "--save_epoch", "1",
                     "--batch_size", "90", "--ckpt_resume", setup["ckpt"], "--weights_only", "true",
                     "--print_freq", "1"]) == 0
    printed = capsys.readouterr().out
    assert "train iter 1:" in printed and "imgs/s=" in printed
    (ckpt,) = glob.glob(os.path.join(train_out, "*", "*", "ckpt", "*.pth.tar"))
    state = torch.load(ckpt, weights_only=True)
    assert state["step"] == 3  # 270 samples, drop_last batches of 90
    (results,) = glob.glob(os.path.join(train_out, "*", "*", "test_results.txt"))
    last = float(open(results).read().strip().splitlines()[-1].split("error: ")[1])
    test_out = str(root / "test_run")
    assert cli.main([*common, "--mode", "test", "-out", test_out, "--ckpt_resume", ckpt]) == 0
    assert _mean_error(test_out) == pytest.approx(last, abs=1e-9)


REFUSED = {
    "grad_accum": ["--num_views", "3", "--grad_accum", "2"],
    "spatial_partition": ["--num_views", "3", "--spatial_partition", "2"],
    "encode_rotmat": ["--num_views", "3", "--encode_rotmat", "true"],
    "share_feature": ["--num_views", "4", "--share_feature", "true"],
    "use_pallas_fusion": ["--num_views", "3", "--use_pallas_fusion", "true"],
    "use_pallas_bn": ["--num_views", "3", "--use_pallas_bn", "true"],
    "bn_stat_subsample": ["--num_views", "3", "--bn_stat_subsample", "2"],
    "fuse_views": ["--num_views", "3", "--fuse_views", "true"],
    "pairing_rng": ["--num_views", "3", "--pairing", "rng"],
    "freeze_bn_fuse_views": ["--freeze_bn", "true", "--fuse_views", "true"],
    "ignore_rotmat_encode_rotmat": ["--ignore_rotmat", "true", "--encode_rotmat", "true"],
    "share_feature_encode_rotmat": ["--share_feature", "true", "--encode_rotmat", "true"],
    "share_feature_share_weights": ["--share_feature", "true", "--share_weights", "true"],
    "use_pallas_fusion_ignore_rotmat": ["--use_pallas_fusion", "true", "--ignore_rotmat", "true"],
    "use_pallas_fusion_share_feature": ["--use_pallas_fusion", "true", "--share_feature", "true"],
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_every_jax_refusal_exits_non_zero(setup, case, tmp_path):
    """Each combination the JAX command line refuses (the V-view options
    before any data is read, the model's combinations when it is built)
    exits non-zero in both command lines; the port refuses all of them
    before any data is read (SystemExit naming the flags)."""
    argv = ["--exp_name", "mpiinv_known", "--data_path", setup["data_path"], "--batch_size", "8",
            "--image_size", "32", "--backbone_depth", "18", "--num_iter", "1", "--epochs", "0",
            *REFUSED[case]]
    with pytest.raises((SystemExit, AssertionError, ValueError)) as e:
        jax_cli.main([*argv, "-out", str(tmp_path / "jax"), "--dp", "false", "--native_loader", "false"])
    assert not isinstance(e.value, SystemExit) or e.value.code not in (0, None)
    absent = ["--data_path", str(tmp_path / "absent.yaml")]
    with pytest.raises(SystemExit) as e:
        cli.main([*argv, *absent, "-out", str(tmp_path / "port"), "--device", "cpu"])
    assert e.value.code not in (0, None) and "--" in str(e.value.code)
    assert not os.path.exists(tmp_path / "port")


def test_trainer_refuses_grad_accum_at_v3(tmp_path):
    """The V-view Trainer refuses grad_accum > 1, as JAX's does."""
    from types import SimpleNamespace

    from rot_mvgaze_tpu_torch.losses import IterationLoss, MultiViewL1Loss
    from rot_mvgaze_tpu_torch.models import FeatRotationMultiView
    from rot_mvgaze_tpu_torch.train import Trainer

    config = SimpleNamespace(num_views=3, grad_accum=2, output_dir=str(tmp_path))
    with pytest.raises(ValueError, match="grad_accum > 1 is not supported with num_views > 2"):
        Trainer(config, FeatRotationMultiView(backbone_depth=18, num_iter=1),
                IterationLoss(MultiViewL1Loss(0.01), 0.5), device="cpu")
