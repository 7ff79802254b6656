"""The port's command line (rot_mvgaze_tpu_torch.cli.main) against the JAX
package's on the CPU: the parser flag for flag, the refusals before any
data is read, the experiments' pair indices bit for bit from HDF5 archives
and from packs, and test mode's mean error from one .msgpack within 1e-4
deg on both loaders."""

import glob
import importlib
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rot_mvgaze_tpu.models import FeatRotationSymm as JaxFeatRotationSymm
from rot_mvgaze_tpu.train.checkpoints import save_state as jax_save_state
from rot_mvgaze_tpu_torch.cli import main as cli
from rot_mvgaze_tpu_torch.data import write_synthetic_dataset
from rot_mvgaze_tpu_torch.data.native import NativeBatchLoader
from rot_mvgaze_tpu_torch.data.pipeline import BatchLoader
from rot_mvgaze_tpu_torch.serving import GazePredictor
from rot_mvgaze_tpu_torch.utils.config import load_yaml

# the module, not the function main that rot_mvgaze_tpu.cli exports under its name
jax_cli = importlib.import_module("rot_mvgaze_tpu.cli.main")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBJECTS = {name: load_yaml(os.path.join(REPO, "configs", "subject", f"{name}.yaml"))["subject"]
            for name in ("xgaze", "mpiinv")}
EXP_NAMES = [f"{d}_{h}" for d in ("xgaze2mpiinv", "mpiinv2xgaze", "xgaze", "mpiinv")
             for h in ("known", "novel")]
JAX_ACTIONS = {a.dest: a for a in jax_cli.get_parser()._actions if a.dest != "help"}
SMALL = ["--backbone_depth", "18", "--num_iter", "1", "--image_size", "32"]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _data_path(tmp_path, roots):
    path = tmp_path / "data_path.yaml"
    path.write_text("".join(f"{k}: '{v}'\n" for k, v in roots.items()))
    return str(path)


# ---------------------------------------------------------------------------
# the parser
# ---------------------------------------------------------------------------


def _type_name(t):
    return getattr(t, "__name__", t)


@pytest.mark.parametrize("dest", sorted(JAX_ACTIONS))
def test_every_jax_flag_parses_as_in_jax(dest):
    """Option strings (aliases included), type, choices, default and
    nargs as the JAX parser has them; a typed flag converts sample values
    as JAX's does."""
    want = JAX_ACTIONS[dest]
    got = {a.dest: a for a in cli.get_parser()._actions}[dest]
    assert got.option_strings == want.option_strings
    assert _type_name(got.type) == _type_name(want.type)
    assert (got.choices, got.default, got.nargs, got.const, got.required) == \
        (want.choices, want.default, want.nargs, want.const, want.required)
    if callable(want.type) and want.type not in (int, float, str):
        for value in ("true", "False", "1", "no", "50", "resnext50_32x4d", "residual", "7", "x"):
            try:
                expect = want.type(value)
            except Exception as e:  # noqa: BLE001 (the same refusal is the check)
                with pytest.raises(type(e)):
                    got.type(value)
            else:
                assert got.type(value) == expect and type(got.type(value)) is type(expect)


def test_device_is_the_only_new_flag():
    got = {a.dest: a for a in cli.get_parser()._actions if a.dest != "help"}
    assert set(got) - set(JAX_ACTIONS) == {"device"}
    assert set(JAX_ACTIONS) - set(got) == set()
    assert got["device"].default == "cuda"
    args = cli.get_parser().parse_args(["--exp_name", "mpiinv_known", "--ckpt_pretrained", "x",
                                        "-out", "o", "--use_pallas_bn", "residual"])
    assert (args.ckpt_resume, args.output_dir, args.use_pallas_bn) == ("x", "o", "residual")


# ---------------------------------------------------------------------------
# refusals and checks, before any data is read
# ---------------------------------------------------------------------------

REFUSED = {
    # ported; each refused as JAX refuses it, in a combination
    "num_views_3": (["--num_views", "3", "--grad_accum", "2"], "--num_views 3 does not support"),
    "encode_rotmat": (["--encode_rotmat", "true", "--num_views", "3"], "does not support: --encode_rotmat"),
    "share_feature": (["--share_feature", "true", "--share_weights", "true"], "cannot be combined"),
    "ignore_rotmat": (["--ignore_rotmat", "true", "--encode_rotmat", "true"], "cannot be combined"),
    "fuse_views": (["--fuse_views", "true", "--freeze_bn", "true"], "silently inert"),
    "bn_stat_subsample": (["--bn_stat_subsample", "2", "--num_views", "3"],
                          "does not support: --bn_stat_subsample > 1"),
    "bn_stat_subsample_freeze_bn": (["--bn_stat_subsample", "2", "--freeze_bn", "true"],
                                    "silently inert: --bn_stat_subsample > 1"),
    # ported; with --device cpu one device is visible, so JAX's mesh check refuses it
    "spatial_partition": (["--spatial_partition", "2"], "needs the mesh path"),
    # not ported
    "use_pallas_bn_residual": (["--use_pallas_bn", "residual"], "North star"),
    "xla_compiler_options": (["--xla_compiler_options", "{}"], "no counterpart"),
    # the JAX command line's own checks
    "num_views_1": (["--num_views", "1"], "must be >= 2"),
    "freeze_bn_inert": (["--freeze_bn", "true", "--use_pallas_bn", "true"], "silently inert"),
    "weights_only_no_ckpt": (["--weights_only", "true"], "needs --ckpt_resume"),
    "weights_only_auto_resume": (["--weights_only", "true", "--ckpt_resume", "c",
                                  "--auto_resume_dir", "d"], "contradicts"),
    "ema_decay_range": (["--ema_decay", "1.0"], "must be in"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refused_options_exit_before_any_data_is_read(tmp_path, case):
    """SystemExit naming the flag (and its ROADMAP item); the data_path
    does not exist, so reading any data would raise FileNotFoundError."""
    extra, message = REFUSED[case]
    argv = ["--exp_name", "mpiinv_known", "--data_path", str(tmp_path / "absent.yaml"),
            "-out", str(tmp_path / "logs"), "--device", "cpu", *extra]
    with pytest.raises(SystemExit) as e:
        cli.main(argv)
    assert message in str(e.value.code)
    assert not os.path.exists(tmp_path / "logs")


@pytest.mark.parametrize("argv", [["--mode", "train"], ["--exp_name", "mpiinv_known", "--mode", "test"],
                                  ["--exp_name", "mpiinv_known", "--profile_dir", "p"]],
                         ids=["no_exp_name", "test_without_checkpoint", "profile_dir_alone"])
def test_early_checks_are_parser_errors(argv, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main([*argv, "--device", "cpu"])
    assert e.value.code == 2
    assert "error:" in capsys.readouterr().err


def test_the_card_is_the_default_device(tmp_path):
    """Without --device cpu the command line wants the card, and with none
    it raises before reading any data."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the check is for one without")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--exp_name", "mpiinv_known", "--data_path", str(tmp_path / "absent.yaml")])


def test_dp_false_under_a_world_of_processes_is_refused(tmp_path, monkeypatch):
    """torchrun's WORLD_SIZE above 1 with --dp false: each process would
    train a model of its own on its shard; refused before any data is read
    and before the process group starts."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    argv = ["--exp_name", "mpiinv_known", "--data_path", str(tmp_path / "absent.yaml"),
            "-out", str(tmp_path / "logs"), "--device", "cpu", "--dp", "false"]
    with pytest.raises(SystemExit) as e:
        cli.main(argv)
    assert "--dp false under 2 processes" in str(e.value.code)
    assert not os.path.exists(tmp_path / "logs")


def test_python_dash_m_runs_the_command_line(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-m", "rot_mvgaze_tpu_torch", "--exp_name", "mpiinv_known", "--spatial_partition",
         "2", "--bogus", "1", "--device", "cpu", "--data_path", str(tmp_path / "absent.yaml")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert "WARNING: ignoring unrecognized arguments: ['--bogus', '1']" in proc.stderr
    assert "--spatial_partition 2 needs the mesh path" in proc.stderr


# ---------------------------------------------------------------------------
# the experiments' datasets
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def full_corpus(tmp_path_factory):
    """Every configured subject (80 XGaze, 15 MPII-NV), 1 frame x 18 cameras
    of 8x8 each, and its packs (made by the first packed configure_dataset)."""
    root = tmp_path_factory.mktemp("cli_corpus")
    roots = {}
    for i, (name, subjects) in enumerate(SUBJECTS.items()):
        roots[name] = str(root / name)
        write_synthetic_dataset(roots[name], subjects, n_frames=1, image_size=8, seed=100 * i)
    return roots


@pytest.mark.parametrize("exp_name", EXP_NAMES)
def test_experiment_pair_indices_are_jax_bit_for_bit(full_corpus, exp_name):
    """Train and test pair indices, colours and camera splits of each
    exp_name, from the HDF5 archives and from the packs' row counts, equal
    the JAX command line's (the reference pairing: one Random(seed), train
    drawn first); the rng pairing too."""
    for pairing, seed in (("reference", 0), ("rng", 3)):
        want = jax_cli.configure_dataset(exp_name, full_corpus, seed=seed, pairing=pairing)
        for packed in (False, True):
            got = cli.configure_dataset(exp_name, full_corpus, seed=seed, pairing=pairing, packed=packed)
            for g, w in zip(got, want):
                assert (g.dataset_name, g.color_type, g.camera_tag) == \
                    (w.dataset_name, w.color_type, w.camera_tag)
                assert g.idx_to_kv == w.idx_to_kv, (exp_name, pairing, packed)
    with pytest.raises(NotImplementedError):
        cli.configure_dataset(exp_name.split("_")[0], full_corpus)


# options the port refused until it had them: each configures the run as
# the JAX command line's build_experiment does from the same command line
NOW_RUN = {
    "bn_stat_subsample": ["--bn_stat_subsample", "2"],
    "remat": ["--remat", "true"],
    "profile_steps": ["--profile_steps", "3"],
    "profile_steps_and_dir": ["--profile_steps", "3", "--profile_dir", "p"],
}


@pytest.mark.parametrize("case", sorted(NOW_RUN))
def test_once_refused_options_configure_the_run_as_jax(full_corpus, tmp_path, case):
    """The model's bn_stat_subsample and remat, the Trainer's profile_steps
    and trace directory, from the port's and JAX's build_experiment."""
    argv = ["--exp_name", "mpiinv_known", "--data_path", _data_path(tmp_path, full_corpus), "-out",
            str(tmp_path / "logs"), "--image_size", "32", "--backbone_depth", "18", "--num_iter", "1",
            "--native_loader", "false", "--num_workers", "1", *NOW_RUN[case]]
    port = cli.build_experiment(cli.get_parser().parse_args([*argv, "--device", "cpu"]))
    ref = jax_cli.build_experiment(jax_cli.get_parser().parse_args([*argv, "--dp", "false"]))
    backbone = port.model._feat_extractor[0]
    from rot_mvgaze_tpu_torch.models.norm import BatchNormAct

    assert {m.stat_subsample for m in backbone.modules() if isinstance(m, BatchNormAct)} == \
        {ref.model.bn_stat_subsample}
    assert port.model.bn_stat_subsample == ref.model.bn_stat_subsample
    assert port.model.remat == backbone.remat == ref.model.remat
    assert port.profile_steps == ref.profile_steps
    assert port._profile_dir == ref._profile_dir


def test_the_new_options_train_through_the_command_line(eval_setup, capsys):
    """--bn_stat_subsample 2 --remat true --profile_steps 1 together: one
    epoch of 3 updates from the .msgpack's weights, a trace of the second
    update, a checkpoint and test_results.txt."""
    root = eval_setup["root"]
    out = str(root / "new_options")
    assert cli.main(["--exp_name", "mpiinv_known", "--data_path", eval_setup["data_path"], "--device", "cpu",
                     "--test_batch_size", "135", "--bf16", "false", *SMALL, "--mode", "train", "-out", out,
                     "--epochs", "1", "--save_epoch", "1", "--batch_size", "90", "--ckpt_resume",
                     eval_setup["ckpt"], "--weights_only", "true", "--bn_stat_subsample", "2",
                     "--remat", "true", "--profile_steps", "1"]) == 0
    assert "profiler trace of 1 train step(s) saved to" in capsys.readouterr().out
    assert len(glob.glob(os.path.join(out, "*", "*", "profile", "trace.json"))) == 1
    assert len(glob.glob(os.path.join(out, "*", "*", "ckpt", "*.pth.tar"))) == 1
    (results,) = glob.glob(os.path.join(out, "*", "*", "test_results.txt"))
    assert len(open(results).read().strip().splitlines()) == 2


def test_grad_accum_rounds_the_batch(full_corpus, tmp_path, capsys):
    args = cli.get_parser().parse_args(
        ["--exp_name", "mpiinv_known", "--data_path", _data_path(tmp_path, full_corpus),
         "-out", str(tmp_path / "logs"), "--device", "cpu", "--batch_size", "7",
         "--grad_accum", "2", "--image_size", "8", "--backbone_depth", "18", "--num_iter", "1"])
    trainer = cli.build_experiment(args)
    assert args.batch_size == 6 and trainer.train_loader.batch_size == 6
    out = capsys.readouterr().out
    assert "batch_size 7 -> 6 (multiple of grad_accum=2)" in out
    assert "using native packed-cache loader (C++ pool)" in out
    assert isinstance(trainer.train_loader, NativeBatchLoader)


def test_loader_fallbacks_are_printed(full_corpus, tmp_path, capsys, monkeypatch):
    """Without g++, and with packs that cannot be used, the HDF5 loader
    serves, as in the JAX command line; each path printed."""
    import rot_mvgaze_tpu_torch.data.native as native

    base = ["--exp_name", "mpiinv_known", "--data_path", _data_path(tmp_path, full_corpus),
            "-out", str(tmp_path / "logs"), "--device", "cpu", "--image_size", "8",
            "--backbone_depth", "18", "--num_iter", "1", "--num_workers", "2"]
    monkeypatch.setattr(native.NativePool, "available", staticmethod(lambda: False))
    train, test = cli.build_loaders(cli.get_parser().parse_args(base))
    assert isinstance(train, BatchLoader) and type(train.dataset).__name__ == "GazeDataset"
    assert "native loader unavailable (no g++?); using the h5py loader" in capsys.readouterr().out
    monkeypatch.undo()

    def broken(*args, **kwargs):
        raise OSError("cannot map")

    monkeypatch.setattr(native, "pack_dataset", broken)
    train, test = cli.build_loaders(cli.get_parser().parse_args(base))
    assert type(train.dataset).__name__ == "GazeDataset"
    assert "using the h5py loader" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# test mode end to end, against the JAX command line
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def eval_setup(tmp_path_factory):
    """MPII-NV's 15 subjects at 32x32 (270 test pairs) and a .msgpack of
    R18 x 1 variables whose BN statistics are not the initial ones."""
    root = tmp_path_factory.mktemp("cli_eval")
    mpiinv = str(root / "mpiinv")
    write_synthetic_dataset(mpiinv, SUBJECTS["mpiinv"], n_frames=1, image_size=32, learnable=True)
    data = {"img_0": jnp.zeros((2, 32, 32, 3)), "img_1": jnp.zeros((2, 32, 32, 3)),
            "rot_0": jnp.broadcast_to(jnp.eye(3), (2, 3, 3)),
            "rot_1": jnp.broadcast_to(jnp.eye(3), (2, 3, 3))}
    variables = jax.tree.map(np.asarray, JaxFeatRotationSymm(backbone_depth=18, num_iter=1).init(
        jax.random.PRNGKey(4), data))
    rng = np.random.default_rng(5)

    def perturb(path, x):
        if path[-1].key == "var":
            return rng.uniform(0.5, 2.0, x.shape).astype(x.dtype)
        return rng.normal(0.0, 0.1, x.shape).astype(x.dtype)

    variables["batch_stats"] = jax.tree_util.tree_map_with_path(perturb, variables["batch_stats"])
    ckpt = jax_save_state(str(root / "vars.msgpack"), variables)
    yield {"root": root, "data_path": _data_path(root, {"xgaze": str(root / "xgaze"), "mpiinv": mpiinv}),
           "ckpt": ckpt}
    shutil.rmtree(root, ignore_errors=True)  # the runs' checkpoints: a few hundred MB


def _mean_error(out_dir):
    (path,) = glob.glob(os.path.join(out_dir, "*", "*", "test_results.txt"))
    with open(path) as f:
        return float(f.read().split("error: ")[1].split()[0])


@pytest.mark.parametrize("native_loader", ["true", "false"])
def test_test_mode_matches_the_jax_command_line(eval_setup, native_loader, capsys):
    """The same .msgpack through both command lines' test mode: the mean
    error in test_results.txt within 1e-4 deg; the breakdown and the
    export (loaded strictly by GazePredictor) come along."""
    root = eval_setup["root"]
    common = ["--exp_name", "mpiinv_known", "--mode", "test", "--data_path", eval_setup["data_path"],
              "--ckpt_resume", eval_setup["ckpt"], "--test_batch_size", "100",
              "--native_loader", native_loader, *SMALL]
    port_out, jax_out = str(root / f"port_{native_loader}"), str(root / f"jax_{native_loader}")
    export = str(root / f"export_{native_loader}.pth.tar")
    assert cli.main([*common, "-out", port_out, "--device", "cpu", "--test_breakdown", "true",
                     "--export_torch", export]) == 0
    printed = capsys.readouterr().out
    assert ("using native packed-cache loader (C++ pool)" in printed) == (native_loader == "true")
    assert jax_cli.main([*common, "-out", jax_out, "--dp", "false"]) == 0
    got, want = _mean_error(port_out), _mean_error(jax_out)
    assert abs(got - want) < 1e-4, (got, want)
    print(f"test mode, native_loader {native_loader}: port {got:.8f} deg, JAX {want:.8f} deg")
    (results,) = glob.glob(os.path.join(port_out, "*", "*", "test_results.txt"))
    report = open(results).read()
    assert "per_camera:" in report and "per_subject:" in report
    GazePredictor(export, backbone_depth=18, num_iter=1, image_size=32, dtype=torch.float32, device="cpu")


def test_train_then_test_through_the_command_line(eval_setup, capsys):
    """One epoch of training from the .msgpack (weights only, a fresh Adam),
    then test mode from the run's checkpoint: the same mean error as the
    run's last evaluation."""
    root = eval_setup["root"]
    common = ["--exp_name", "mpiinv_known", "--data_path", eval_setup["data_path"], "--device", "cpu",
              "--test_batch_size", "100", "--bf16", "false", *SMALL]
    train_out = str(root / "train_run")
    assert cli.main([*common, "--mode", "train", "-out", train_out, "--epochs", "1", "--save_epoch", "1",
                     "--batch_size", "90", "--ckpt_resume", eval_setup["ckpt"], "--weights_only", "true",
                     "--use_pallas_fusion", "true"]) == 0
    printed = capsys.readouterr().out
    assert "change nothing here: on the card the port always runs its kernels" in printed
    (ckpt,) = glob.glob(os.path.join(train_out, "*", "*", "ckpt", "*.pth.tar"))
    (results,) = glob.glob(os.path.join(train_out, "*", "*", "test_results.txt"))
    last = float(open(results).read().strip().splitlines()[-1].split("error: ")[1])
    test_out = str(root / "test_run")
    assert cli.main([*common, "--mode", "test", "-out", test_out, "--ckpt_resume", ckpt]) == 0
    assert _mean_error(test_out) == pytest.approx(last, abs=1e-9)
