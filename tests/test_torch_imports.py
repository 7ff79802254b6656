"""The port (rot_mvgaze_tpu_torch) and chip_smoke.py stand on torch and numpy
alone: importing them loads neither JAX nor the JAX package, and no source
file names either in an import, not even inside a function. Importing every
module and parsing a command line also loads none of msgpack, yaml and
h5py, which the card's machine does not have (h5py is imported only where
an HDF5 archive is opened)."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (this test file itself holds both, as the others do)
import pytest
import torch  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "rot_mvgaze_tpu", "msgpack", "yaml")
NOT_ON_THE_CARD = ("msgpack", "yaml", "h5py")
PORT_FILES = sorted(
    str(p.relative_to(REPO)) for p in (REPO / "rot_mvgaze_tpu_torch").rglob("*.py")
) + ["chip_smoke.py"]


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


def test_importing_the_port_loads_no_jax():
    code = """
import importlib, json, pkgutil, sys
import rot_mvgaze_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    rot_mvgaze_tpu_torch.__path__, "rot_mvgaze_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
from rot_mvgaze_tpu_torch.cli.main import get_parser
get_parser().parse_args(["--exp_name", "xgaze2mpiinv_known", "--mode", "test", "--ckpt_resume", "x.msgpack"])
from rot_mvgaze_tpu_torch import export_model, serve
serve.get_parser().parse_args(["--ckpt", "x.pth.tar", "--int8_static", "--num_views", "3"])
serve.refused(serve.get_parser().parse_args(["--ckpt", "x.pth.tar", "--dp", "--spatial_partition", "2",
                                            "--device", "cpu,cpu"]))
export_model.get_parser().parse_args(["--ckpt", "x.pth.tar", "--out", "a.pt2", "--int8"])
print(json.dumps({"imported": names, "loaded": sorted(sys.modules)}))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "rot_mvgaze_tpu_torch.serving" in result["imported"]
    assert "rot_mvgaze_tpu_torch.ops.fusion" in result["imported"]
    for module in ("ops.batchnorm", "train.steps", "train.schedule", "train.trainer",
                   "losses.gaze", "losses.stereo", "ops.conv_bn", "probe_conv_bn_epilogue",
                   "data.pairing", "data.hdf5", "data.synthetic", "data.pipeline", "evaluate",
                   "train.checkpoints", "train.tb", "utils.helper", "utils.seed",
                   "utils.profiling", "utils.summary", "utils.device", "utils.config",
                   "data.packed", "data.native", "compat.msgpack", "compat.pretrained", "compat.download", "cli.main",
                   "__main__", "models.multiview", "models.single", "losses.multiview",
                   "data.multiview", "train.multiview_steps", "ops.quant", "export", "export_model",
                   "parallel.distributed", "parallel.mesh", "parallel.spatial", "utils.drivers", "bench",
                   "bench_eval", "bench_sweep", "bench_probes", "probe_int8", "probe_int8_static",
                   "bench_loader_scaling", "bench_cold_path", "dryrun", "check_command_budgets"):
        assert f"rot_mvgaze_tpu_torch.{module}" in result["imported"]
    assert [m for m in result["loaded"] if _forbidden(m)] == []
    assert [m for m in result["loaded"] if m.split(".")[0] in NOT_ON_THE_CARD] == []


@pytest.mark.parametrize("path", PORT_FILES)
def test_source_imports_no_jax(path):
    tree = ast.parse((REPO / path).read_text(), filename=path)
    imported = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            imported.append(node.module)
    assert [m for m in imported if _forbidden(m)] == []
