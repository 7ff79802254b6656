"""A run without a card fails and never falls back to the CPU; a run in a
directory that holds only the benchmark fails too."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

import pytest
import torch

from perfbench.tests import tiny


def _run(cwd: str, *argv: str) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-m", "perfbench.run", *argv], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_without_a_card_the_run_exits_nonzero_with_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: this checks the path without one")
    done = _run(tiny.REPO, "--workload", "train_r50_stereo_b512", "--seed", "7", "--seconds", "1")
    assert done.returncode == 2
    assert done.stdout.strip() == ""
    assert "card" in done.stderr


def test_the_benchmark_alone_cannot_run(tmp_path):
    shutil.copytree(os.path.join(tiny.REPO, "perfbench"), tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(tiny.REPO, "BENCHMARK.json"), tmp_path)
    code = ("import sys; from perfbench import run; "
            "sys.exit(0 if run.execute(['--workload', 'train_r50_stereo_b512', '--seed', '1', '--seconds', '1'], "
            "require_card=False) is None else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    done = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env, capture_output=True, text=True,
                          timeout=300)
    assert done.returncode != 0
    assert "rot_mvgaze_tpu_torch" in done.stderr
