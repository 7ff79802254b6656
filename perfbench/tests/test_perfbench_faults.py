"""With the timed path broken underneath, ``correct`` comes out false: once
for each fault a cell can have (perfbench.faults), and for each cell's
control. One chip, so no exchange between chips can be left out."""

from __future__ import annotations

import pytest
import torch

from perfbench import compare, faults, run
from perfbench.drivers import train
from perfbench.manifest import Manifest

ARGS = ["--seed", str(2**32 + 5), "--seconds", "0.3"]


@pytest.mark.parametrize("name", sorted(faults.TRAIN))
def test_training_faults_are_not_correct(tiny_root, name):
    result = run.execute(["--workload", "tiny_train", *ARGS], root=tiny_root, require_card=False,
                         plant=faults.TRAIN[name])
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("name", sorted(faults.SERVE))
def test_serving_faults_are_not_correct(tiny_root, name):
    result = run.execute(["--workload", "tiny_serve", *ARGS], root=tiny_root, require_card=False,
                         plant=faults.SERVE[name])
    assert result["correct"] is False, result["checks"]


def test_serving_control_int8_is_not_correct(tiny_root):
    result = run.execute(["--workload", "tiny_serve", *ARGS], root=tiny_root, require_card=False,
                         traffic_update={"int8": True})
    assert result["correct"] is False, result["checks"]


def test_training_control_fp8_is_not_correct(tiny_root):
    m = Manifest(tiny_root)
    cell = m.cell("tiny_train")
    numbers = train.control_numbers(m.config(cell["config"]), m.traffic(cell["traffic"]), 2**32 + 5,
                                    torch.device("cpu"))
    correct, checks = compare.judge(numbers, m.check("tiny_train")["numbers"], 0)
    assert correct is False, checks
