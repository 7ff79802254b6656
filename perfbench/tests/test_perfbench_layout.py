"""The harness finds every piece by name, and a cell added as files alone
runs its CPU dry path."""

from __future__ import annotations

import json
import os

import pytest

from perfbench import run
from perfbench.manifest import Manifest
from perfbench.tests import tiny

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_every_piece_is_found_by_name():
    m = Manifest()
    assert m.data["paths"] == ["perfbench"]
    for cfg in m.data["configs"]:
        assert cfg["file"].startswith("perfbench/configs/")
        assert m.config(cfg["name"])["name"] == cfg["name"]
        assert m.config(cfg["name"])["reduced"] == cfg["reduced"]
    for cell in m.data["workloads"]:
        traffic = m.traffic(cell["traffic"])
        assert os.path.exists(os.path.join(m.root, "perfbench", "drivers", f"{traffic['driver']}.py"))
        assert m.check(cell["name"])["numbers"]
        e2e = [x["name"] for x in m.end_to_end(cell["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = m.per_layer(cell["name"])
        assert layer
        for metric in layer:
            assert callable(m.reader(metric["name"]).read)
            assert metric["moves"] in e2e


def test_every_metric_reader_exists():
    m = Manifest()
    files = {f[:-3] for f in os.listdir(os.path.join(m.root, "perfbench", "metrics")) if f.endswith(".py")}
    assert {x["name"] for x in m.data["per_layer"] + tiny.SERVE_PER_LAYER} == files


def test_cell_added_as_files_changes_no_file(tiny_root):
    before, after = tiny.digests(tiny.REPO), tiny.digests(tiny_root)
    for path, digest in before.items():
        if path != "BENCHMARK.json" and not path.startswith("perfbench/tests/"):
            assert after[path] == digest, path
    with open(os.path.join(tiny.REPO, "BENCHMARK.json")) as f:
        old = json.load(f)
    with open(os.path.join(tiny_root, "BENCHMARK.json")) as f:
        new = json.load(f)
    for key in ("configs", "workloads"):
        assert new[key][:len(old[key])] == old[key]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", ["tiny_train", "tiny_serve"])
def test_added_cell_runs_its_cpu_dry_path(tiny_root, cell, trace):
    result = run.execute(["--workload", cell, "--seed", str(2**33 + 17), "--seconds", "1.5", "--trace", str(trace)],
                         root=tiny_root, require_card=False)
    assert list(result)[:5] == RESULT_KEYS and list(result)[-1] == "checks"
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    m = Manifest(tiny_root)
    if trace:
        # on the CPU only the host-clock and counter metrics have something to read
        assert set(result["metrics"]) <= {x["name"] for x in m.per_layer(cell)}
        assert result["metrics"] and "breakdown" in result
    else:
        assert set(result["metrics"]) == {x["name"] for x in m.end_to_end(cell)}
        assert all(v["value"] > 0 for v in result["metrics"].values())
