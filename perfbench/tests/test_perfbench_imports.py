"""The harness and its readers load nothing of JAX or the JAX package, and
the reference loads nothing of the system under test."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

from perfbench.tests import tiny

FORBIDDEN = {"jax", "jaxlib", "flax", "rot_mvgaze_tpu"}


def _loaded_after(code: str) -> set:
    probe = code + "\nimport sys\nprint(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"
    done = subprocess.run([sys.executable, "-c", probe], cwd=tiny.REPO, capture_output=True, text=True, timeout=300,
                          check=True)
    return set(done.stdout.split())


def test_harness_mixes_and_metrics_load_no_jax():
    code = "\n".join([
        "import perfbench.run, perfbench.calibrate, perfbench.faults",
        "import perfbench.drivers.train, perfbench.drivers.serve",
        "from perfbench.manifest import Manifest",
        "m = Manifest()",
        "[m.reader(x['name']) for x in m.data['per_layer']]",
        "[m.traffic(c['traffic']) for c in m.data['workloads']]",
    ])
    assert not _loaded_after(code) & FORBIDDEN


def test_reference_loads_nothing_of_the_system():
    loaded = _loaded_after("import perfbench.reference.model, perfbench.reference.ops, perfbench.reference.train")
    assert not loaded & (FORBIDDEN | {"rot_mvgaze_tpu_torch"})


def test_reference_sources_import_torch_numpy_and_itself_only():
    allowed = {"torch", "numpy", "perfbench", "__future__", "contextlib", "math", "typing"}
    folder = os.path.join(tiny.REPO, "perfbench", "reference")
    for name in os.listdir(folder):
        if name.endswith(".py"):
            with open(os.path.join(folder, name)) as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    tops = {a.name.split(".")[0] for a in node.names}
                elif isinstance(node, ast.ImportFrom):
                    tops = {(node.module or "").split(".")[0]}
                    if node.module and node.module.startswith("perfbench"):
                        assert node.module.startswith("perfbench.reference"), (name, node.module)
                else:
                    continue
                assert tops <= allowed, (name, tops)


def test_a_dry_run_leaves_no_jax_loaded(tiny_root):
    code = ("from perfbench import run\n"
            f"r = run.execute(['--workload', 'tiny_serve', '--seed', '3', '--seconds', '0.2'], root={tiny_root!r}, "
            "require_card=False)\nassert r is not None")
    assert not _loaded_after(code) & FORBIDDEN
