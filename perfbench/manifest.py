"""Finds a cell's pieces by the names in ``BENCHMARK.json``.

A configuration is the file its entry names; a traffic mix is
``perfbench/traffic/<traffic>.json``, whose ``driver`` names the general
driver in ``perfbench/drivers/`` that reads it; a cell's comparison limits
are ``perfbench/checks/<cell>.json``; a per-layer metric is the reader
``perfbench/metrics/<metric>.py``. Adding a cell, a mix or a metric adds
files and entries and edits none.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
from types import ModuleType
from typing import Any, Dict, List, Optional

import numpy as np

PACKAGE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PACKAGE)


class Manifest:
    def __init__(self, root: Optional[str] = None) -> None:
        self.root = root or ROOT
        with open(os.path.join(self.root, "BENCHMARK.json")) as f:
            self.data = json.load(f)

    def _json(self, *parts: str) -> Dict[str, Any]:
        with open(os.path.join(self.root, *parts)) as f:
            return json.load(f)

    def cell(self, name: str) -> Dict[str, Any]:
        for c in self.data["workloads"]:
            if c["name"] == name:
                return c
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")

    def config(self, name: str) -> Dict[str, Any]:
        for c in self.data["configs"]:
            if c["name"] == name:
                return self._json(c["file"])
        raise KeyError(f"no configuration named {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> Dict[str, Any]:
        return self._json("perfbench", "traffic", f"{name}.json")

    def check(self, cell: str) -> Dict[str, Any]:
        return self._json("perfbench", "checks", f"{cell}.json")

    def end_to_end(self, cell: str) -> List[Dict[str, Any]]:
        """The end-to-end metrics the cell reports."""
        return [m for m in self.data["end_to_end"] if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> List[Dict[str, Any]]:
        """The per-layer metrics the cell reports: those that list it, and
        those without a list whose end-to-end metric it reports."""
        reported = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.data["per_layer"]
                if (cell in m["workloads"] if "workloads" in m else m["moves"] in reported)]

    def reader(self, metric: str) -> ModuleType:
        """The module of ``perfbench/metrics/<metric>.py`` (names hold dots,
        so it is loaded by path)."""
        path = os.path.join(self.root, "perfbench", "metrics", f"{metric}.py")
        spec = importlib.util.spec_from_file_location("perfbench_metric_" + metric.replace(".", "_"), path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use (``tag``) of the run's ``--seed``: the
    first word of ``SeedSequence([seed mod 2^64, hash of tag])``."""
    word = int.from_bytes(hashlib.sha256(tag.encode()).digest()[:8], "little")
    state = np.random.SeedSequence([seed % 2**64, word]).generate_state(1, np.uint64)[0]
    return int(state) >> 1
