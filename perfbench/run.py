"""Runs one benchmark cell once and prints its result line.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell's entry in ``BENCHMARK.json`` names
its configuration and traffic mix; the mix names the driver that runs it
(``perfbench/drivers/``). The run loads, warms up, measures for
``--seconds``, checks what the measured path produced against the plain
reference, and prints one JSON line last on standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number with its limit,
which are also the last lines on standard error. Without a card (or with
fewer than the cell asks for) it exits 2 and prints no result; if JAX or
the JAX package is loaded when the window has closed it exits 3.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib
import json
import math
import os
import sys
import time
from typing import Any, Callable, Dict, Iterator, Optional

T_IMPORT = time.perf_counter()

FORBIDDEN = {"jax", "jaxlib", "flax", "rot_mvgaze_tpu"}


def process_age() -> float:
    """Seconds since this process started (``/proc``; 0 where unreadable)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


AGE_AT_IMPORT = process_age()


def set_cache_dirs(root: str) -> None:
    """Every build and kernel cache the process may use, at fixed paths
    inside the checkout (the port builds its kernels under ``build/``)."""
    base = os.path.join(root, "build", "perfbench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(base, sub)


class Run:
    """What a driver is handed: the cell's pieces, the seed and window, the
    device, the spans, and the window's bracket."""

    def __init__(self, config, traffic, seed, seconds, trace, device, plant=None) -> None:
        from perfbench.tracing import DeviceTrace, Spans

        self.config, self.traffic, self.seed, self.seconds = config, traffic, seed, seconds
        self.device, self.plant = device, plant
        self.spans = Spans(annotate=trace)
        self.device_trace = DeviceTrace(device) if trace else None
        self.setup_s: Optional[float] = None
        self.marks: Dict[str, float] = {}

    def log(self, text: str) -> None:
        print(f"perfbench: {text}", file=sys.stderr, flush=True)

    def mark(self, name: str) -> None:
        """Notes the seconds since the process started at the end of a
        phase of set-up or of the check (the device's work of the phase
        included), reported on standard error."""
        self.sync()
        self.marks[name] = AGE_AT_IMPORT + time.perf_counter() - T_IMPORT

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self):
        return self.device_trace.window_of() if self.device_trace else contextlib.nullcontext()

    def window_start(self) -> float:
        """Marks the first timed operation; returns the host clock."""
        t = time.perf_counter()
        self.setup_s = AGE_AT_IMPORT + (t - T_IMPORT)
        self.marks["window_start"] = self.setup_s
        return t

    def memory_peak(self) -> int:
        import torch

        return int(torch.cuda.max_memory_allocated(self.device)) if self.device.type == "cuda" else 0

    def free(self) -> None:
        """After the window: return the system's memory before the
        reference runs."""
        import torch

        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def card(device) -> Dict[str, Any]:
    import subprocess

    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1}
    try:
        line = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
                               "-i", str(device.index or 0)], capture_output=True, text=True, timeout=20,
                              check=True).stdout.strip()
        out["power_limit"] = line.splitlines()[0].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        out["power_limit"] = None
    return out


def get_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap


def execute(argv: Optional[list] = None, root: Optional[str] = None, require_card: bool = True,
            plant: Optional[Callable] = None, traffic_update: Optional[Dict[str, Any]] = None
            ) -> Optional[Dict[str, Any]]:
    """One run; returns the result (None, having said why on standard error,
    where the card is missing). ``require_card=False`` runs the CPU dry
    path of the tests; ``plant`` (``perfbench.faults``) breaks the timed
    path and ``traffic_update`` changes the mix, for the tests and
    ``perfbench.calibrate`` only."""
    from perfbench.manifest import ROOT, Manifest

    args = get_parser().parse_args(argv)
    set_cache_dirs(root or ROOT)
    manifest = Manifest(root)
    cell = manifest.cell(args.workload)
    import torch

    if require_card:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            print(f"perfbench: the cell needs {cell['chips']} card(s); "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible", file=sys.stderr)
            return None
        device = torch.device("cuda", 0)
    else:
        device = torch.device("cpu")
    config = manifest.config(cell["config"])
    traffic = dict(manifest.traffic(cell["traffic"]), **(traffic_update or {}))
    limits = manifest.check(cell["name"])["numbers"]
    ctx = Run(config, traffic, args.seed, args.seconds, bool(args.trace), device, plant)
    ctx.mark("imports")
    driver = importlib.import_module(f"perfbench.drivers.{traffic['driver']}")
    out = driver.run(ctx)
    ctx.mark("end")
    print("perfbench: phases (s since start): " + ", ".join(f"{k} {v:.2f}" for k, v in ctx.marks.items()),
          file=sys.stderr)

    from perfbench.compare import judge

    correct, checks = judge(out["numbers"], limits, out["failed"])
    dev = card(device)
    dev["memory_peak_bytes"] = out["memory_peak_bytes"]
    result: Dict[str, Any] = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"]}
    if args.trace:
        summary = ctx.device_trace.summary(ctx.spans)
        dev["busy_s"], dev["window_s"] = summary["busy_s"], summary["window_s"]
        record = dict(out["record"], spans=ctx.spans, trace=summary, config=config, traffic=traffic,
                      device_name=dev["kind"])
        metrics = {}
        for m in manifest.per_layer(cell["name"]):
            value = manifest.reader(m["name"]).read(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result.update(metrics=metrics, device=dev, breakdown=summary["breakdown"])
    else:
        values = dict(out["e2e"], setup_s=ctx.setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in manifest.end_to_end(cell["name"])}
        result.update(metrics=metrics, device=dev)
    result["numbers"] = out["numbers"]  # every number worked out, compared or not
    result["checks"] = checks
    return result


def loaded_forbidden() -> set:
    return {name.split(".")[0] for name in list(sys.modules)} & FORBIDDEN


def main(argv: Optional[list] = None) -> int:
    result = execute(argv)
    if result is None:
        return 2
    bad = loaded_forbidden()
    if bad:
        print(f"perfbench: loaded in the measuring process: {sorted(bad)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result, allow_nan=True), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
