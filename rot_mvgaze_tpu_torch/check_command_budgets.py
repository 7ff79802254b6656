"""Wall-clock budgets of the port's three benchmark commands (port of
``scripts/check_driver_artifacts.py``).

Each command runs as a fresh subprocess from the repository root, with the
environment it is meant to run in, under an explicit budget; the check
fails when one exits non-zero, overruns its budget or prints something
other than its contract. The commands:

1. ``bench`` at its smoke settings (``BENCH_BATCH=2``, ``BENCH_SIZE=64``,
   ``BENCH_DEPTH=18``): one JSON line with ``metric``, ``value`` > 0,
   ``unit``, ``device`` and ``flops_per_step``;
2. the forward check: ``dryrun.entry()`` and one call of its forward;
3. the dry run: ``dryrun.dryrun_multichip(8)`` at its default configuration.

Budgets are per device, 2-3x the longest of the seconds measured from a
cold process (``python`` start, imports, the card's context and the
command):

- CPU (8 cores, no card; two runs): bench 14.4-22.1 s, entry 7.8-18.0 s,
  dry run 9.3-10.5 s;
- NVIDIA H100 80GB HBM3 at 700 W (the kernels already built): bench
  30.6 s, entry 24.6 s, dry run 34.6 s.

::

    python -m rot_mvgaze_tpu_torch.check_command_budgets [--only bench|entry|dryrun] [--device cpu]

Prints a line per command and one JSON summary; exits 1 when any check
fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Callable, List, Optional, Sequence, Tuple

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: seconds per command and device: 2-3x the readings of the module docstring
BUDGETS = {
    "cpu": {"bench": 60.0, "entry": 45.0, "dryrun": 30.0},
    "cuda": {"bench": 75.0, "entry": 60.0, "dryrun": 90.0},
}


def validate_bench(out: str) -> Optional[str]:
    """The last JSON line of ``bench``: one object with the record's keys and
    a positive value."""
    lines = [line for line in out.strip().splitlines() if line.startswith("{")]
    if not lines:
        return "no JSON line in bench output"
    try:
        rec = json.loads(lines[-1])
    except json.JSONDecodeError as e:
        return f"bench JSON unparsable: {e}"
    missing = {"metric", "value", "unit", "device", "flops_per_step"} - set(rec)
    if missing:
        return f"bench JSON missing keys: {sorted(missing)}"
    if not (isinstance(rec["value"], (int, float)) and rec["value"] > 0):
        return f"bench value not a positive number: {rec['value']!r}"
    return None


def validate_entry(out: str) -> Optional[str]:
    return None if "entry OK (8, 2) torch.float32" in out else "missing 'entry OK (8, 2) torch.float32' line"


def validate_dryrun(out: str) -> Optional[str]:
    return None if "dryrun_multichip(8) OK" in out else "missing 'dryrun_multichip(8) OK' line"


#: (name, extra environment, argv after the interpreter, validator)
Check = Tuple[str, float, dict, List[str], Callable[[str], Optional[str]]]


def checks(device: str) -> List[Check]:
    """The three commands on ``device`` (``cuda`` or ``cpu``), with their
    budgets."""
    budget = BUDGETS["cpu" if device == "cpu" else "cuda"]
    py = sys.executable
    return [
        ("bench", budget["bench"], {"BENCH_BATCH": "2", "BENCH_SIZE": "64", "BENCH_DEPTH": "18"},
         [py, "-m", "rot_mvgaze_tpu_torch.bench", "--device", device], validate_bench),
        ("entry", budget["entry"], {},
         [py, "-c", "from rot_mvgaze_tpu_torch import dryrun\n"
                    f"fn, args = dryrun.entry(device={device!r})\n"
                    "out = fn(*args)\n"
                    "print('entry OK', tuple(out.shape), out.dtype, flush=True)"], validate_entry),
        ("dryrun", budget["dryrun"], {},
         [py, "-c", "from rot_mvgaze_tpu_torch.dryrun import dryrun_multichip\n"
                    f"dryrun_multichip(8, device={device!r})"], validate_dryrun),
    ]


def run_check(name: str, budget: float, extra_env: dict, argv: Sequence[str],
              validate: Optional[Callable[[str], Optional[str]]] = None, grace: float = 60.0) -> tuple:
    """Run one command; ``(ok, seconds, tail)``. The command has ``budget +
    grace`` seconds before it is killed, so a slow but live run still
    reports its time; the ``BENCH_*`` settings of this process are not
    passed on."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env.update(extra_env)
    t0 = time.monotonic()
    try:
        proc = subprocess.run(list(argv), cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, timeout=budget + grace, text=True)
        out, rc = proc.stdout, proc.returncode
    except subprocess.TimeoutExpired as e:
        raw = e.stdout or b""
        out = raw.decode("utf-8", "replace") if isinstance(raw, bytes) else raw
        rc = -9
    elapsed = time.monotonic() - t0
    tail = "\n".join((out or "").strip().splitlines()[-6:])
    contract = validate(out or "") if rc == 0 and validate is not None else None
    ok = rc == 0 and elapsed <= budget and contract is None
    print(f"[{'OK' if ok else 'FAIL'}] {name}: rc={rc} elapsed={elapsed:.1f}s budget={budget:.0f}s"
          + (f" contract={contract}" if contract else ""), flush=True)
    if not ok:
        print(f"--- tail ---\n{tail}\n------------", flush=True)
    return ok, elapsed, tail


def run_checks(todo: Sequence[Check], device: str) -> dict:
    """Run each check of ``todo`` in turn; the summary, ``ok`` when every
    one passed."""
    from rot_mvgaze_tpu_torch.utils.drivers import card_of

    results = [run_check(*c) for c in todo]
    return {"ok": all(r[0] for r in results), "device": card_of(device),
            "checks": [{"name": c[0], "budget_s": c[1], "ok": r[0], "elapsed_s": r[1]}
                       for c, r in zip(todo, results)]}


def main(argv: Optional[list] = None) -> int:
    """Run the checks; 0 when every one passed, else 1."""
    from rot_mvgaze_tpu_torch.utils.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default=None, help="one of bench, entry, dryrun")
    ap.add_argument("--device", default="cuda", help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    todo = [c for c in checks(args.device) if args.only is None or args.only == c[0]]
    if not todo:
        print(f"no check named {args.only!r}", file=sys.stderr)
        return 2
    summary = run_checks(todo, args.device)
    print(json.dumps(summary), flush=True)
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
