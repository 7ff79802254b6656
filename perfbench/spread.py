"""Sets of runs of one cell and the spread of each metric: what a bound is
set from (not run by the benchmark's runs).

    python3 -m perfbench.spread --workload <cell> --seeds 1,2,3,4,5,6 --sets 2 \\
        --seconds <run_seconds> [--trace-seeds 7,8,9] [--out build/spread_<cell>.jsonl]

Each run is a new process of the benchmark's command, as a check runs it;
every set runs ``--seeds`` in order. A spread is the distance between the
first and the third quartile (``statistics.quantiles(values, n=4)``) over
the median. Prints each run's result line and, per set, each metric's
median and spread; ``--trace-seeds`` adds traced runs after the sets.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from typing import Dict, List


def spread(values: List[float]) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def one_run(workload: str, seed: int, seconds: str, trace: int) -> Dict:
    with open(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "BENCHMARK.json")) as f:
        command = json.load(f)["command"]
    argv = [*command, "--workload", workload, "--seed", str(seed), "--seconds", seconds, "--trace", str(trace)]
    t = time.perf_counter()
    done = subprocess.run(argv, capture_output=True, text=True)
    lines = done.stdout.strip().splitlines()
    result = json.loads(lines[-1]) if done.returncode == 0 and lines else {"error": done.stderr[-3000:]}
    result.update(rc=done.returncode, seed=seed, trace=trace, wall_s=time.perf_counter() - t)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--seconds", required=True)
    ap.add_argument("--trace-seeds", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    out = open(args.out, "a") if args.out else None

    def emit(line: Dict) -> None:
        text = json.dumps(line)
        print(text, flush=True)
        if out:
            out.write(text + "\n")
            out.flush()

    sets = []
    for k in range(args.sets):
        runs = []
        for seed in seeds:
            r = one_run(args.workload, seed, args.seconds, 0)
            r["set"] = k
            emit(r)
            runs.append(r)
        sets.append(runs)
    for k, runs in enumerate(sets):
        ok = [r for r in runs if "metrics" in r]
        names = sorted({m for r in ok for m in r["metrics"]})
        summary = {}
        for name in names:
            values = [r["metrics"][name]["value"] for r in ok if name in r["metrics"]]
            if len(values) >= 2:
                summary[name] = {"median": statistics.median(values), "spread": spread(values), "values": values}
        emit({"set": k, "correct": [r.get("correct") for r in runs], "spreads": summary})
    for seed in [int(s) for s in args.trace_seeds.split(",") if s]:
        emit(one_run(args.workload, seed, args.seconds, 1))
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
