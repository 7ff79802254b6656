"""The readings that a cell's limits are set from, on the card, in one
process (not run by the benchmark's runs):

    python3 -m perfbench.calibrate --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 --seconds 2 [--out build/calibrate_<cell>.jsonl]

For each of ``--seeds``, a sound run of the cell (a short window), whose
numbers give the lower readings. For each of ``--control-seeds``, the
control and the planted faults: a training cell's control is the
reference with float8 (or int8) products in the system's place
(``drivers.train.control_numbers``) and its faults
``perfbench.faults.TRAIN`` (``unchanged`` reads 1 by construction and is
not run); a serving cell's control is the system's own int8 path and its
faults ``perfbench.faults.SERVE``. One JSON line per run, to standard
output and ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from perfbench import faults, run
from perfbench.drivers import train
from perfbench.manifest import Manifest


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--precisions", default="fp8", help="training controls: fp8, int8 or both")
    ap.add_argument("--faults", default=None,
                    help="faults run at the control seeds (default: half_batch for training, every serving fault)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    manifest = Manifest()
    cell = manifest.cell(args.workload)
    traffic = manifest.traffic(cell["traffic"])
    serving = traffic["driver"] == "serve"
    planted = faults.SERVE if serving else faults.TRAIN
    fault_names = (args.faults if args.faults is not None
                   else ",".join(sorted(faults.SERVE)) if serving else "half_batch").split(",")
    out = open(args.out, "a") if args.out else None

    def emit(kind, seed, line):
        line = dict(kind=kind, seed=seed, **line)
        text = json.dumps(line)
        print(text, flush=True)
        if out:
            out.write(text + "\n")
            out.flush()

    def once(seed, **kw):
        argv_ = ["--workload", args.workload, "--seed", str(seed), "--seconds", str(args.seconds)]
        t = time.perf_counter()
        r = run.execute(argv_, **kw)
        return {"correct": r["correct"], "numbers": r["numbers"], "metrics": r["metrics"],
                "attempted": r["attempted"], "failed": r["failed"], "seconds": time.perf_counter() - t}

    for seed in [int(s) for s in args.seeds.split(",") if s]:
        emit("program", seed, once(seed))
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        if serving:
            emit("control_int8", seed, once(seed, traffic_update={"int8": True}))
        else:
            for precision in args.precisions.split(","):
                t = time.perf_counter()
                numbers = train.control_numbers(manifest.config(cell["config"]), traffic, seed,
                                                torch.device("cuda", 0), precision)
                emit(f"control_{precision}", seed, {"numbers": numbers, "seconds": time.perf_counter() - t})
        for name in fault_names:
            if name:
                emit(f"fault_{name}", seed, once(seed, plant=planted[name]))
        torch.cuda.empty_cache()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
