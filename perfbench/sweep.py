"""A load sweep of a serving cell in one process (not run by the
benchmark's runs): the cell's mix with some keys changed, one short window
each, to find the load the system sustains and how steady it is there.

    python3 -m perfbench.sweep --workload <cell> --seconds 6 --repeat 2 \\
        --grid '[{"clients": 64, "frames_per_request": 1}, {"clients": 8, "frames_per_request": 8}]'

One JSON line per run: the changed keys, the end-to-end metrics, the
compared numbers and the frames per micro-batch.
"""

from __future__ import annotations

import argparse
import json
import sys

from perfbench import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--grid", required=True)
    ap.add_argument("--seconds", default="6")
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--seed", type=int, default=20261018)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    out = open(args.out, "a") if args.out else None
    for k in range(args.repeat):
        for i, update in enumerate(json.loads(args.grid)):
            seed = args.seed + 100 * k + i
            for trace in (0, 1):
                r = run.execute(["--workload", args.workload, "--seed", str(seed), "--seconds", args.seconds,
                                 "--trace", str(trace)], traffic_update=update)
                line = json.dumps({"update": update, "seed": seed, "trace": trace, "metrics": r["metrics"],
                                   "numbers": r["numbers"], "attempted": r["attempted"]})
                print(line, flush=True)
                if out:
                    out.write(line + "\n")
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
