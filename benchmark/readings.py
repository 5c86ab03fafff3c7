"""The readings that a cell's correctness limits are set from, on the chip:

    python3 benchmark/readings.py --workload <name> --seeds 1,2,... \
        [--control-seeds 7,8,9] [--queries 4] [--out FILE]

For each seed it builds the program's int8 weights (for a control seed the
program's int4 path, the precision below the configuration's int8: the
control) at the cell's own size, serves --queries queries of the cell's
traffic, and judges them as a run does (the plain reference over a
sample of two queries, the longest among them). One JSON
line a seed on standard output, and in --out when given. The benchmark's
runs never run this."""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parent), str(Path(__file__).resolve().parents[1])]

import run as R  # noqa: E402


def readings(cell, seeds, fmt, n_queries, device, out=None):
    from benchlib.cell import module

    rows = []
    for seed in seeds:
        t0 = time.perf_counter()
        drv = module("drivers", cell["traffic"]["driver"]).Driver(cell, seed, device, fmt=fmt)
        drv.setup(warm=False)
        recs = [drv.query(next(drv.stream)) for _ in range(n_queries)]
        nums = drv.check(recs, seed)
        row = {"workload": cell["workload"]["name"], "fmt": fmt, "seed": seed,
               "seconds": round(time.perf_counter() - t0, 3), **nums}
        print(json.dumps(row), flush=True)
        if out:
            with open(out, "a") as f:
                f.write(json.dumps(row) + "\n")
        rows.append(row)
    return rows


def main(argv=None):
    R.prepare_environment()
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--queries", type=int, default=4)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from benchlib.cell import cell as find_cell

    cell = find_cell(args.workload)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    cseeds = [int(s) for s in args.control_seeds.split(",") if s]
    readings(cell, seeds, "int8", args.queries, "cuda", args.out)
    readings(cell, cseeds, "int4", args.queries, "cuda", args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
