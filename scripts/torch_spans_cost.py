"""What the spans (revisionllm_tpu_torch/utils/spans.py) cost a benchmark
cell, and their readings over whole windows, on the card:

    python3 scripts/torch_spans_cost.py --workload glm2-6b.ground-1h \
        --seeds 11,12,13 [--seconds 25] [--out spans_cost.jsonl]

For each seed, in one process: the cell's driver set up as a benchmark run
sets it up (benchmark/run.py), then four windows of the same queries (the
query stream restarted for each) with the spans off, on, on, off. One JSON
line a window: its queries_per_s and median latency, and with the spans on
the seven per-layer metrics that read them (benchmark/metrics/), over every
query of the window."""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "benchmark"), str(ROOT)]

import run as R  # noqa: E402

READERS = ("adapter_ms_per_query", "prefill_ms_per_query", "decode_ms_per_step",
           "decode_enqueue_ms_per_step", "engine_host_ms_per_query", "device_lag_ms_per_query",
           "prefill_useful_pct")


def main(argv=None):
    R.prepare_environment()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=25.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch
    from benchlib import traffic as TR
    from benchlib.cell import cell as find_cell
    from benchlib.cell import module
    from revisionllm_tpu_torch.utils import spans

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    card = R.power_limit()
    cell = find_cell(args.workload)
    for seed in [int(s) for s in args.seeds.split(",")]:
        driver = module("drivers", cell["traffic"]["driver"]).Driver(cell, seed, "cuda")
        driver.setup()
        gc.collect()
        gc.freeze()
        for on in (False, True, True, False):
            driver.stream = TR.queries(cell["traffic"], seed)
            spans.reset()
            with spans.enabled(on):
                recs, window_s = driver.window(args.seconds)
            row = {"workload": args.workload, "seed": seed, "spans": on, "card": card,
                   "queries": len(recs), "window_s": window_s,
                   "queries_per_s": len(recs) / window_s,
                   "median_ms": statistics.median(r["latency_s"] for r in recs) * 1e3}
            if on:
                run = {"cell": cell, "spans": {"queries": recs, "records": spans.records()}}
                row.update({name: module("metrics", name).read(run) for name in READERS})
            spans.reset()
            print(json.dumps(row), flush=True)
            if args.out:
                Path(args.out).parent.mkdir(parents=True, exist_ok=True)
                with open(args.out, "a") as f:
                    f.write(json.dumps(row) + "\n")
        gc.unfreeze()
        driver.release()
    return 0


if __name__ == "__main__":
    sys.exit(main())
