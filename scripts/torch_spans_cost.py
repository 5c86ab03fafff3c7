"""What the spans (revisionllm_tpu_torch/utils/spans.py) cost a benchmark
cell, and their readings over whole windows, on the card:

    python3 scripts/torch_spans_cost.py --workload glm2-6b.ground-1h \
        --seeds 11,12,13 [--seconds 25] [--out spans_cost.jsonl]

For each seed, in one process: the cell's driver set up as a benchmark run
sets it up (benchmark/run.py), then four windows of the same queries (the
query stream restarted for each) with the spans off, on, on, off. One JSON
line a window: its queries_per_s, median latency and peak device memory,
and with the spans on the per-layer metrics that read them
(benchmark/metrics/; DeepSeek-V2's `model.moe` and `model.mla` readers read
nothing on the other cells), over every query of the window, beside the
share of decode steps replayed from CUDA graphs (`model.decode_step`'s
attribute `replayed`)."""

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
           "prefill_useful_pct", "moe_ms_per_query", "mla_ms_per_query")


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
            torch.cuda.reset_peak_memory_stats()
            with spans.enabled(on):
                recs, window_s = driver.window(args.seconds)
            row = {"workload": args.workload, "seed": seed, "spans": on, "card": card,
                   "queries": len(recs), "window_s": window_s,
                   "queries_per_s": len(recs) / window_s,
                   "median_ms": statistics.median(r["latency_s"] for r in recs) * 1e3,
                   "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
            if on:
                got = spans.records()
                run = {"cell": cell, "spans": {"queries": recs, "records": got}}
                row.update({name: module("metrics", name).read(run) for name in READERS})
                steps = [r for r in got if r["name"] == "model.decode_step"]
                row["replayed_share"] = (sum(r["attrs"].get("replayed") == 1 for r in steps)
                                         / len(steps)) if steps else None
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
