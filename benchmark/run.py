"""The benchmark of the PyTorch and CUDA port (revisionllm_tpu_torch) on
one or more NVIDIA H100s.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout. The workload's configuration, traffic mix,
per-layer metrics and limits are files under benchmark/ found by name
(benchlib/cell.py). The last line of standard output is one JSON object:
correct, attempted, failed, metrics (the end-to-end ones, or with --trace 1
the per-layer ones), device, with --trace 1 a breakdown, and last the
checks that decided `correct`, each number beside its limit; the same
checks are the last lines of standard error."""

from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import os  # noqa: E402

# one process, few threads: the host's other work stays out of the timed path
for _k in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_k] = "1"

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "revisionllm_tpu")
TRACE_WINDOW = "benchmark.trace_window"


def prepare_environment():
    """Every build and kernel cache inside the checkout at a fixed path;
    the program's switches only as the configuration states them; no
    library loading JAX by itself."""
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for k in [k for k in os.environ if k.startswith("REVISIONLLM_")]:
        del os.environ[k]
    for p in (str(HERE), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def forbidden_modules(names) -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole: revisionllm_tpu_torch passes."""
    return sorted({n for n in names if n.split(".")[0] in FORBIDDEN})


def say(msg: str):
    print(f"# {msg}", file=sys.stderr, flush=True)


def power_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def read_trace(driver, run, n):
    """Profile `n` queries after the window; fills run["trace"]."""
    import torch
    from benchlib import trace as TRC

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(TRACE_WINDOW):
            traced = driver.traced(n)
            driver.sync()
    t0 = time.perf_counter()
    ops, cpu, win = TRC.read_profile(prof, TRACE_WINDOW)
    del prof
    lo, hi = win
    ops = [o for o in ops if o.end > lo and o.start < hi]
    busy = TRC.busy_intervals(ops, lo, hi)
    gaps = TRC.idle_gaps(busy, lo, hi)
    run["trace"] = {"records": traced, "ops": ops, "groups": TRC.group_kernels(ops),
                    "busy_s": sum(e - s for s, e in busy) / 1e6, "window_s": (hi - lo) / 1e6,
                    "gaps": gaps, "host": TRC.host_activity(cpu, gaps)}
    say(f"trace: {n} queries, {len(ops)} device operations, read in "
        f"{time.perf_counter() - t0:.1f} s")


def breakdown(tr):
    by_name = {}
    for o in tr["ops"]:
        by_name[o.name] = by_name.get(o.name, 0.0) + o.ms / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    host = sorted(tr["host"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:160], s] for n, s in top],
            "idle_gaps": [[n[:160], s] for n, s in host]}


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             cell=None):
    """One run of a cell; returns the result object (without printing).
    `cell` replaces the one BENCHMARK.json names (the tests' small cells)."""
    import numpy as np
    import torch
    from benchlib.cell import cell as find_cell
    from benchlib.cell import module

    cell = cell or find_cell(workload)
    driver_mod = module("drivers", cell["traffic"]["driver"])
    driver = driver_mod.Driver(cell, seed, device)
    driver.setup()
    # the set-up's objects leave the collector's generations, so that no
    # collection inside the window walks them
    gc.collect()
    gc.freeze()
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - PROCESS_START
    records, window_s = driver.window(seconds)
    run = {"cell": cell, "driver": driver, "records": records, "window_s": window_s,
           "trace": None}
    say(f"window: {len(records)} queries in {window_s:.3f} s; setup {setup_s:.3f} s")
    if trace:
        read_trace(driver, run, cell["traffic"]["trace_queries"])
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    metrics = {}
    if trace:
        for m in cell["per_layer"]:
            v = module("metrics", m["name"]).read(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        e2e = driver.end_to_end(records, window_s)
        e2e["setup_s"] = setup_s
        for m in cell["end_to_end"]:
            metrics[m["name"]] = {"value": float(e2e[m["name"]]), "unit": m["unit"]}
    lat = [r["latency_s"] for r in records]
    say("latencies ms: " + " ".join(f"{x * 1e3:.1f}" for x in lat))
    say(f"latency ms: median {np.median(lat) * 1e3:.2f}, p95 {np.percentile(lat, 95) * 1e3:.2f} "
        f"over {len(lat)} queries")
    gc.unfreeze()
    numbers = driver.check(records, seed)
    limits = cell["limits"]
    checks = {}
    for name, value in numbers.items():
        if name in limits:
            checks[name] = {"value": value, "limit": limits[name]}
        else:
            say(f"reading {name} {value!r}")
    correct = bool(checks) and all(c["value"] <= c["limit"] for c in checks.values()) \
        and set(checks) == set(limits)
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
           "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        dev["busy_s"] = run["trace"]["busy_s"]
        dev["window_s"] = run["trace"]["window_s"]
    out = {"correct": correct, "attempted": len(records),
           "failed": int(sum(driver.malformed(r) for r in records)), "metrics": metrics,
           "device": dev}
    if trace:
        out["breakdown"] = breakdown(run["trace"])
    out["checks"] = checks
    return out


def main(argv=None):
    prepare_environment()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from benchlib.cell import benchmark_spec

    spec = benchmark_spec()
    chips = next((w["chips"] for w in spec["workloads"] if w["name"] == args.workload), None)
    if chips is None:
        say(f"no workload named {args.workload!r}")
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        say(f"needs {chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    torch.set_num_threads(1)
    say(f"card: {power_limit()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules(list(sys.modules))
    if bad:
        say(f"modules that must not load: {bad}")
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
