"""The program's spans (revisionllm_tpu_torch/utils/spans.py), for the
per-layer metrics that read them: after the profiled queries, the mix's
trace_queries further queries of the stream with the spans on and the
profiler off, once a run (cached in it). Nothing on the CPU, and nothing
where the program has no spans. On standard error: the median latency of
these queries beside the window's (what the spans cost), and per query its
latency, its root span's host ms and the device ms of its adapter, prefill
and decode-step spans."""

from __future__ import annotations

import statistics
import sys
from typing import Dict, List, Optional

DEVICE_PARTS = ("model.adapter", "model.prefill", "model.decode_step")


def traced(run) -> Optional[Dict]:
    """{"queries": the driver's records of the queries, "records": the
    spans' records}, or None."""
    if "spans" not in run:
        run["spans"] = _read(run)
    return run["spans"]


def _read(run):
    driver = run["driver"]
    if driver.device.type != "cuda":
        return None
    try:
        from revisionllm_tpu_torch.utils import spans as S
    except ImportError:
        return None
    n = run["cell"]["traffic"]["trace_queries"]
    S.reset()
    with S.enabled():
        queries = driver.traced(n)
    recs = S.records()
    S.reset()
    on = statistics.median(q["latency_s"] for q in queries) * 1e3
    off = statistics.median(r["latency_s"] for r in run["records"]) * 1e3
    say = ["# spans: %d queries on, median latency %.2f ms; the window's %.2f ms" % (n, on, off)]
    for q, root in zip(queries, roots(recs)):
        mine = [r for r in recs if r["request"] == root["request"] and r["name"] in DEVICE_PARTS]
        dev = sum(r["device_ms"] or 0.0 for r in mine)
        say.append("# spans: latency %.2f ms, root host %.2f ms, adapter + prefill + decode "
                   "steps on the device %.2f ms" % (q["latency_s"] * 1e3, root["host_ms"], dev))
    print("\n".join(say), file=sys.stderr, flush=True)
    return {"queries": queries, "records": recs}


def roots(recs: List[Dict]) -> List[Dict]:
    """The requests' root spans, in the order they started."""
    return sorted((r for r in recs if r["parent"] is None), key=lambda r: r["start_ns"])


def per_query(run, names, key: str) -> Optional[float]:
    """The sum of `key` ("host_ms" or "device_ms") over the spans named
    among `names`, over the number of queries."""
    got = traced(run)
    if not got:
        return None
    vals = [r[key] for r in got["records"] if r["name"] in names]
    n = len(roots(got["records"]))
    if not vals or not n or any(v is None for v in vals):
        return None
    return sum(vals) / n


def median_of(run, name: str, key: str) -> Optional[float]:
    """The median of `key` over the spans named `name`."""
    got = traced(run)
    if not got:
        return None
    vals = [r[key] for r in got["records"] if r["name"] == name]
    if not vals or any(v is None for v in vals):
        return None
    return statistics.median(vals)
