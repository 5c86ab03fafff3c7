"""device_lag_ms_per_query: host ms a query from the end of its last
`model.decode_step` span to the end of its last `engine.read` span
(eval/engine.py, which holds _decode_answers): how long the host waits on
the device once everything is enqueued, wherever the synchronising copy
sits. The mean over the queries; spans on, profiler off (benchlib.spans).
Moves query_ms_p95."""

from benchlib.spans import roots, traced


def read(run):
    got = traced(run)
    if not got:
        return None
    lags = []
    for root in roots(got["records"]):
        mine = [r for r in got["records"] if r["request"] == root["request"]]
        steps = [r["end_ns"] for r in mine if r["name"] == "model.decode_step"]
        reads = [r["end_ns"] for r in mine if r["name"] == "engine.read"]
        if not steps or not reads:
            return None
        lags.append((max(reads) - max(steps)) / 1e6)
    return sum(lags) / len(lags) if lags else None
