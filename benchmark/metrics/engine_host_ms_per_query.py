"""engine_host_ms_per_query: host ms a query in the spans `engine.plan`
(eval/engine.py: the window plan, prompt ids, splice plan, the movie and
query features to the device) and `engine.finalize` (the scoring tail),
summed; the host's wait on the device is device_lag_ms_per_query's. Spans
on, profiler off (benchlib.spans). Moves query_ms_p95."""

from benchlib.spans import per_query


def read(run):
    return per_query(run, ("engine.plan", "engine.finalize"), "host_ms")
