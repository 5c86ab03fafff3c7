"""prefill_ms_per_query: device ms a query in the span `model.prefill`
(models/generation.py: llama.prefill_kv or prefill_shared_prefix over the
chunk's rows and positions), between its CUDA events, summed over the
query's chunks; spans on, profiler off (benchlib.spans). Moves
queries_per_s."""

from benchlib.spans import per_query


def read(run):
    return per_query(run, ("model.prefill",), "device_ms")
