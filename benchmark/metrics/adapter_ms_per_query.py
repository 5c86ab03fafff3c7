"""adapter_ms_per_query: device ms a query in the span `model.adapter`
(models/revisionllm.py encode_video: the ClipEncoder adapter over a chunk's
windows), between its CUDA events, summed over the query's chunks; spans
on, profiler off (benchlib.spans). Moves queries_per_s."""

from benchlib.spans import per_query


def read(run):
    return per_query(run, ("model.adapter",), "device_ms")
