"""mla_ms_per_query: device ms a query in the spans `model.mla` (models/
llama.py: each layer's latent attention, decompressed in the prefill and
absorbed in every decode step), between their CUDA events, summed over the
query; spans on, profiler off (benchlib.spans). Moves queries_per_s."""

from benchlib.spans import per_query


def read(run):
    return per_query(run, ("model.mla",), "device_ms")
