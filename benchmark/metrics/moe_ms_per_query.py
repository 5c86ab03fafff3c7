"""moe_ms_per_query: device ms a query in the spans `model.moe` (models/
llama.py: each DeepSeekMoE layer's router, dispatch, grouped expert
products, combine and shared experts, in the prefill and every decode
step), between their CUDA events, summed over the query; spans on,
profiler off (benchlib.spans). Moves queries_per_s."""

from benchlib.spans import per_query


def read(run):
    return per_query(run, ("model.moe",), "device_ms")
