"""decode_ms_per_step: the median device ms of the span
`model.decode_step` (models/generation.py: the next token's embedding and
one decode step, llama.decode_step_split here), between its CUDA events;
spans on, profiler off (benchlib.spans). Moves queries_per_s."""

from benchlib.spans import median_of


def read(run):
    return median_of(run, "model.decode_step", "device_ms")
