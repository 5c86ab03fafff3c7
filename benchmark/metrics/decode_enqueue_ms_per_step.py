"""decode_enqueue_ms_per_step: the median host ms of the span
`model.decode_step` (models/generation.py): how long the host takes to
enqueue one decode step. At or above decode_ms_per_step, the host paces
the steps. Spans on, profiler off (benchlib.spans). Moves queries_per_s."""

from benchlib.spans import median_of


def read(run):
    return median_of(run, "model.decode_step", "host_ms")
