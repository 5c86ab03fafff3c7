"""passes_ms_per_query: device milliseconds per traced query of the
operations in no kernel group (benchlib.trace.OTHER: PyTorch's
elementwise passes, reductions and copies). Moves queries_per_s."""

from benchlib.trace import OTHER


def read(run):
    tr = run["trace"]
    if not tr or not tr["records"] or not tr["ops"]:
        return None
    return tr["groups"][OTHER][0] / len(tr["records"])
