"""launches_per_query: kernel launches on the device per traced query, from
the profiler's device events (PyTorch's, the libraries' and the port's;
copies and memsets are not launches). Moves queries_per_s."""

from benchlib.trace import is_kernel


def read(run):
    tr = run["trace"]
    if not tr or not tr["records"] or not tr["ops"]:
        return None
    return sum(is_kernel(o) for o in tr["ops"]) / len(tr["records"])
