"""w8a8_roofline: the W8A8 prefill GEMMs (ops/quant.py `_int8_dot`,
torch._int_mm): the least time their shapes need (benchlib.roofline.
w8a8_bound_s) over their summed device time in the traced queries, in %.
Nothing is read unless the profiler shows exactly the calls those shapes
count. Moves queries_per_s."""

from benchlib.roofline import w8a8_bound_s, w8a8_calls
from benchlib.trace import W8A8


def read(run):
    tr = run["trace"]
    if not tr or not tr["records"]:
        return None
    ms, calls = tr["groups"][W8A8]
    dims = run["cell"]["dims"]
    if not ms or calls != w8a8_calls(dims) * len(tr["records"]):
        return None
    bound = sum(w8a8_bound_s(dims, r["rows"], r["T"]) for r in tr["records"])
    return 100.0 * bound / (ms / 1e3)
