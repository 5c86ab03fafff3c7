"""k1_roofline: K1 (ops/quant.py int8_matmul, q8_matmul_kernel), the decode
steps' weight-only int8 products and the prefill's lm_head: the least time
their shapes need (benchlib.roofline.k1_bound_s, bytes-bound) over K1's
summed device time in the traced queries, in %. Nothing is read unless the
profiler shows exactly the launches those shapes count. Moves
queries_per_s."""

from benchlib.roofline import k1_bound_s, k1_calls
from benchlib.trace import K1


def read(run):
    tr = run["trace"]
    if not tr or not tr["records"]:
        return None
    ms, calls = tr["groups"][K1]
    dims = run["cell"]["dims"]
    steps = run["cell"]["traffic"]["eval"]["max_new_tokens"] - 1
    if not ms or calls != k1_calls(dims, steps) * len(tr["records"]):
        return None
    bound = sum(k1_bound_s(dims, r["rows"], steps) for r in tr["records"])
    return 100.0 * bound / (ms / 1e3)
