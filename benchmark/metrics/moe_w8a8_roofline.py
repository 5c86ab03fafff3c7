"""moe_w8a8_roofline: DeepSeekMoE's grouped W8A8 GEMM (ops/moe.py
grouped_w8a8, moe_w8a8_kernel), the prefill's expert products: the least
time their work needs (benchlib.roofline_moe.moe_w8a8_bound_s: 6 routed
rows a live position, each expert's weights read once) over the kernel's
summed device time in the traced queries, in %. Nothing is read unless the
profiler shows exactly the calls that work counts. Moves queries_per_s."""

from benchlib.kernels_moe import MOE_W8A8, kernel_time
from benchlib.roofline_moe import moe_w8a8_bound_s, moe_w8a8_calls


def read(run):
    tr = run["trace"]
    dims = run["cell"]["dims"]
    if not tr or not tr["records"] or "kv_lora" not in dims:
        return None
    ms, calls = kernel_time(run, MOE_W8A8)
    if not ms or calls != moe_w8a8_calls(dims) * len(tr["records"]):
        return None
    bound = sum(moe_w8a8_bound_s(dims, r["windows"], r["live"]) for r in tr["records"])
    return 100.0 * bound / (ms / 1e3)
