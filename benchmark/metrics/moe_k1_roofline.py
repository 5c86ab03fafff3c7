"""moe_k1_roofline: DeepSeekMoE's grouped W8A16 product (ops/moe.py
grouped_w8a16, moe_w8a16_kernel, K1's frame), the decode steps' expert
products: the least time their work needs (benchlib.roofline_moe.
moe_k1_bound_s: the int8 weights of the experts each layer-step's rows
chose, bytes-bound) over the kernel's summed device time in the traced
queries, in %. The experts chosen are the program's own dispatch counts
of those queries (drivers/ground_windows_dsv2.py keeps them), not worked
out again here: the bound follows the program's routing. Nothing is read
unless the profiler shows exactly the calls that work counts. Moves
queries_per_s."""

from benchlib.kernels_moe import MOE_W8A16, kernel_time
from benchlib.roofline_moe import moe_k1_bound_s, moe_k1_calls


def read(run):
    tr = run["trace"]
    dims = run["cell"]["dims"]
    if not tr or not tr["records"] or "kv_lora" not in dims \
            or any("moe_counts" not in r for r in tr["records"]):
        return None
    steps = run["cell"]["traffic"]["eval"]["max_new_tokens"] - 1
    ms, calls = kernel_time(run, MOE_W8A16)
    if not ms or calls != moe_k1_calls(dims, steps) * len(tr["records"]) \
            or 2 * sum(len(r["moe_counts"]) for r in tr["records"]) != calls:
        return None
    bound = sum(moe_k1_bound_s(dims, r["windows"], r["moe_counts"]) for r in tr["records"])
    return 100.0 * bound / (ms / 1e3)
