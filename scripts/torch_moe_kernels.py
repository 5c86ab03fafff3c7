"""DeepSeekMoE's grouped expert kernels on the card: build the kernels,
then chip_smoke.py's check_moe_kernels (the grouped W8A8 GEMM and the
grouped W8A16 against their plain versions at the DeepSeek-V2-Lite cell's
shapes, planted faults, times beside the bounds and the dense kernels'
per-expert loops), then one query of the cell dsv2-lite.ground-1h
(DeepSeek-V2-Lite at its published widths, weights from a seed) through
GroundingEngine.ground_windows with the launches its wrappers made of each
kernel (kernels.LAUNCHES: the eager decode steps and their capture), then
a query whose decode steps replay as CUDA graphs with the kernels the
profiler saw run, failing if a plain expert product ran on the card.

    python3 scripts/torch_moe_kernels.py     # on a machine with an H100
"""

import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "benchmark"), str(ROOT)]


def main() -> int:
    import torch

    import chip_smoke as CS
    from revisionllm_tpu_torch.utils import kernels

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    kernels.build(["w8a8_gemm", "int8_matmul"])
    CS.report_ptxas(kernels, ["w8a8_gemm", "int8_matmul"])
    CS.check_moe_kernels(torch.device("cuda"), CS.ITERS)
    return serving_launches()


def serving_launches() -> int:
    """Two queries of the DeepSeek-V2 cell and their launches."""
    import run as R
    import torch
    from benchlib.cell import cell as find_cell
    from benchlib.cell import module
    from revisionllm_tpu_torch.ops import moe as MOE
    from revisionllm_tpu_torch.utils import kernels

    R.prepare_environment()
    plain = {"cuda": 0}
    for name in ("grouped_w8a8_plain", "grouped_w8a16_plain"):
        real = getattr(MOE, name)

        def counted(*a, real=real, **k):
            plain["cuda"] += int(a[0].is_cuda)
            return real(*a, **k)

        setattr(MOE, name, counted)
    cell = find_cell("dsv2-lite.ground-1h")
    driver = module("drivers", cell["traffic"]["driver"]).Driver(cell, 2147483999, "cuda")
    driver.setup(warm=False)
    # the first query builds the kernels, runs each decode step eagerly and
    # captures it: the wrappers count every launch they make, the captures'
    kernels.reset_launches()
    rec = driver.query(next(driver.stream))
    first = {k: v for k, v in kernels.LAUNCHES.items() if v}
    # the second replays the decode steps' graphs, whose launches no wrapper
    # makes: the profiler counts the kernels the device ran
    ran = dict.fromkeys(("moe_w8a8_kernel", "moe_w8a16_kernel", "s8gemm_kernel",
                         "q8_matmul_kernel"), 0)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        again = driver.query(next(driver.stream))
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            for name in ran:
                ran[name] += re.search(rf"(?<![A-Za-z0-9_]){name}(?![A-Za-z0-9_])",
                                       e.name) is not None
    print(f"# first query ({rec['windows']} windows, {rec['latency_s'] * 1e3:.1f} ms, eager "
          f"steps and their capture): wrapper launches {first}; a replayed query "
          f"({again['latency_s'] * 1e3:.1f} ms under the profiler): kernels on the device "
          f"{ran}; plain expert products on the card {plain['cuda']}", flush=True)
    steps = cell["traffic"]["eval"]["max_new_tokens"] - 1
    moe_layers = cell["dims"]["layers"] - cell["dims"]["dense_layers"]
    ok = (first.get("moe_w8a8") == 2 * moe_layers
          and first.get("moe_w8a16") == 2 * 2 * moe_layers * steps
          and first.get("w8a8_gemm", 0) > 0 and first.get("int8_matmul", 0) > 0
          and ran["moe_w8a8_kernel"] == 2 * moe_layers
          and ran["moe_w8a16_kernel"] == 2 * moe_layers * steps
          and ran["s8gemm_kernel"] > 0 and ran["q8_matmul_kernel"] > 0
          and plain["cuda"] == 0)
    return 0 if ok else 1

if __name__ == "__main__":
    sys.exit(main())
