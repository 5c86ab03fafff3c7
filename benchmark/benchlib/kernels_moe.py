"""The two grouped expert kernels of DeepSeekMoE on the profiler's
timeline, matched by their exact __global__ names (csrc/w8a8_gemm.cu
moe_w8a8_kernel, csrc/int8_matmul.cu moe_w8a16_kernel), whatever template
arguments and parameters the demangled name carries."""

from __future__ import annotations

import re
from typing import Tuple

MOE_W8A8 = "moe_w8a8_kernel"
MOE_W8A16 = "moe_w8a16_kernel"


def _named(name: str, kernel: str) -> bool:
    return re.search(rf"(?<![A-Za-z0-9_]){kernel}(?![A-Za-z0-9_])", name) is not None


def kernel_time(run, kernel: str) -> Tuple[float, int]:
    """(device ms, calls) of `kernel` over the traced queries' operations."""
    tr = run["trace"]
    ops = [o for o in tr["ops"] if _named(o.name, kernel)]
    return sum(o.ms for o in ops), len(ops)
