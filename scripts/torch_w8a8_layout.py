#!/usr/bin/env python3
"""The W8A8 prefill GEMM of the PyTorch port by weight layout, on one GPU.

    python3 scripts/torch_w8a8_layout.py

cuBLAS picks its int8 kernel for `torch._int_mm` by the operands' layout.
For each prefill weight shape of Vicuna-7B at a chunk of 64 windows
(M = 64 x 330 rows), this times `_int_mm` with the [K, N] int8 weight
row-major (as stored) and column-major, and the transposed copy that
`revisionllm_tpu_torch.ops.quant._w8a8_product` makes on every call to get
the fast layout. Times are device times by CUDA events (see
`chip_smoke.device_ms`). Prints the card's name and power limit first.
Imports nothing of JAX.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

ITERS = 20


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_w8a8_layout: CUDA is not available", file=sys.stderr)
        return 3
    from chip_smoke import device_ms

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip())
    dev = torch.device("cuda")
    M = 64 * 330
    for K, N in ((4096, 4096), (4096, 11008), (11008, 4096)):
        a = torch.randint(-127, 128, (M, K), device=dev, dtype=torch.int8)
        w = torch.randint(-127, 128, (K, N), device=dev, dtype=torch.int8)
        wt = w.t().contiguous()
        row = device_ms(lambda: torch._int_mm(a, w), ITERS)
        col = device_ms(lambda: torch._int_mm(a, wt.t()), ITERS)
        trans = device_ms(lambda: w.t().contiguous(), ITERS)
        ops = 2.0 * M * K * N
        print(f"_int_mm M={M} K={K} N={N}: row-major W {row:.3f} ms ({ops / row / 1e9:.0f} TOP/s), "
              f"column-major W {col:.3f} ms ({ops / col / 1e9:.0f} TOP/s), transposing W {trans:.3f} ms",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
