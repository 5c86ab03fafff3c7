#!/usr/bin/env python3
"""The distributed layer on four cards over NCCL.

    python3 scripts/torch_parallel_4gpu.py [--layers 32]     # on a host with four H100s

Runs chip_smoke.py's phase 19 (phase_parallel) with four ranks, one a card,
over NCCL: the stage-1 chunk of the 1-hour movie (57 windows, int8, W8A8
prefill, KV8) at Vicuna-7B width and `--layers` depth under mesh (1,1,4)
and (4,1,1), each timed after the rank's one untimed chunk without a mesh
and one small all-reduce on each of the mesh's groups, and held against the
one-rank run on card 0 (hold_sharded: (4,1,1) bit for bit, (1,1,4) by its
logits and greedy tokens at every step), and one 2-layer stage-1 QLoRA
step under mesh (2,1,2), timed after an untimed one, against the one-rank
step (loss 2e-3 relative, every gradient 5e-2 relative L2). Prints each rank's chunk ms, the collectives a chunk (count,
bytes, ms) and kernel launches, and the cards' names and power limits.
Exits non-zero without four CUDA devices or when a check fails.
"""

from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--layers", type=int, default=32)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        print("torch_parallel_4gpu: needs four CUDA devices", file=sys.stderr)
        return 3
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from revisionllm_tpu_torch.utils import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    cs.say(f"torch {torch.__version__} cuda {torch.version.cuda}, {torch.cuda.device_count()} "
           f"devices")
    t0 = time.perf_counter()
    kernels.build()
    cs.say(f"build: {time.perf_counter() - t0:.1f} s")
    tmp = tempfile.mkdtemp(prefix="parallel_4gpu_")
    try:
        paths = cs._corpus(tmp)
        cs.phase_parallel(torch.device("cuda"), tmp, paths, smi.splitlines()[0],
                          layers=args.layers, meshes=((1, 1, 4), (4, 1, 1)),
                          train_meshes=((2, 1, 2),), backend="nccl", budget=None,
                          tag="4 cards")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(smi, flush=True)
    print("torch_parallel_4gpu ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
