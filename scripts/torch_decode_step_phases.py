#!/usr/bin/env python3
"""Where kernel row 9's time goes: csrc/decode_step.cu per phase.

    python3 scripts/torch_decode_step_phases.py [CONST=VALUE ...] [--cut l2,nomma,nowiden]

Needs one CUDA GPU and nvcc. Builds decode_step.cu into build/ against an
instrumented copy of revisionllm_tpu_torch/csrc/decode_common.cuh (the
layer loop and phases that rows 9 and 10 share) in which block 0 reads
%globaltimer after every grid barrier, runs one decode step of
Vicuna-7B (32 layers, int8 weights from seed 0, B 64, a random int8 prompt
cache of 300 positions, step 11) three times, and prints the mean time of
each of the eight phases of a layer. CONST=VALUE overrides a constexpr of
the header (e.g. STAGES=6); --cut takes experiments that break the results
on purpose, to see what a part costs: `l2` loads every weight chunk from the
same 128 columns (L2 hits instead of device memory), `nomma` drops the
tensor-core products, `nowiden` drops the int8 -> bf16 tile stores.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

PHASES = ("rows: residual + norm", "q/k/v products", "attention", "o product",
          "rows: residual + norm", "gate/up products", "silu * up", "down product")
CUTS = {
    "l2": [("ok ? W + (size_t)k * cw + col : W",
            "ok ? a.w[first_mat + mi] + (size_t)l * K * N + (size_t)k * cw + col : W")],
    "nomma": [("wmma::mma_sync(acc[i], afrag, bfrag, acc[i]);", "")],
    # the tile store happens only for one unlikely byte pair, so the compiler
    # keeps the conversion but the stores are gone
    "nowiden": [("        for (int e = 0; e < 4; ++e) dst[e] = "
                 "reinterpret_cast<const uint4*>(hv)[e];",
                 "        if (raw[0] == 127 && raw[1] == -127) dst[0] = "
                 "reinterpret_cast<const uint4*>(hv)[0];")],
}
STAMP = ("{ if (blockIdx.x == 0 && threadIdx.x == 0) { unsigned long long t; "
         "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t)); g_stamps[ns++] = t; } }")


def instrumented(consts, cuts):
    """(the instrumented decode_common.cuh, decode_step.cu with read_stamps)."""
    csrc = ROOT / "revisionllm_tpu_torch" / "csrc"
    src = (csrc / "decode_common.cuh").read_text()
    for name, value in consts.items():
        src, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};", src)
        if n != 1:
            raise SystemExit(f"no constexpr int {name} in decode_common.cuh")
    for cut in cuts:
        for a, b in CUTS[cut]:
            if a not in src:
                raise SystemExit(f"--cut {cut}: its line is not in decode_common.cuh any more")
            src = src.replace(a, b)
    src = src.replace("namespace {\n",
                      "__device__ unsigned long long g_stamps[2048];\nnamespace {\n", 1)
    head, body = src.split("step_kernel(Args a) {", 1)
    body = body.replace("cg::grid_group grid = cg::this_grid();",
                        "cg::grid_group grid = cg::this_grid();\n  int ns = 0;\n  " + STAMP, 1)
    body = body.replace("grid.sync();", "grid.sync(); " + STAMP)
    return (head + "step_kernel(Args a) {" + body,
            (csrc / "decode_step.cu").read_text()
            + '\nextern "C" int read_stamps(void* dst) {\n'
              "  return (int)cudaMemcpyFromSymbol(dst, g_stamps, sizeof(g_stamps));\n}\n")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("consts", nargs="*", help="CONST=VALUE overrides")
    ap.add_argument("--cut", default="", help="comma-separated: " + ", ".join(CUTS))
    args = ap.parse_args()
    consts = dict(c.split("=", 1) for c in args.consts)
    cuts = [c for c in args.cut.split(",") if c]

    import torch
    from revisionllm_tpu_torch.config import LlamaConfig
    from revisionllm_tpu_torch.models import llama
    from revisionllm_tpu_torch.ops import decode_step as DS
    from revisionllm_tpu_torch.ops.rope import rope_angles
    from revisionllm_tpu_torch.utils import kernels

    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    work = kernels.BUILD_DIR / f"decode_step_phases_{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    src = work / "decode_step.cu"
    lib_path = src.with_suffix(".so")
    header, src_text = instrumented(consts, cuts)
    (work / "decode_common.cuh").write_text(header)
    src.write_text(src_text)
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(lib_path), str(src)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    kernels._LIBS["decode_step"] = lib

    dev = torch.device("cuda")
    cfg = LlamaConfig()
    L, H, hd, B, S, step = cfg.num_layers, cfg.num_heads, cfg.head_dim, 64, 300, 11
    params = llama.init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev, quantize=True)
    gen = torch.Generator(device=dev).manual_seed(16)
    lens = torch.randint(268, 289, (B,), generator=gen, device=dev, dtype=torch.int32)
    x = params["embed"][torch.randint(3, cfg.vocab_size, (B,), generator=gen, device=dev)]
    pkv = {"kv": torch.randint(-127, 128, (L, B, 2, H, S, hd), generator=gen, device=dev,
                               dtype=torch.int8),
           "kvsc": torch.rand((L, B, 2, H, S), generator=gen, device=dev) * 0.02 + 0.005}
    genkv = (torch.randn((L, 2, B, H, 16, hd), generator=gen, device=dev) * 0.5).to(torch.bfloat16)
    cos, sin = (t[:, 0] for t in rope_angles((lens + step)[:, None], hd, cfg.rope_theta))
    stamps = np.zeros(2048, np.uint64)
    lib.read_stamps.argtypes = [ctypes.c_void_p]
    per = []
    for _ in range(3):
        DS.decode_step_fused(params, pkv, genkv, lens, step, x, cos, sin, eps=cfg.rms_norm_eps)
        torch.cuda.synchronize()
        lib.read_stamps(stamps.ctypes.data)
        per.append(np.diff(stamps[: 1 + 8 * L].astype(np.int64)).reshape(L, 8) / 1e3)
    per = np.mean(per[1:], axis=0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"{smi}; overrides {consts or 'none'}; cuts {cuts or 'none'}")
    print(f"one decode step: {per.sum():.1f} us (mean of 2 runs after a warm-up)")
    for i, name in enumerate(PHASES):
        print(f"  {name:24s} {per[:, i].mean():8.1f} us a layer, {per[:, i].sum():9.1f} us a step")
    return 0


if __name__ == "__main__":
    sys.exit(main())
