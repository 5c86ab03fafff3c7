#!/usr/bin/env python3
"""What row 7's time is made of: copies of csrc/int4_matmul.cu with
constants changed or parts cut out on purpose, timed side by side.

    python3 scripts/torch_int4_probe.py [--variant NAME=SPEC ...] [--splits 1,2,4,8]

Needs one CUDA GPU and nvcc. Each variant is a copy of int4_matmul.cu (with
csrc/wonly_matmul_common.cuh inlined) built into build/int4_probe/, one nvcc
each, all in parallel; its ptxas register, spill and wgmma-serialisation
lines are printed. SPEC is a comma-separated list of CONST=VALUE overrides
of the source's constexprs (e.g. STAGES=3, MINB=2, KG=2, PDL=0) and cuts,
which break the results on purpose to see what a part costs: `empty`
returns at once (the launch alone), `nomma` replaces the wgmma products by
one add each, `nowiden` feeds the raw packed words to the products instead
of the widened ones, `nox` and `now` leave the x and the weight copies
zero-filled (no device-memory reads), `noloop` skips the main loop, `nosum`
the cluster sum and the stores, `nofence` the proxy fence before the tensor
cores read a stage, `nopin` the register pins around the wgmma groups. The
variant `base` (the source as it is) always runs.
Every variant is timed at the decode step's four shapes (M 64) with each K
split of --splits, by CUDA events over 20 launches that cycle through 128
MB of weight copies (cold L2, as in the decode step); the sum over one
decode step's 225 launches takes the best split of each shape. A variant
without cuts must hold the plain version (relative L2 1e-2) at every shape
and split. Prints the card's name and power limit, a line per (variant,
shape) and a line per variant.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import subprocess
import sys
from pathlib import Path

import kernel_variants as kv

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SHAPES = ((4096, 4096, 128), (4096, 11008, 64), (11008, 4096, 32), (4096, 32000, 1))
CUTS = {
    # the products: each wgmma replaced by one add of its A register
    "nomma": [("          attn::wgmma_m64n64k16(acc[j], a[b][e][j], attn::k_major(st, q * KG + e), "
               "1);", "          acc[j][0][0] += __uint_as_float(a[b][e][j][0]);")],
    # the widening: the raw words fed to the products
    "nowiden": [("  a[0][R] = wonly::pack_bf16(nib<0>(lo) * s.x, nib<0>(hi) * s.x);\n"
                 "  a[1][R] = wonly::pack_bf16(nib<1>(lo) * s.y, nib<1>(hi) * s.y);\n"
                 "  a[0][R + 1] = wonly::pack_bf16(nib<2>(lo) * s.z, nib<2>(hi) * s.z);\n"
                 "  a[1][R + 1] = wonly::pack_bf16(nib<3>(lo) * s.w, nib<3>(hi) * s.w);\n",
                 "  a[0][R] = lo; a[1][R] = hi; a[0][R + 1] = u; "
                 "a[1][R + 1] = __float_as_uint(s.x);\n")],
    # the device-memory reads: the copies zero-fill instead
    "nox": [("xb + (t0 + i) * BK, K, rows)", "xb + (t0 + i) * BK, K, 0)")],
    "now": [("      const bool ok = n0 + col < N;\n      wonly::cp_async16(wdst + rr * WS + col,",
             "      const bool ok = false;\n      wonly::cp_async16(wdst + rr * WS + col,")],
    # the main loop (the prologue's copies, the epilogue and the cluster sum stay)
    "noloop": [("  for (int i = 0; i < nk; ++i) {", "  for (int i = 0; i < 0; ++i) {")],
    # the cluster sum and the stores
    "nosum": [("  wonly::cluster_sum_store<MP, BN, RS, THREADS>(part, out + (size_t)m0 * N, rows, N, "
               "n0);", "")],
    # the proxy fence that orders the ring's copies before the tensor cores' reads
    "nofence": [("    attn::fence_proxy_async();           // ... and are visible to the tensor cores\n",
                 "")],
    # the register pins around the wgmma groups
    "nopin": [("      for (int e = 0; e < KG; ++e) attn::pin(a[b ^ 1][e]);", "      {}"),
              ("      attn::pin(a[0][e]);\n      attn::pin(a[1][e]);\n", "")],
    "empty": [("  unsigned char* smem = attn::align1024(smem_raw);\n",
               "  unsigned char* smem = attn::align1024(smem_raw);\n  if (K > 0) return;\n")],
}


def variant_source(spec: str) -> str:
    csrc = ROOT / "revisionllm_tpu_torch" / "csrc"
    src = (csrc / "int4_matmul.cu").read_text()
    # the shared header's parts are cut in a copy inlined in place of its include
    src = src.replace('#include "wonly_matmul_common.cuh"\n',
                      (csrc / "wonly_matmul_common.cuh").read_text().replace("#pragma once\n", ""))
    return kv.variant_source(src, spec, CUTS, "int4_matmul.cu")


def build(variants):
    """{name: C function} of each variant, variants mapping a name to its SPEC."""
    from revisionllm_tpu_torch.utils import kernels

    sources = {name: (variant_source(spec), spec, kernels.CSRC) for name, spec in variants.items()}
    libs = {}
    for name, lib in kv.build(sources, ROOT / "build" / "int4_probe").items():
        fn = lib.q4_matmul_bf16
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        libs[name] = fn
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", action="append", default=[], help="NAME=SPEC")
    ap.add_argument("--splits", default="1,2,4,8")
    args = ap.parse_args()
    import torch

    import chip_smoke as cs
    from revisionllm_tpu_torch.ops import quant as Q
    from revisionllm_tpu_torch.utils import kernels

    if not torch.cuda.is_available():
        print("torch_int4_probe: CUDA is not available", file=sys.stderr)
        return 3
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    variants = {"base": ""}
    for v in args.variant:
        name, spec = v.split("=", 1)
        variants[name] = spec
    libs = build(variants)
    splits = [int(s) for s in args.splits.split(",")]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    stream = kernels.stream_of(torch.empty(1, device=dev))
    best = {name: 0.0 for name in libs}
    for K, N, per_step in SHAPES:
        x = torch.randn((64, K), generator=gen, device=dev).to(torch.bfloat16)
        ws = [Q.quantize_int4(torch.randn((K, N), generator=gen, device=dev) * K ** -0.5)
              for _ in range(max(1, math.ceil(128e6 / (K * N // 2))))]
        out = torch.empty((64, N), dtype=torch.bfloat16, device=dev)
        for name, fn in libs.items():
            times = {}
            for s in splits:
                if s > K // Q.Q4_BK:
                    continue
                pick = cs.cycled(ws)

                def call():
                    q, sc = pick()
                    err = fn(x.data_ptr(), q.data_ptr(), sc.data_ptr(), out.data_ptr(), 64, K, N,
                             s, stream)
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")

                times[s] = cs.device_ms(call, cs.ITERS)
                if not kv.has_cut(variants[name], CUTS):
                    q, sc = ws[0]
                    fn(x.data_ptr(), q.data_ptr(), sc.data_ptr(), out.data_ptr(), 64, K, N, s,
                       stream)
                    want = Q.int4_matmul_plain(x, q, sc).float()
                    rel = ((out.float() - want).norm() / want.norm()).item()
                    if not rel <= 1e-2:
                        raise SystemExit(f"{name} K={K} N={N} S {s}: relative L2 {rel}")
            line = ", ".join(f"S {s} {ms * 1e3:.2f} us" for s, ms in times.items())
            print(f"{name} K={K} N={N}: {line}", flush=True)
            best[name] += per_step * min(times.values())
        del ws
    for name, ms in best.items():
        print(f"{name} ({variants[name] or 'as is'}): {ms:.4f} ms a decode step (best split of "
              f"each shape)", flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
