#!/usr/bin/env python3
"""Row 8 (w8a8_mlp_fused, csrc/w8a8_mlp_fused.cu) alone on one CUDA card,
at the stage-1 prefill's shape (M = 64 x 300, K 4096, N 11008) or at --m
rows: its variants timed side by side, the two yardsticks, and
`chip_smoke.py`'s own check.

    python3 scripts/torch_fused_mlp_kernel.py [--variant NAME=SPEC ...] [--parent ROOT] [--m M] [--check]

Needs one CUDA GPU and nvcc. Each variant is a copy of w8a8_mlp_fused.cu
built into build/mlp_probe/ by scripts/kernel_variants.py, one nvcc each,
all in parallel; its ptxas registers, spills and wgmma or setmaxnreg
warnings are printed. SPEC is a
comma-separated list of CONST=VALUE overrides of the source's constexprs
(STAGES, GROUP_M, e.g. GROUP_M=1 walks a row stripe across all column
tiles, the N-fastest order) and cuts, which break the results on purpose to
see what a part costs: `nomma` drops the wgmma products, `nocopy` lets the
producer release every stage without copying, `noexp` computes h = g * u
(no expf, no division), `rcpdiv` divides by a
reciprocal and a product, `nostore` drops the stores of h, `noepi` skips the
epilogue. The variant `base` (the source as it is) always runs.

--parent ROOT also builds ROOT's w8a8_mlp_fused.cu as it is (`parent`, the
mma.sync design of grid (N / 64, M / 128), N fastest) and with its grid
turned M-fastest (`parent_mfast`): if the N-fastest order re-reads the
weights from device memory once a row stripe, the M-fastest one is faster.

Every variant is timed by CUDA events over 20 calls and, under the
profiler, by kernel; every variant without a cut must hold the plain
version (hs 1e-6 relative, hq within +-1 and 99.9% equal). Beside them in
the same run: two torch._int_mm on column-major weights with the epilogue
in PyTorch, and without it. With --check, chip_smoke.check_fused_mlp runs on
this checkout's kernel (ptxas, the planted faults, the edge cases, the
launches and allocations of a call). Prints the card's name and power limit
first and last.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import kernel_variants as kv

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SRC = Path("revisionllm_tpu_torch") / "csrc" / "w8a8_mlp_fused.cu"

CUTS = {
    # the products: each wgmma replaced by one add
    "nomma": [("          wgmma_s8(accg, da, box_desc(st + BOX, kk), acc);\n"
               "          wgmma_s8(accu, da, box_desc(st + 2 * BOX, kk), acc);\n",
               "          accg[kk][0] += (uint32_t)da;\n          accu[kk][0] += acc;\n")],
    # the copies: the producer arrives without issuing any (stale stages)
    "nocopy": [("wonly::mbar_arrive_expect(full + slot, (uint32_t)STAGE);",
                "wonly::mbar_arrive_expect(full + slot, 0u);"),
               ("          wonly::tma_load_2d(st, &tmap_x, kt * BK, m0, full + slot);\n"
                "          wonly::tma_load_2d(st + BOX, &tmap_g, kt * BK, n0, full + slot);\n"
                "          wonly::tma_load_2d(st + 2 * BOX, &tmap_u, kt * BK, n0, full + slot);\n",
                "")],
    # the activation: h = g * u
    "noexp": [("hv[e] = (gv / (1.0f + expf(-gv))) * uv;", "hv[e] = gv * uv;")],
    # the stores of h
    "nostore": [("              *reinterpret_cast<float2*>(hr + col) = make_float2(hv[0], hv[1]);",
                 "              if (hv[0] == 1.2345f) *reinterpret_cast<float2*>(hr + col) = "
                 "make_float2(hv[0], hv[1]);")],
    # the activation's division as a correctly rounded reciprocal and a product
    "rcpdiv": [("hv[e] = (gv / (1.0f + expf(-gv))) * uv;",
                "hv[e] = (gv * __frcp_rn(1.0f + expf(-gv))) * uv;")],
    # the whole epilogue
    "noepi": [("        if (row < M) {\n          const float xr = sxs[r];",
               "        if (row < 0) {\n          const float xr = sxs[r];")],
}

# the parent's mma.sync kernel with its grid turned M-fastest
MFAST = [("  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;",
          "  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;"),
         ("  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);",
          "  dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);")]


def build(variants):
    """{name: (C function, new calling convention?)} of each variant;
    variants maps a name to (source text, spec, include directory)."""
    edits = {**CUTS, "mfast": MFAST}
    sources = {name: (kv.variant_source(src, spec, edits, SRC.name), spec, inc)
               for name, (src, spec, inc) in variants.items()}
    fns = {}
    for name, lib in kv.build(sources, ROOT / "build" / "mlp_probe").items():
        fn = lib.w8a8_mlp_fused
        fn.restype = ctypes.c_int
        new = "mlp_transpose_kernel" in variants[name][0]
        fn.argtypes = [ctypes.c_void_p] * (11 if new else 10) + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fns[name] = (fn, new)
    return fns


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", action="append", default=[], help="NAME=SPEC")
    ap.add_argument("--parent", help="a checkout of the parent commit")
    ap.add_argument("--m", type=int, help="rows of x (default: the prefill's 64 x T)")
    ap.add_argument("--check", action="store_true",
                    help="also run chip_smoke.check_fused_mlp on this checkout")
    args = ap.parse_args()
    import torch

    import chip_smoke as cs
    from revisionllm_tpu_torch.ops import quant as Q
    from revisionllm_tpu_torch.utils import kernels

    if not torch.cuda.is_available():
        print("torch_fused_mlp_kernel: CUDA is not available", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    src = (ROOT / SRC).read_text()
    variants = {"base": (src, "", ROOT / SRC.parent)}
    for v in args.variant:
        name, spec = v.split("=", 1)
        variants[name] = (src, spec, ROOT / SRC.parent)
    if args.parent:
        parent = Path(args.parent).resolve()
        psrc = (parent / SRC).read_text()
        variants["parent"] = (psrc, "", parent / SRC.parent)
        variants["parent_mfast"] = (psrc, "mfast", parent / SRC.parent)
    fns = build(variants)

    dev = torch.device("cuda")
    T = cs.prompt_geometry("mad_grounding", 250, 12)[1]
    M, K, N = args.m or 64 * T, 4096, 11008
    gen = torch.Generator(device=dev).manual_seed(15)
    xq, xs, gq, gs, uq, us = cs.mlp_inputs(gen, M, K, N, dev)
    want = Q.w8a8_mlp_fused_plain(xq, xs, gq, gs, uq, us)
    stream = kernels.stream_of(xq)
    b, by = cs.bound(M * K + 2 * K * N + 2 * N * 4 + M * 4 + M * N + M * 4, 4.0 * M * K * N,
                     cs.INT8_OPS_PER_S)
    print(f"# M={M} K={K} N={N}; bound {b:.4f} ms ({by}, 1979 TOPS int8)", flush=True)
    for name, (fn, new) in fns.items():
        def call():
            hq = torch.empty((M, N), dtype=torch.int8, device=dev)
            hs = torch.empty((M, 1), dtype=torch.float32, device=dev)
            h = torch.empty((M, N), dtype=torch.float32, device=dev)
            ptrs = [t.data_ptr() for t in (xq, xs, gq, gs, uq, us)]
            if new:
                wt = torch.empty((2, N, K), dtype=torch.int8, device=dev)
                rowmax = torch.empty((M,), dtype=torch.float32, device=dev)
                ptrs.append(wt.data_ptr())
            else:
                rowmax = torch.zeros((M,), dtype=torch.float32, device=dev)
            err = fn(*ptrs, h.data_ptr(), rowmax.data_ptr(), hq.data_ptr(), hs.data_ptr(),
                     M, K, N, stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")
            return hq, hs

        spec = variants[name][1]
        if not kv.has_cut(spec, CUTS):
            cs.hold_mlp(f"{name} M={M}", call(), want)
        ms = cs.device_ms(call, cs.ITERS)
        parts = cs.kernel_ms(call, cs.ITERS, cs.ROW8_KERNELS)
        print(f"{name} ({spec or 'as is'}): {ms:.4f} ms a call; by kernel "
              + ", ".join(f"{k} {v:.4f}" for k, v in parts.items()), flush=True)
    del want
    lib, lib_gemm = cs.mlp_yardsticks((xq, xs, gq, gs, uq, us), 5)
    print(f"two torch._int_mm + epilogue {lib:.4f} ms; two torch._int_mm alone {lib_gemm:.4f} ms",
          flush=True)
    if args.check:
        kernels.build(["w8a8_mlp_fused"])
        cs.report_ptxas(kernels, ["w8a8_mlp_fused"])
        rec = cs.check_fused_mlp(dev, cs.ITERS)
        print(f"check_fused_mlp: {rec['ms']:.4f} ms a call, parts {rec['parts_ms']}, yardsticks "
              f"{rec['library_ms']:.4f} and {rec['library_gemm_ms']:.4f} ms, bound "
              f"{rec['bound_ms']:.4f} ms", flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
