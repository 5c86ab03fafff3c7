#!/usr/bin/env python3
"""The W8A8 prefill's kernels (csrc/w8a8_gemm.cu: quantize_rows_kernel,
kmajor_transpose_kernel, s8gemm_kernel) alone on one CUDA card: their
ptxas report, then `chip_smoke.py`'s check_w8a8_gemm (bit-equality with the
PyTorch route and planted faults at the benchmark cells' shapes, the edge
cases at both tile widths, launches and allocations a call, each kernel's
time beside its bound, its plain version and torch._int_mm with and
without its PyTorch epilogue, one layer of each cell). About a minute of
command time:

    python3 scripts/torch_w8a8_gemm.py [--variant NAME=SPEC ...] [--no-check]

Needs one CUDA GPU and nvcc. With --variant, copies of w8a8_gemm.cu built
into build/w8a8_probe/ by scripts/kernel_variants.py (one nvcc each, all in
parallel) are timed side by side with the source as it is (`base`), each at
the cells' seven (K, N) shapes, M = 64 x 304, and at both tile widths (the
GEMM alone, by CUDA events over 20 calls, the transpose left out). SPEC is
a comma-separated list of CONST=VALUE overrides of the source's
constexprs (GROUP_M, RING) and cuts, which break the results on purpose
to see what a part costs: `noepi` skips the bf16 epilogue (conversion,
staging, TMA stores), `nomma` drops the wgmma products, `nocopy` lets the
producer release every stage without copying. Variants without a cut must
give the base's bits. Prints
the card's name and power limit first and last.
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

SRC = Path("revisionllm_tpu_torch") / "csrc" / "w8a8_gemm.cu"

CUTS = {
    # the bf16 epilogue: no conversion, no staging, no stores
    "noepi": [("        if (b >= live) break;\n", "        if (b >= 0) break;\n")],
    # the products: each wgmma replaced by one add
    "nomma": [("            wgmma_s8(acc[b], da, box_desc(st + (1 + b) * BOX, kk), accum);\n",
               "            acc[b][kk][0] += (uint32_t)da + accum;\n")],
    # the copies: the producer arrives without issuing any (stale stages)
    "nocopy": [("wonly::mbar_arrive_expect(full + slot, (uint32_t)((1 + live) * BOX));",
                "wonly::mbar_arrive(full + slot);"),
               ("          wonly::tma_load_2d(st, &tmap_x, kt * BK, m0, full + slot);\n",
                ""),
               ("            if (b < live) wonly::tma_load_2d(st + (1 + b) * BOX, &tmap_w, "
                "kt * BK, n0 + 128 * b,\n                                             full + slot);\n",
                "            ;\n")],
}
M_PROBE = 64 * 304


def gemm_args():
    return [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_longlong] + \
        [ctypes.c_int] * 2 + [ctypes.c_void_p]


def probe(variants):
    """Build each variant, then time its GEMM at every cell shape and both
    tile widths; variants without a cut must equal the base bit for bit."""
    import torch

    import chip_smoke as cs
    from revisionllm_tpu_torch.ops import quant as Q
    from revisionllm_tpu_torch.utils import kernels

    src = (ROOT / SRC).read_text()
    sources = {"base": (src, "", ROOT / SRC.parent)}
    for name, spec in variants:
        sources[name] = (kv.variant_source(src, spec, CUTS, SRC.name), spec, ROOT / SRC.parent)
    libs = kv.build(sources, ROOT / "build" / "w8a8_probe")
    fns = {}
    for name, lib in libs.items():
        fn = lib.w8a8_gemm
        fn.restype, fn.argtypes = ctypes.c_int, gemm_args()
        fns[name] = fn
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    M = M_PROBE
    shapes = sorted({(k, n) for layer in cs.W8A8_LAYERS.values() for _, k, n in layer})
    for K, N in shapes:
        x = cs.w8a8_rows(gen, M, K, dev)
        xq, xs = Q.quantize_rows(x)
        wq, ws = Q.quantize_int8(torch.randn((K, N), generator=gen, device=dev) * K ** -0.5)
        wt = torch.empty((N, K), dtype=torch.int8, device=dev)
        b, _ = cs.bound(0, 2.0 * M * K * N, cs.INT8_OPS_PER_S)
        plan = Q.w8a8_tile_columns(M, N, Q._sm_count(dev))
        line = []
        for nb in (1, 2):
            want = None
            for name, fn in fns.items():
                out = torch.empty((M, N), dtype=torch.bfloat16, device=dev)

                def call():
                    err = fn(xq.data_ptr(), xs.data_ptr(), wq.data_ptr(), ws.data_ptr(),
                             wt.data_ptr(), out.data_ptr(), M, K, N, N, 0, nb,
                             kernels.stream_of(xq))
                    kernels.check_launch(name, err)

                call()
                torch.cuda.synchronize()
                if name == "base":
                    want = out.clone()
                elif not kv.has_cut(sources[name][1], CUTS) and not torch.equal(out, want):
                    raise SystemExit(f"variant {name} differs from base at K={K} N={N} nb={nb}")
                ms = cs.kernel_ms(call, cs.ITERS, ["s8gemm_kernel"])["s8gemm_kernel"]
                line.append(f"{name}/{128 * nb} {ms:.4f} ({100 * b / ms:.1f}%)")
        print(f"# K={K} N={N} M={M} (plan {128 * plan} columns; bound {b:.4f} ms): "
              + ", ".join(line), flush=True)
        del x, xq, xs, wq, ws, wt


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", default=[], metavar="NAME=SPEC")
    ap.add_argument("--no-check", action="store_true", help="skip chip_smoke's check")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from revisionllm_tpu_torch.utils import kernels

    if not torch.cuda.is_available():
        print("torch_w8a8_gemm: CUDA is not available", file=sys.stderr)
        return 3
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"# build: {kernels.build(['w8a8_gemm'])}", flush=True)
    cs.report_ptxas(kernels, ["w8a8_gemm"])
    if args.variant:
        probe([tuple(v.split("=", 1)) for v in args.variant])
    if not args.no_check:
        print(cs.check_w8a8_gemm(torch.device("cuda"), cs.ITERS), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
