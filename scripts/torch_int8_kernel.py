#!/usr/bin/env python3
"""K1 (int8_matmul, csrc/int8_matmul.cu) alone on one CUDA card: its
variants timed side by side at the decode step's shapes, and
`chip_smoke.py`'s own check.

    python3 scripts/torch_int8_kernel.py [--variant NAME=SPEC ...] [--splits 1,2,4,8] [--check]

Needs one CUDA GPU and nvcc. Each variant is a copy of int8_matmul.cu built
into build/int8_probe/, one nvcc each, all in parallel; its ptxas register,
spill and wgmma-serialisation lines and its resident clusters are printed.
SPEC is a comma-separated list of CONST=VALUE overrides of the source's
constexprs (STAGES, MINB, KG, PDL, e.g. STAGES=3,MINB=2) and cuts, which
break the results on purpose to see what a part costs: `empty` returns at
once (the launch alone), `noloop` runs no tile (the prologue, epilogue and
cluster sum stay), `nomma` replaces the wgmma products by one add each,
`nowiden` feeds the raw words to the products, `nocopy` lets the producer
release every stage without copying (no device-memory reads), `nosum` drops
the split-K sum and its stores, `sumsync` keeps only its two cluster
barriers, `localsum` reads the rank's own tile S times (no remote reads),
`nostore` drops the sum's stores to device memory. The variant `base` (the
source as it is) always runs. --parent ROOT adds the variant `parent`, ROOT's
own int8_matmul.cu built with ROOT's headers, and requires its outputs to be
bit-identical to `base`'s at every shape and split.

Every variant is timed at the decode step's four shapes (M 64) with each K
split of --splits, by CUDA events over 20 launches that cycle through 128 MB
of weight copies (cold L2, as in the decode step), and must hold the plain
version (relative L2 1e-2) at every shape and split unless it has a cut.
Beside them in the same run: torch.matmul on the bf16 weight. Per variant, the sum over one decode
step's 225 launches with the best split of each shape and with the split
q8_plan picks (from that variant's resident clusters). Then the host's time
to enqueue one call of ops.quant.int8_matmul (the wrapper, the two tensor
maps encoded on the host and the launch) against one torch.matmul call,
and of the C call alone for each variant.
With --check, chip_smoke.check_int8_matmul runs on this checkout's kernel
(the planted faults, the edge cases, one launch a call). Prints the card's
name and power limit first and last.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import subprocess
import sys
import time
from pathlib import Path

import kernel_variants as kv

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


CUTS = {
    # the launch alone: every block returns at once
    "empty": [("  unsigned char* smem = attn::align1024(smem_raw);\n",
               "  unsigned char* smem = attn::align1024(smem_raw);\n  if (K > 0) return;\n")],
    # no tiles: the prologue, the epilogue and the cluster sum stay
    "noloop": [("  const int nk = base + (r < rem);", "  const int nk = 0 * (base + (r < rem));")],
    # the products: each wgmma replaced by one add of its A register
    "nomma": [("          attn::wgmma_m64n64k16(acc[j], a[b][e][j], attn::k_major(st, q * KG + e), "
               "1);", "          acc[j][0][0] += __uint_as_float(a[b][e][j][0]);")],
    # the widening: the raw words fed to the products
    "nowiden": [("        wonly::widen<0>(a[b][e], r0, r1);  // k 2t, 2t + 1\n"
                 "        wonly::widen<2>(a[b][e], r8, r9);  // k 2t + 8, 2t + 9\n",
                 "        a[b][e][0][0] = r0;\n        a[b][e][1][0] = r1;\n"
                 "        a[b][e][0][1] = r0 ^ r1;\n        a[b][e][1][1] = r0 + r1;\n"
                 "        a[b][e][0][2] = r8;\n        a[b][e][1][2] = r9;\n"
                 "        a[b][e][0][3] = r8 ^ r9;\n        a[b][e][1][3] = r8 + r9;\n")],
    # the copies: the producer arrives without issuing any (stale stages)
    "nocopy": [("(uint32_t)STAGE", "0u"), ("        issue_w(i, i);\n", ""),
               ("      for (int i = 0; i < pre; ++i) issue_x(i, i);\n", ""),
               ("        issue_w(slot, i);\n        issue_x(slot, i);\n", "")],
    # the cluster sum and its stores
    "nosum": [("  bf16* ob = out + (size_t)m0 * N;\n",
               "  bf16* ob = out + (size_t)m0 * N;\n  if (K > 0) return;\n")],
    # the cluster sum reading this rank's own tile S times (no remote reads)
    "localsum": [("  for (int p = 0; p < S; ++p) src[p] = wonly::cluster_addr(part, p);",
                  "  for (int p = 0; p < S; ++p) src[p] = wonly::cluster_addr(part, r);")],
    # the cluster sum without its stores to device memory
    "nostore": [("      *reinterpret_cast<uint2*>(out + (size_t)row * N + n0 + col) = o;",
                 "      if (o.x == 0x7FFF7FFFu) *reinterpret_cast<uint2*>(out + (size_t)row * N + n0 + col) = o;")],
    # the cluster sum's two cluster barriers alone
    "sumsync": [("  bf16* ob = out + (size_t)m0 * N;\n",
                 "  bf16* ob = out + (size_t)m0 * N;\n  if (K > 0) {\n    wonly::cluster_sync();\n"
                 "    wonly::cluster_sync();\n    return;\n  }\n")],
}


SRC = ROOT / "revisionllm_tpu_torch" / "csrc" / "int8_matmul.cu"


def build(variants, parent=None):
    """{name: (C function, resident clusters of 1, 2, 4, 8)} of each
    variant, variants mapping a name to its SPEC, and `parent` (another
    checkout's root) built as it is under the name "parent"."""
    from revisionllm_tpu_torch.utils import kernels

    src = SRC.read_text()
    sources = {name: (kv.variant_source(src, spec, CUTS, SRC.name), spec, kernels.CSRC)
               for name, spec in variants.items()}
    if parent is not None:
        csrc = Path(parent).resolve() / SRC.relative_to(ROOT).parent
        sources["parent"] = ((csrc / SRC.name).read_text(), "", csrc)
    libs = {}
    for name, lib in kv.build(sources, ROOT / "build" / "int8_probe").items():
        fn = lib.q8_matmul_bf16
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.q8_matmul_max_clusters.argtypes = [ctypes.c_int]
        resident = tuple(lib.q8_matmul_max_clusters(s) for s in (1, 2, 4, 8))
        print(f"# {name}: {lib.q8_matmul_smem_bytes()} B shared memory, resident clusters of "
              f"1, 2, 4, 8: {resident}", flush=True)
        libs[name] = (fn, resident)
    return libs


def host_us(fn, calls=400):
    """Host microseconds to enqueue one call of fn (the device runs behind)."""
    import torch

    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", action="append", default=[], help="NAME=SPEC")
    ap.add_argument("--splits", default="1,2,4,8")
    ap.add_argument("--check", action="store_true",
                    help="also run chip_smoke.check_int8_matmul on this checkout")
    ap.add_argument("--parent", help="another checkout's root: its K1 must give the same bits")
    args = ap.parse_args()
    import torch

    import chip_smoke as cs
    from revisionllm_tpu_torch.ops import quant as Q
    from revisionllm_tpu_torch.utils import kernels

    if not torch.cuda.is_available():
        print("torch_int8_kernel: CUDA is not available", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    variants = {"base": ""}
    for v in args.variant:
        name, spec = v.split("=", 1)
        variants[name] = spec
    libs = build(variants, args.parent)
    variants.setdefault("parent", "")
    splits = [int(s) for s in args.splits.split(",")]
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(3)
    stream = kernels.stream_of(torch.empty(1, device=dev))
    best = {name: 0.0 for name in libs}
    planned = {name: 0.0 for name in libs}
    library = 0.0
    for K, N, per_step in cs.DECODE_SHAPES:
        x = torch.randn((64, K), generator=gen, device=dev).to(torch.bfloat16)
        ws = []
        for _ in range(max(1, math.ceil(128e6 / (K * N)))):
            q, s = Q.quantize_int8(torch.randn((K, N), generator=gen, device=dev) * K ** -0.5)
            ws.append((q, s, Q.dequantize_int8(q, s, torch.bfloat16)))
        out = torch.empty((64, N), dtype=torch.bfloat16, device=dev)
        want = Q.int8_matmul_plain(x, *ws[0][:2]).float()
        pick = cs.cycled(ws)
        lib = cs.device_ms(lambda: torch.matmul(x, pick()[2]), cs.ITERS)
        library += per_step * lib
        print(f"torch.matmul(bf16 W) K={K} N={N}: {lib * 1e3:.2f} us", flush=True)
        bits = {}  # (variant, split) -> its output, for the parent's bit-identity
        for name, (fn, resident) in libs.items():
            times = {}
            for s in splits:
                if s > -(-K // Q.Q8_BK):
                    continue
                pick = cs.cycled(ws)

                def call():
                    q, sc = pick()[:2]
                    err = fn(x.data_ptr(), q.data_ptr(), sc.data_ptr(), out.data_ptr(), 64, K, N,
                             s, stream)
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")

                if not kv.has_cut(variants[name], CUTS):
                    q, sc = ws[0][:2]
                    fn(x.data_ptr(), q.data_ptr(), sc.data_ptr(), out.data_ptr(), 64, K, N, s,
                       stream)
                    rel = ((out.float() - want).norm() / want.norm()).item()
                    if not rel <= 1e-2:
                        raise SystemExit(f"{name} K={K} N={N} S {s}: relative L2 {rel}")
                    bits[name, s] = out.clone()
                times[s] = cs.device_ms(call, cs.ITERS)
            plan = Q.q8_plan(64, K, N, sms, resident).splitk
            line = ", ".join(f"S {s} {ms * 1e3:.2f} us" for s, ms in times.items())
            print(f"{name} K={K} N={N}: {line}; plan S {plan}", flush=True)
            best[name] += per_step * min(times.values())
            # nan when --splits leaves out the split the plan picks
            planned[name] += per_step * times.get(plan, math.nan)
        if args.parent:
            same = [s for s in splits if ("base", s) in bits
                    and torch.equal(bits["base", s], bits["parent", s])]
            if len(same) != sum(("base", s) in bits for s in splits):
                raise SystemExit(f"K1 differs from the parent's at K={K} N={N}")
            print(f"K1 bit-identical to the parent's at K={K} N={N}, splits {same}", flush=True)
        del ws, pick
    print(f"torch.matmul(bf16 W): {library:.4f} ms a decode step", flush=True)
    for name in libs:
        print(f"{name} ({variants[name] or 'as is'}): {planned[name]:.4f} ms a decode step with "
              f"q8_plan's splits, {best[name]:.4f} ms with the best split of each shape",
              flush=True)
    x = torch.randn((64, 4096), generator=gen, device=dev).to(torch.bfloat16)
    q, s = Q.quantize_int8(torch.randn((4096, 4096), generator=gen, device=dev))
    wb = Q.dequantize_int8(q, s, torch.bfloat16)
    out = torch.empty((64, 4096), dtype=torch.bfloat16, device=dev)
    bare = {name: host_us(lambda: fn(x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(),
                                     64, 4096, 4096, 8, stream))
            for name, (fn, _) in libs.items()}
    print(f"host enqueue of one call at 4096 x 4096: ops.quant.int8_matmul "
          f"{host_us(lambda: Q.int8_matmul(x, q, s)):.2f} us, torch.matmul "
          f"{host_us(lambda: torch.matmul(x, wb)):.2f} us; the C call alone "
          + ", ".join(f"{name} {us:.2f} us" for name, us in bare.items()), flush=True)
    if args.check:
        kernels.build(["int8_matmul"])
        cs.report_ptxas(kernels, ["int8_matmul"])
        rec = cs.check_int8_matmul(dev, cs.ITERS)
        print(f"check_int8_matmul: {rec['ms']:.4f} ms a decode step, torch.matmul "
              f"{rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms", flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
