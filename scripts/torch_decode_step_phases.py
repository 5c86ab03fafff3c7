#!/usr/bin/env python3
"""Where the whole-step decode kernels' time goes, phase by phase: row 9
(csrc/decode_step.cu) or row 10 (csrc/decode_serve.cu).

    python3 scripts/torch_decode_step_phases.py [--row 9|10] [--root ROOT] [--spec SPEC ...]

Needs one CUDA GPU and nvcc. For each SPEC (none: the header as it is),
builds the row's source into build/decode_phases/ against an instrumented
copy of revisionllm_tpu_torch/csrc/decode_common.cuh (the layer loop and
phases that rows 9 and 10 share; its attention phase runs the core of
csrc/decode_attn_common.cuh, copied beside it) in which block 0 reads %globaltimer after
every grid barrier, runs one decode step of Vicuna-7B at chip_smoke.py's
kernels-phase shape (32 layers, int8 weights from seed 0, B 64, the stage-1
prompt, a random int8 prompt cache or unified slab, step 11) three times,
and prints the mean time of each of the eight phases of a layer. The
variants build in parallel, one nvcc each. --root ROOT instruments another
checkout's sources instead (a parent unpacked with `git archive`, so that
one call splits both), with this checkout's Python wrappers.

SPEC is a comma-separated list of CONST=VALUE overrides of the header's
constexprs (e.g. CWG=2,STAGES=3, ASTAGES=2 or ATILE=16384) and cuts, which break the
results on purpose to see what a part costs (CUTS below): `nomma` replaces
each wgmma product by one add of its A register, `nowiden` feeds the raw
weight words to the products, `nostore` drops the epilogue's stores of the
partial sums, `nocopy` lets the producer arrive on each stage without
copying a box (no weight reads), `l2` reads every box from the first column
tile of layer 0 (L2 hits instead of device memory), `noslice` skips the
activation slice's copies, `noahead` stops the producer's copies ahead of a
matmul phase (the rings refill from cold after every barrier). The attention
core's cuts (ATTN_CUTS, edits of decode_attn_common.cuh, which K3's probe
scripts/torch_decode_attention_kernel.py uses too): `anocopy` lets the
producer arrive on each ring slot without copying a tile or its scales (no
cache reads), `anowiden` feeds the raw int8 words to the dots in place of
the widened values, `anovalue` skips the value pass's arithmetic (its tiles
still arrive and are released), `anoscore` the score pass's. The instrument
`atime` adds SM clocks of block 0's first attention thread: its waits for
tiles, its score passes and its value passes, a layer.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

import kernel_variants as kv

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
CSRC = ROOT / "revisionllm_tpu_torch" / "csrc"
HEADER = CSRC / "decode_common.cuh"
ROWS = {"9": ("decode_step", "decode_step_fused"), "10": ("decode_serve", "decode_step_serve")}

PHASES = ("rows: residual + norm", "q/k/v products", "attention", "o product",
          "rows: residual + norm", "gate/up products", "silu * up", "down product")
CUTS = {
    "nomma": [("        attn::wgmma_m64n64k16(acc[j], r[b][e][j], attn::k_major(x, q * KG + e), 1);",
               "        acc[j][0][0] += __uint_as_float(r[b][e][j][0]);")],
    "nowiden": [("      wonly::widen<0>(r[b][e], r0, r1);  // k 2t, 2t + 1\n"
                 "      wonly::widen<2>(r[b][e], r8, r9);  // k 2t + 8, 2t + 9\n",
                 "      r[b][e][0][0] = r0;\n      r[b][e][1][0] = r1;\n"
                 "      r[b][e][0][1] = r0 ^ r1;\n      r[b][e][1][1] = r0 + r1;\n"
                 "      r[b][e][0][2] = r8;\n      r[b][e][1][2] = r9;\n"
                 "      r[b][e][0][3] = r8 ^ r9;\n      r[b][e][1][3] = r8 + r9;\n")],
    "nostore": [("      if (8 * n + b < rows) *reinterpret_cast", "      if (rows < 0) *reinterpret_cast")],
    "nocopy": [("  wonly::mbar_arrive_expect(rg.full + slot, (uint32_t)BOX);\n",
                "  wonly::mbar_arrive(rg.full + slot);\n  return;\n")],
    "l2": [("n0 % cw, h.k_begin + kb * BK,\n                          l * (p.N / cw) + n0 / cw,",
            "0, h.k_begin + kb * BK,\n                          0,")],
    "noslice": [("    wonly::mbar_arrive_expect(rg.act + kb, (uint32_t)ACT_BOX);\n",
                 "    wonly::mbar_arrive(rg.act + kb);\n    continue;\n")],
    "noahead": [("      rg.prod->ahead = issue_ahead(a, l + (pi == 3), (pi + 1) & 3, rg);",
                 "      rg.prod->ahead = 0;")],
}
ATTN_HEADER = CSRC / "decode_attn_common.cuh"
ATTN_CUTS = {
    "anocopy": [("          c.issue(item, side, si, p0, min(tp, pl.s[si].n - p0), r.data + (size_t)r.slot * C::TB,\n"
                 "                  r.scl + r.slot * C::SCL, r.full + r.slot);\n",
                 "          wonly::mbar_arrive(r.full + r.slot);\n")],
    "anowiden": [("      v[4 * i + j] = __uint_as_float(__byte_perm(x, 0x4B00u, 0x5440u | j)) - MAGIC;",
                  "      v[4 * i + j] = __uint_as_float(w[i]);")],
    "anoscore": [("      const float* ks = r.scl + r.slot * C::SCL;\n"
                  "      for (int gi = first_group<NW>(warp, dealt); gi < ng; gi += GU * NW) {\n",
                  "      const float* ks = r.scl + r.slot * C::SCL;\n"
                  "      for (int gi = first_group<NW>(warp, dealt); gi < ng; gi += GU * NW) {\n"
                  "        if (ng >= 0) continue;\n")],
    "anovalue": [("      const float* vs = r.scl + r.slot * C::SCL;\n"
                  "      for (int gi = first_group<NW>(warp, dealt); gi < ng; gi += GU * NW) {\n",
                  "      const float* vs = r.scl + r.slot * C::SCL;\n"
                  "      for (int gi = first_group<NW>(warp, dealt); gi < ng; gi += GU * NW) {\n"
                  "        if (ng >= 0) continue;\n")],
}
# an instrument, not a cut: SM clocks of block 0's first attention thread summed
# into g_attn_t (0 the waits for tiles, 1 the score passes, 2 the value passes),
# read back by read_attn_t (ATTN_READ, appended to the source)
ATTN_TIME = {
    "atime": [("namespace dattn {\n",
               "namespace dattn {\n__device__ long long g_attn_t[8];\n"
               "#define ATIME(i, t0) if (blockIdx.x == 0 && threadIdx.x == 0) dattn::g_attn_t[i] += clock64() - (t0)\n"),
              ("      wonly::mbar_wait(r.full + r.slot, r.phase);\n",
               "      const long long tw = clock64();\n      wonly::mbar_wait(r.full + r.slot, r.phase);\n"
               "      ATIME(0, tw);\n"),
              ("  float q[GRP][E], mx[GRP];\n", "  const long long ts = clock64();\n  float q[GRP][E], mx[GRP];\n"),
              ("    if (lane == 0) red_max[warp * GRP + g] = v;\n  }\n",
               "    if (lane == 0) red_max[warp * GRP + g] = v;\n  }\n  ATIME(1, ts);\n"),
              ("  float o[GRP][E], den[GRP];\n", "  const long long ts = clock64();\n  float o[GRP][E], den[GRP];\n"),
              ("    if (lane == 0) red_den[warp * GRP + g] = d;\n  }\n",
               "    if (lane == 0) red_den[warp * GRP + g] = d;\n  }\n  ATIME(2, ts);\n")],
}
# the same instrument in decode_common.cuh's attention phase: 3 the q/k/v
# of an item and the barrier after them, 4 the barrier after the score
# pass, 5 the value pass's end to the barrier after it, 6 the output
COMMON_TIME = {
    "atime": [("    const dattn::Plan pl = src.plan_of(item, plen);\n    team_sync<NW>(team);  // q, k and v of this item; the staged inputs are read\n",
               "    const dattn::Plan pl = src.plan_of(item, plen);\n    team_sync<NW>(team);  // q, k and v of this item; the staged inputs are read\n    ATIME(3, t_item);\n"),
              ("    const int b = item / a.H, h = item % a.H;\n    float* qb = qkv + par * 4 * HD;",
               "    const long long t_item = clock64();\n    const int b = item / a.H, h = item % a.H;\n    float* qb = qkv + par * 4 * HD;"),
              ("    dattn::score_pass<NW>(src, pl, qb, sc, a.nsc, red_max, r, warp);\n    team_sync<NW>(team);",
               "    dattn::score_pass<NW>(src, pl, qb, sc, a.nsc, red_max, r, warp);\n    const long long t_s2 = clock64();\n    team_sync<NW>(team);\n    ATIME(4, t_s2);"),
              ("    asm volatile(\"cp.async.wait_all;\\n\" ::: \"memory\");\n    team_sync<NW>(team);  // the warps' partial outputs",
               "    const long long t_s3 = clock64();\n    asm volatile(\"cp.async.wait_all;\\n\" ::: \"memory\");\n    team_sync<NW>(team);\n    ATIME(5, t_s3);  // the warps' partial outputs"),
              ("      a.act[(size_t)b * a.D + h * HD + ttid] = __float2bfloat16_rn(o / den);\n    }\n",
               "      a.act[(size_t)b * a.D + h * HD + ttid] = __float2bfloat16_rn(o / den);\n    }\n    ATIME(6, t_s3);\n")],
}
ATTN_READ = ('\nextern "C" int read_attn_t(void* dst) {\n'
             "  const cudaError_t err = cudaMemcpyFromSymbol(dst, dattn::g_attn_t, sizeof(dattn::g_attn_t));\n"
             "  if (err != cudaSuccess) return (int)err;\n"
             "  const long long zero[8] = {};\n"
             "  return (int)cudaMemcpyToSymbol(dattn::g_attn_t, zero, sizeof(zero));\n}\n")
STAMP = ("{ if (blockIdx.x == 0 && threadIdx.x == 0) { unsigned long long t; "
         "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t)); g_clocks[ns] = clock64(); "
         "g_stamps[ns++] = t; } }")


def split_spec(spec: str):
    """(SPEC's items for decode_common.cuh, its attention-core edits); the
    instrument `atime` edits both."""
    items = [i for i in spec.split(",") if i]
    core = {**ATTN_CUTS, **ATTN_TIME}
    return (",".join(i for i in items if i not in ATTN_CUTS),
            ",".join(i for i in items if i in core))


def attn_core(spec: str, csrc: Path = CSRC) -> str:
    """`csrc`'s decode_attn_common.cuh with SPEC's attention cuts and
    instrument applied."""
    return kv.variant_source((csrc / ATTN_HEADER.name).read_text(), split_spec(spec)[1],
                             {**ATTN_CUTS, **ATTN_TIME}, ATTN_HEADER.name)


def instrumented(row: str, spec: str, csrc: Path = CSRC):
    """(the instrumented decode_common.cuh of `csrc` with SPEC applied, the
    row's source with read_stamps); attn_core applies SPEC's attention cuts."""
    src = kv.variant_source((csrc / HEADER.name).read_text(), split_spec(spec)[0],
                            {**CUTS, **COMMON_TIME}, HEADER.name)
    src = src.replace("namespace {\n", "__device__ unsigned long long g_stamps[2048];\n"
                      "__device__ long long g_clocks[2048];\nnamespace {\n", 1)
    head, sig, body = re.split(r"(step_kernel\([^)]*\) \{)", src, 1)
    body = body.replace("cg::grid_group grid = cg::this_grid();",
                        "cg::grid_group grid = cg::this_grid();\n  int ns = 0;\n  " + STAMP, 1)
    body = body.replace("grid.sync();", "grid.sync(); " + STAMP)
    return (head + sig + body,
            (csrc / f"{ROWS[row][0]}.cu").read_text()
            + (ATTN_READ if "atime" in spec.split(",") else "")
            + '\nextern "C" int read_stamps(void* dst, void* clocks) {\n'
              "  cudaError_t err = cudaMemcpyFromSymbol(dst, g_stamps, sizeof(g_stamps));\n"
              "  if (err != cudaSuccess) return (int)err;\n"
              "  return (int)cudaMemcpyFromSymbol(clocks, g_clocks, sizeof(g_clocks));\n}\n")


def build(row: str, specs, csrc: Path = CSRC):
    """{spec: ctypes.CDLL} of the instrumented row, one directory and one
    nvcc a spec, all started together; prints each one's ptxas registers,
    spills and wgmma warnings."""
    from revisionllm_tpu_torch.utils import kernels

    procs = {}
    for i, spec in enumerate(specs):
        work = kernels.BUILD_DIR.parent / "decode_phases" / f"row{row}_{i}"
        work.mkdir(parents=True, exist_ok=True)
        header, src_text = instrumented(row, spec, csrc)
        for extra in csrc.glob("*.cuh"):
            (work / extra.name).write_text(extra.read_text())
        (work / "decode_common.cuh").write_text(header)
        if (csrc / ATTN_HEADER.name).exists():
            (work / ATTN_HEADER.name).write_text(attn_core(spec, csrc))
        cu = work / f"{ROWS[row][0]}.cu"
        cu.write_text(src_text)
        procs[spec] = (subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(cu.with_suffix(".so")), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), cu)
    libs = {}
    for spec, (proc, cu) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"row {row} {spec or 'as is'}: nvcc failed\n{log}")
        print(f"# row {row} {spec or 'as is'}: registers {re.findall(r'Used (\d+) registers', log)}"
              f", spill stores {re.findall(r'(\d+) bytes spill stores', log)}", flush=True)
        for line in log.splitlines():
            if "wgmma" in line or "Performance" in line:
                print(f"#   {line.strip()}", flush=True)
        libs[spec] = ctypes.CDLL(str(cu.with_suffix(".so")))
    return libs


def step_inputs(row: str, dev):
    """(the row's wrapper, its arguments, its keyword arguments, L) at
    chip_smoke.py's kernels-phase shape."""
    import torch

    import chip_smoke as cs
    from revisionllm_tpu_torch.config import LlamaConfig
    from revisionllm_tpu_torch.models import llama
    from revisionllm_tpu_torch.ops import decode_serve as DSV
    from revisionllm_tpu_torch.ops import decode_step as DS
    from revisionllm_tpu_torch.ops.rope import rope_angles

    cfg = LlamaConfig()
    L, H, hd = cfg.num_layers, cfg.num_heads, cfg.head_dim
    _, T, live = cs.prompt_geometry("mad_grounding", 250, 12)
    B, G = 64, 12
    params = llama.init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev, quantize=True)
    kw = {"eps": cfg.rms_norm_eps}
    if row == "10":
        packed, slab, args = cs.serve_inputs(cfg, params, B, T, live, G, dev)
        return DSV.decode_step_serve, (packed, slab, *args), kw, L
    step = G - 1
    gen = torch.Generator(device=dev).manual_seed(16)
    lens = torch.randint(live - 20, live + 1, (B,), generator=gen, device=dev, dtype=torch.int32)
    x = params["embed"][torch.randint(3, cfg.vocab_size, (B,), generator=gen, device=dev)]
    pkv = {"kv": torch.randint(-127, 128, (L, B, 2, H, T, hd), generator=gen, device=dev,
                               dtype=torch.int8),
           "kvsc": torch.rand((L, B, 2, H, T), generator=gen, device=dev) * 0.02 + 0.005}
    genkv = (torch.randn((L, 2, B, H, 16, hd), generator=gen, device=dev) * 0.5).to(torch.bfloat16)
    cos, sin = (t[:, 0] for t in rope_angles((lens + step)[:, None], hd, cfg.rope_theta))
    return DS.decode_step_fused, (params, pkv, genkv, lens, step, x, cos, sin), kw, L


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--row", choices=tuple(ROWS), default="9")
    ap.add_argument("--root", type=Path, default=ROOT,
                    help="the checkout whose sources to instrument")
    ap.add_argument("--spec", action="append", default=[],
                    help="CONST=VALUE overrides and cuts: " + ", ".join([*CUTS, *ATTN_CUTS]))
    args = ap.parse_args()
    import torch

    from revisionllm_tpu_torch.utils import kernels

    if not torch.cuda.is_available():
        print("torch_decode_step_phases: CUDA is not available", file=sys.stderr)
        return 3
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    specs = list(dict.fromkeys(args.spec or [""]))
    csrc = args.root.resolve() / CSRC.relative_to(ROOT)
    libs = build(args.row, specs, csrc)
    fn, fargs, fkw, L = step_inputs(args.row, torch.device("cuda"))
    lib_name = ROWS[args.row][0]
    for spec, lib in libs.items():
        kernels._LIBS[lib_name] = lib
        kernels._FNS.pop((lib_name, ROWS[args.row][1]), None)
        lib.read_stamps.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        stamps, clocks = np.zeros(2048, np.uint64), np.zeros(2048, np.int64)
        per, cyc = [], []
        for _ in range(3):
            fn(*fargs, **fkw)
            torch.cuda.synchronize()
            lib.read_stamps(stamps.ctypes.data, clocks.ctypes.data)
            per.append(np.diff(stamps[: 1 + 8 * L].astype(np.int64)).reshape(L, 8) / 1e3)
            cyc.append(np.diff(clocks[: 1 + 8 * L]).reshape(L, 8))
        per, cyc = np.mean(per[1:], axis=0), np.mean(cyc[1:], axis=0)
        mhz = cyc.sum(axis=0) / per.sum(axis=0)  # block 0's SM clock in each phase
        print(f"row {args.row} of {args.root}, {spec or 'as is'}: one decode step {per.sum():.1f} us "
              f"(mean of 2 runs after a warm-up)", flush=True)
        for i, name in enumerate(PHASES):
            print(f"  {name:24s} {per[:, i].mean():8.1f} us a layer, {per[:, i].sum():9.1f} us "
                  f"a step, SM clock {mhz[i]:6.0f} MHz", flush=True)
        mm = per[:, [1, 3, 5, 7]].sum(axis=1).mean()
        print(f"  matmul phases summed   {mm:8.1f} us a layer", flush=True)
        if "atime" in spec.split(","):
            t = np.zeros(8, np.int64)
            lib.read_attn_t.argtypes = [ctypes.c_void_p]
            lib.read_attn_t(t.ctypes.data)
            fn(*fargs, **fkw)
            torch.cuda.synchronize()
            lib.read_attn_t(t.ctypes.data)
            print(f"  attention, block 0's first thread a layer: waits for tiles {t[0] / L:.0f}, "
                  f"score passes {t[1] / L:.0f}, value passes {t[2] / L:.0f}, q/k/v and its "
                  f"barrier {t[3] / L:.0f}, the barrier after the scores {t[4] / L:.0f}, the "
                  f"barrier after the values {t[5] / L:.0f}, it and the output {t[6] / L:.0f} "
                  "clocks", flush=True)
    kernels._LIBS.pop(lib_name, None)
    kernels._FNS.pop((lib_name, ROWS[args.row][1]), None)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
