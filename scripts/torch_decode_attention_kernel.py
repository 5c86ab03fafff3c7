#!/usr/bin/env python3
"""K3 (decode_attention, csrc/decode_attention.cu over the core of
csrc/decode_attn_common.cuh) alone on one CUDA card: its variants timed side
by side at chip_smoke.py's shapes, and chip_smoke.py's own check.

    python3 scripts/torch_decode_attention_kernel.py [--variant NAME=SPEC ...] [--parent ROOT] [--check]

Needs one CUDA GPU and nvcc. Each variant is a copy of decode_attention.cu
and of the core header built into build/k3_probe/, one nvcc each, all in
parallel; its ptxas registers and spills are printed. SPEC is a
comma-separated list of CONST=VALUE overrides of decode_attention.cu's
constexprs (KWARPS attention warps a block, KSTAGES ring slots, KBLOCKS
blocks an SM, KTILE tile bytes; e.g. KBLOCKS=2,KSTAGES=6) and the attention
core's cuts of scripts/torch_decode_step_phases.py (ATTN_CUTS: `anocopy`,
`anowiden`, `anoscore`, `anovalue`), K3's own `noscale` (no scale
copies) and group 16's (G16_CUTS: `g16empty`, `g16nocopy`, `g16nomax`,
`g16nosum`), which break the results on purpose to see what a part costs, and
the core's instrument `atime`, which prints the SM
clocks block 0's first attention thread spends waiting for tiles, in score
passes and in value passes over one call. The variant `base` (the sources as they are) always runs.
--parent ROOT adds the variant `parent`, ROOT's own decode_attention.cu
built with ROOT's headers.

Every variant is timed by CUDA events over 20 launches at the kernels
phase's shape (B 64, KH 32, S 318, G 12, prompt lengths 280-318, group 1,
int8 prompt cache) at steps 11 and 0, and at 4096 positions (B 8, S 4084,
G 12, step 11), and at ChatGLM2's step (group 16: B 8, KH 2 and 1, S 428,
prompt lengths 408-428, G 12, step 11), and must hold the plain version
there (relative L2 1e-2 whole, 2e-2 on each (row, head) vector) unless it
has a cut. With --check,
chip_smoke.check_decode_attention runs on this checkout's kernel (planted
faults, the GQA and bf16-prompt variants, two calls bit-identical, the
4096-position case). Prints the card's name and power limit first and last.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import kernel_variants as kv
import torch_decode_step_phases as phases

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
CSRC = ROOT / "revisionllm_tpu_torch" / "csrc"
SRC = CSRC / "decode_attention.cu"
OUT = ROOT / "build" / "k3_probe"
# K3's own cut: no scale copies (the int8 prompt's scales are stale)
K3_CUTS = {
    "noscale": [("    if (scaled) dattn::tma_load_3d(sdst, &a.tm[6 + side], kh & -SST, p0, b, bar, pol);\n", ""),
                ("                                              + (scaled ? SCL * 4 : 0)));",
                 "));")],
}
# group 16's cuts (decode_attn_kernel_g16): return at once (the launch of
# the clusters alone), no copies, no max exchange (each rank's own max), no
# cluster sum (each rank sums its own share of the outputs alone)
G16_CUTS = {
    "g16empty": [("  const int split = gridDim.x, rank = blockIdx.x, item = blockIdx.y;\n",
                  "  if (a.S >= 0) return;\n"
                  "  const int split = gridDim.x, rank = blockIdx.x, item = blockIdx.y;\n")],
    "g16nocopy": [("    if (li < loads) g16_issue<PT>(", "    if (li < 0) g16_issue<PT>(")],
    "g16nomax": [("  wonly::cluster_sync();  // every rank's max is in\n", ""),
                 ("st_cluster_f1(wonly::cluster_addr(inbox_m + rank * KG16_Q + tid, r), m);",
                  "inbox_m[r * KG16_Q + tid] = m;")],
    "g16nosum": [("  wonly::cluster_sync();  // every rank's outputs and sums are in\n", ""),
                 ("st_cluster_f4(wonly::cluster_addr(inbox + rank * slots + k / split, k % split), s);",
                  "inbox[rank * slots + k / split] = s;"),
                 ("st_cluster_f1(wonly::cluster_addr(inbox_l + rank * KG16_Q + tid, r), s);",
                  "inbox_l[r * KG16_Q + tid] = s;")],
}
K3_CUTS.update(G16_CUTS)
# group 16's instrument: the SM clock of thread 0 of block (0, 0) at each
# mark, read back by read_g16_t (G16_MARKS names the intervals)
_T = "  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) g16_t[{}] = clock64();\n"
_END = "    *reinterpret_cast<uint2*>(a.out + ((size_t)item * KG16_Q + row) * HD + d0) = u;\n  }\n"
G16_TIME = [
    ("namespace {\n\nusing dattn::HD;\n",
     "namespace {\n\nusing dattn::HD;\n__device__ long long g16_t[12];\n"),
    ("  const int split = gridDim.x, rank = blockIdx.x, item = blockIdx.y;\n",
     _T.format(0) + "  const int split = gridDim.x, rank = blockIdx.x, item = blockIdx.y;\n"),
    ("  const int loads = rounds > 1 ? 2 * rounds : rounds;  // g16_issue's\n",
     "  const int loads = rounds > 1 ? 2 * rounds : rounds;  // g16_issue's\n" + _T.format(1)),
    ("  const int ws = warp * KG16_SLICE;  // the warp's slice in a stage\n",
     _T.format(2) + "  const int ws = warp * KG16_SLICE;  // the warp's slice in a stage\n"),
    ("    __syncthreads();  // load rd has landed\n",
     "    __syncthreads();  // load rd has landed\n" + _T.format(3)),
    ("  // the block's max (warps in order) into", _T.format(4) + "  // the block's max (warps in order) into"),
    ("  const float m[2] = {mg[g], mg[g + 8]};\n", "  const float m[2] = {mg[g], mg[g + 8]};\n" + _T.format(5)),
    ("  // the warp's sums over its lanes;", _T.format(6) + "  // the warp's sums over its lanes;"),
    ("  // the block's outputs and sums, its warps'", _T.format(7) + "  // the block's outputs and sums, its warps'"),
    ("  wonly::cluster_sync();  // every rank's outputs and sums are in\n",
     "  wonly::cluster_sync();  // every rank's outputs and sums are in\n" + _T.format(8)),
    (_END + "}", _END + _T.format(9) + "}"),
]
G16_MARKS = ("q and the mask length", "copies issued", "first wait", "pass 0", "max exchange",
             "pass 1", "warps' outputs stored", "block sums pushed, barrier",
             "rank's sums stored")
G16_READ = """
extern "C" int read_g16_t(long long* h) {
  return (int)cudaMemcpyFromSymbol(h, g16_t, sizeof(g16_t));
}
"""
# (B, KH, S, G, step, lowest prompt length, group) of each timed case:
# the stage-1 step (group 1), 4096 positions, ChatGLM2's step (group 16,
# KH 2 and, under tensor parallelism 2, KH 1)
CASES = ((64, 32, 318, 12, 11, 280, 1), (64, 32, 318, 12, 0, 280, 1),
         (8, 32, 4084, 12, 11, 4020, 1), (8, 2, 428, 12, 11, 408, 16),
         (8, 1, 428, 12, 11, 408, 16))


def sources(variants, parent=None):
    """{name: (decode_attention.cu's text, spec, include directory)} for
    kernel_variants.build: each variant's include directory holds the
    headers with the core's cuts applied."""
    out = {}
    for name, spec in variants.items():
        inc = OUT / f"{name}_include"
        inc.mkdir(parents=True, exist_ok=True)
        for header in CSRC.glob("*.cuh"):
            (inc / header.name).write_text(header.read_text())
        (inc / phases.ATTN_HEADER.name).write_text(phases.attn_core(spec))
        consts = ",".join(i for i in spec.split(",") if i and i not in phases.ATTN_CUTS
                          and i not in phases.ATTN_TIME and i != "g16time")
        src = kv.variant_source(SRC.read_text(), consts, K3_CUTS, SRC.name)
        if "atime" in spec.split(","):
            src += phases.ATTN_READ
        if "g16time" in spec.split(","):
            src = kv.variant_source(src, "g16time", {"g16time": G16_TIME}, SRC.name) + G16_READ
        out[name] = (src, spec, inc)
    if parent is not None:
        csrc = Path(parent).resolve() / CSRC.relative_to(ROOT)
        out["parent"] = ((csrc / SRC.name).read_text(), "", csrc)
    return out


def inputs(B, KH, S, G, low, dev, seed=5, group=1):
    """chip_smoke.check_decode_attention's inputs at one shape."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    hd = 128
    q = torch.randn((B, KH, group, hd), generator=gen, device=dev).to(torch.bfloat16)
    pk, pv = (torch.randint(-127, 128, (B, S, KH, hd), generator=gen, device=dev,
                            dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand((B, S, KH), generator=gen, device=dev) * 0.02 + 0.005 for _ in range(2))
    gk, gv = (torch.randn((B, G, KH, hd), generator=gen, device=dev).to(torch.bfloat16)
              for _ in range(2))
    lens = torch.randint(low, S + 1, (B,), generator=gen, device=dev, dtype=torch.int32)
    return q, pk, pv, ks, vs, gk, gv, lens


def attn_times(lib, call):
    """The clocks of the `atime` instrument over one call: tile waits, score
    passes and value passes of block 0's first attention thread."""
    import ctypes

    import numpy as np
    import torch

    t = np.zeros(8, np.int64)
    lib.read_attn_t.argtypes = [ctypes.c_void_p]
    torch.cuda.synchronize()
    lib.read_attn_t(t.ctypes.data)
    call()
    torch.cuda.synchronize()
    lib.read_attn_t(t.ctypes.data)
    return f"waits {t[0]}, score passes {t[1]}, value passes {t[2]} clocks"


def g16_times(lib, call):
    """The clocks of the `g16time` instrument over one call, by interval."""
    import ctypes

    import numpy as np
    import torch

    t = np.zeros(12, np.int64)
    lib.read_g16_t.argtypes = [ctypes.c_void_p]
    torch.cuda.synchronize()
    call()
    torch.cuda.synchronize()
    lib.read_g16_t(t.ctypes.data)
    return ", ".join(f"{m} {t[i + 1] - t[i]}" for i, m in enumerate(G16_MARKS)) + " clocks"


def parent_g16(lib, x, step):
    """A parent's group-16 K3 through its C entry, its scales padded to 4
    heads as its wrapper padded them (the parent's kernel reads boxes of 4)."""
    import ctypes

    import torch
    from revisionllm_tpu_torch.utils import kernels

    q, pk, pv, ks, vs, gk, gv, lens = x
    B, KH, group, hd = q.shape
    ks, vs = (torch.nn.functional.pad(t, (0, -KH % 4)).contiguous() for t in (ks, vs))
    fn = lib.decode_attn_bf16
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
    out = torch.empty_like(q)
    err = fn(q.data_ptr(), pk.data_ptr(), pv.data_ptr(), ks.data_ptr(), vs.data_ptr(),
             gk.data_ptr(), gv.data_ptr(), lens.data_ptr(), out.data_ptr(), B, pk.shape[1],
             gk.shape[1], KH, group, hd, 1, step, hd ** -0.5, kernels.stream_of(q))
    kernels.check_launch("parent decode_attention", err)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=SPEC: overrides and cuts (" + ", ".join(phases.ATTN_CUTS) + ")")
    ap.add_argument("--parent", help="another checkout's root, timed as it is")
    ap.add_argument("--check", action="store_true", help="chip_smoke's check of this kernel")
    args = ap.parse_args()
    import torch

    import chip_smoke as cs
    from revisionllm_tpu_torch.ops import decode_attention as DA
    from revisionllm_tpu_torch.utils import kernels

    if not torch.cuda.is_available():
        print("torch_decode_attention_kernel: CUDA is not available", file=sys.stderr)
        return 3
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    variants = {}
    for item in args.variant:
        name, spec = item.split("=", 1)
        variants[name] = spec
    variants["base"] = ""
    libs = kv.build(sources(variants, args.parent), OUT)
    variants.setdefault("parent", "")
    dev = torch.device("cuda")
    for case in CASES:
        B, KH, S, G, step, low, group = case
        x = inputs(B, KH, S, G, low, dev, group=group)
        want = DA.decode_attention_plain(*x, step)
        nbytes = (B * KH * group * 128 * 2 * 2 + int(x[7].sum()) * KH * (128 * 2 + 8)
                  + B * (step + 1) * KH * 128 * 2 * 2 + B * 4)
        bound, _ = cs.bound(nbytes, 4.0 * KH * group * 128 * (int(x[7].sum()) + B * (step + 1)))
        print(f"B={B} KH={KH} S={S} G={G} step={step} group={group}: bound {bound:.4f} ms "
              f"(bytes)", flush=True)
        for name, lib in libs.items():
            kernels._LIBS["decode_attention"] = lib
            kernels._FNS.pop(("decode_attention", "decode_attn_bf16"), None)
            if name == "parent" and group == 16:
                call = lambda: parent_g16(lib, x, step)  # noqa: E731
            else:
                call = lambda: DA.decode_attention(*x, step)  # noqa: E731
            got = call()
            torch.cuda.synchronize()
            note = "cut"
            # the core's cuts leave group 16 whole, group 16's the core
            cuts = {**(G16_CUTS if group == 16 else phases.ATTN_CUTS),
                    **{k: v for k, v in K3_CUTS.items() if k not in G16_CUTS}}
            if not kv.has_cut(variants[name], cuts):
                view = lambda t: t.reshape(-1, 1, 1, t.shape[-1])  # noqa: E731
                cs.hold(f"  {name}", view(got), view(want))
                note = "held"
            ms = cs.device_ms(call, cs.ITERS)
            print(f"  {name:10s} ({variants[name] or 'as is'}): {ms:.4f} ms, "
                  f"{bound / ms:.0%} of the bound ({note})", flush=True)
            if "g16time" in variants[name].split(",") and group == 16:
                print("    thread 0 of block (0, 0), one call: " + g16_times(lib, call), flush=True)
            if "atime" in variants[name].split(","):
                print("    block 0's first attention thread, one call: " + attn_times(lib, lambda: DA.decode_attention(*x, step)), flush=True)
        del x, want
        torch.cuda.empty_cache()
    kernels._LIBS.pop("decode_attention", None)
    kernels._FNS.pop(("decode_attention", "decode_attn_bf16"), None)
    if args.check:
        rec = cs.check_decode_attention(dev, cs.ITERS)
        print(f"check_decode_attention: {rec}", flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
