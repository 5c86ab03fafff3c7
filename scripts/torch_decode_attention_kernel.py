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
`anowiden`, `anoscore`, `anovalue`) and K3's own `noscale` (no scale
copies), which break the results on purpose to see what a part costs, and
the core's instrument `atime`, which prints the SM
clocks block 0's first attention thread spends waiting for tiles, in score
passes and in value passes over one call. The variant `base` (the sources as they are) always runs.
--parent ROOT adds the variant `parent`, ROOT's own decode_attention.cu
built with ROOT's headers.

Every variant is timed by CUDA events over 20 launches at the kernels
phase's shape (B 64, KH 32, S 318, G 12, prompt lengths 280-318, group 1,
int8 prompt cache) at steps 11 and 0, and at 4096 positions (B 8, S 4084,
G 12, step 11), and must hold the plain version there (relative L2 1e-2
whole, 2e-2 on each (row, head) vector) unless it has a cut. With --check,
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
# (B, KH, S, G, step, lowest prompt length) of each timed case
CASES = ((64, 32, 318, 12, 11, 280), (64, 32, 318, 12, 0, 280), (8, 32, 4084, 12, 11, 4020))


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
                          and i not in phases.ATTN_TIME)
        src = kv.variant_source(SRC.read_text(), consts, K3_CUTS, SRC.name)
        if "atime" in spec.split(","):
            src += phases.ATTN_READ
        out[name] = (src, spec, inc)
    if parent is not None:
        csrc = Path(parent).resolve() / CSRC.relative_to(ROOT)
        out["parent"] = ((csrc / SRC.name).read_text(), "", csrc)
    return out


def inputs(B, KH, S, G, low, dev, seed=5):
    """chip_smoke.check_decode_attention's inputs at one shape (group 1)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    hd = 128
    q = torch.randn((B, KH, 1, hd), generator=gen, device=dev).to(torch.bfloat16)
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
        B, KH, S, G, step, low = case
        x = inputs(B, KH, S, G, low, dev)
        want = DA.decode_attention_plain(*x, step)
        nbytes = (B * KH * 128 * 2 * 2 + int(x[7].sum()) * KH * (128 * 2 + 8)
                  + B * (step + 1) * KH * 128 * 2 * 2 + B * 4)
        bound, _ = cs.bound(nbytes, 4.0 * KH * 128 * (int(x[7].sum()) + B * (step + 1)))
        print(f"B={B} KH={KH} S={S} G={G} step={step}: bound {bound:.4f} ms (bytes)", flush=True)
        for name, lib in libs.items():
            kernels._LIBS["decode_attention"] = lib
            kernels._FNS.pop(("decode_attention", "decode_attn_bf16"), None)
            got = DA.decode_attention(*x, step)
            torch.cuda.synchronize()
            note = "cut"
            if not kv.has_cut(variants[name], {**phases.ATTN_CUTS, **K3_CUTS}):
                view = lambda t: t.reshape(-1, 1, 1, t.shape[-1])  # noqa: E731
                cs.hold(f"  {name}", view(got), view(want))
                note = "held"
            ms = cs.device_ms(lambda: DA.decode_attention(*x, step), cs.ITERS)
            print(f"  {name:10s} ({variants[name] or 'as is'}): {ms:.4f} ms, "
                  f"{bound / ms:.0%} of the bound ({note})", flush=True)
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
