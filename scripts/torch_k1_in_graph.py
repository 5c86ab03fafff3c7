#!/usr/bin/env python3
"""K1 (int8_matmul) inside the split decode step, run eagerly and replayed
from a CUDA graph, with its programmatic dependent launch on and off: does
K1 run slower in the graph, or does the profiler's K1 interval there also
hold the wait for the kernel ahead of it?

    python3 scripts/torch_k1_in_graph.py [--layers 32] [--steps 5]

Needs one CUDA card and nvcc. On a Vicuna-7B-shaped int8 tree (hidden
4096, FFN 11008, 32 heads: DeepSeek-LLM-7B's widths and K1 shapes) at
batch 64, with a random int8 prompt cache of 302-314 positions padded to
320 and 12 generation slots, step 5 of `llama.decode_step_split` runs four
ways: eagerly (the host enqueues each op as it comes) and replayed from one
CUDA graph captured as models/generation.py `DecodeGraphs` captures it,
each with K1 as built (PDL = 1: `griddepcontrol.wait` and a launch with
programmatic stream serialization) and with a copy of csrc/int8_matmul.cu
built with PDL = 0 (scripts/kernel_variants.py). For each way, over
`--steps` profiled steps: K1's launches and summed profiler interval a
step; the part of each K1 interval that lies before the end of the kernel
ahead of it on the stream (the programmatic wait, where the launch let K1
start early), summed; what is left; the other kernels' summed interval;
and the step's device interval by CUDA events (median of 20 unprofiled
steps). The graph's logits must equal the eager step's bit for bit with
either build. Prints one JSON line a way, then the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

K1 = re.compile(r"(?<![A-Za-z0-9_])q8_matmul_kernel(?![A-Za-z0-9_])")


def use_k1(kernels, lib):
    """Route every later K1 call through `lib` (a loaded int8_matmul
    library)."""
    kernels._LIBS["int8_matmul"] = lib
    for key in [k for k in kernels._FNS if k[0] == "int8_matmul"]:
        del kernels._FNS[key]


def capture(fn, torch):
    """(graph, its output) of fn captured on a side stream."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin()
        out = fn()
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(stream)
    return graph, out


def interval_ms(fn, torch, n=20):
    """Median device interval of fn over n calls, by CUDA events."""
    times = []
    for _ in range(n):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def k1_split(fn, steps, torch, kernel_events):
    """Over `steps` profiled calls of fn, a step: (K1 launches, K1 summed
    interval us, the part of it before the end of the kernel ahead us,
    the other kernels' summed interval us)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    events = sorted(kernel_events(prof), key=lambda e: e.time_range.start)
    n = k1 = wait = other = 0.0
    for i, e in enumerate(events):
        dur = e.time_range.end - e.time_range.start
        if not K1.search(e.name):
            other += dur
            continue
        n += 1
        k1 += dur
        if i:
            ahead_end = max(p.time_range.end for p in events[max(0, i - 4):i])
            wait += max(0.0, min(ahead_end, e.time_range.end) - e.time_range.start)
    return n / steps, k1 / steps, wait / steps, other / steps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_k1_in_graph: CUDA is not available", file=sys.stderr)
        return 3
    import dataclasses

    import kernel_variants as kv
    from chip_smoke import kernel_events
    from revisionllm_tpu_torch.config import LlamaConfig
    from revisionllm_tpu_torch.models import llama
    from revisionllm_tpu_torch.utils import kernels

    dev = torch.device("cuda")
    kernels.build()
    src = kernels.CSRC / "int8_matmul.cu"
    libs = {"pdl1": kernels.load("int8_matmul")}
    libs.update(kv.build({"pdl0": (kv.variant_source(src.read_text(), "PDL=0", {}, src.name),
                                    "PDL=0", kernels.CSRC)}, ROOT / "build" / "k1_in_graph"))

    cfg = dataclasses.replace(LlamaConfig(), num_layers=args.layers)
    params = llama.init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev, quantize="int8")
    B, S, G, g = 64, 320, 12, 5
    gen = torch.Generator(device=dev).manual_seed(1)
    prompt = {}
    for name, (shape, dt) in llama.prompt_cache_layout(cfg, B, S, True, torch.bfloat16).items():
        if dt == torch.int8:
            prompt[name] = torch.randint(-127, 128, shape, generator=gen, device=dev,
                                         dtype=torch.int8)
        else:
            prompt[name] = (torch.rand(shape, generator=gen, device=dev) * 0.01 + 0.005).to(dt)
    lens = torch.randint(302, 315, (B,), generator=gen, device=dev, dtype=torch.int32)
    cache = llama.init_gen_cache(cfg, B, G, torch.bfloat16, dev)
    tok = (torch.randn((B, 1, cfg.hidden_size), generator=gen, device=dev) * 0.5) \
        .to(torch.bfloat16)

    def step():
        return llama.decode_step_split(cfg, params, prompt, lens, cache, g, tok)[0]

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    ok = True
    for build, lib in libs.items():
        use_k1(kernels, lib)
        for _ in range(3):
            want = step().clone()
        graph, out = capture(step, torch)
        for _ in range(3):
            graph.replay()
        torch.cuda.synchronize()
        same = bool(torch.equal(out, want))
        ok &= same
        for mode, fn in (("eager", step), ("graph", graph.replay)):
            n, k1, wait, other = k1_split(fn, args.steps, torch, kernel_events)
            print(json.dumps({
                "k1": build, "mode": mode, "layers": cfg.num_layers, "k1_launches": n,
                "k1_us": round(k1, 1), "k1_wait_us": round(wait, 1),
                "k1_less_wait_us": round(k1 - wait, 1), "other_kernels_us": round(other, 1),
                "step_ms": round(interval_ms(fn, torch), 4), "graph_equals_eager": same,
                "card": smi}), flush=True)
        del graph, out
    print(smi, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
