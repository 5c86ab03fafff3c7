#!/usr/bin/env python3
"""ChatGLM2-6B's decode step between checkouts on one CUDA card: wall and
busy time a step, and K3's share.

    python3 scripts/torch_glm_step_ab.py ROOT [ROOT ...]    # e.g. PARENT CHANGE CHANGE PARENT

For each root, in the order given, one process builds that checkout's
kernels and runs `chip_smoke.py`'s phase-18 set-up from it (ChatGLM2-6B at
28 layers, int8, q/k/v biases and a 128-position P-tuning prefix from
seeds, 8 prompts of 279-300 tokens, 12 greedy tokens): one warm-up
generate, then 3 timed generates (a decode step's wall: the generate less
its prefill, over 11 steps, median), then one generate and one prefill
under torch.profiler (a step's busy time: their kernel time's difference
over 11 steps, and K3's, the kernels matching `decode_attn_kernel`).
Prints one line a root and the card's name and power limit. Needs one
CUDA card.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path


def measure(root: Path) -> dict:
    """One root's numbers, in this process (root's modules first on the
    path)."""
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as cs
    from revisionllm_tpu_torch.config import LlamaConfig
    from revisionllm_tpu_torch.models import generation, llama, prefix
    from revisionllm_tpu_torch.tokenization_glm import ChatGLMTokenizer
    from revisionllm_tpu_torch.utils import kernels, spm

    kernels.build()
    dev = torch.device("cuda")
    path = Path(os.environ.get("TMPDIR", "/tmp")) / f"glm_ab_{os.getpid()}.model"
    path.write_bytes(spm.build_test_model(cs.GLM_WORDS))
    tok = ChatGLMTokenizer(str(path))
    ids, lens = cs.glm_prompts(tok)
    cfg = LlamaConfig.chatglm2_6b()
    params, pp = cs.glm_model(cfg, dev)
    pkv = prefix.prefix_kv(cfg, pp)
    embeds = llama.embed_tokens(params, ids.to(dev))
    pos = torch.arange(ids.shape[1], device=dev)[None].expand(ids.shape[0], -1)
    lens_d = lens.to(dev)
    G = cs.GLM_TOKENS

    def run():
        return generation.generate(cfg, params, embeds, pos, lens_d, eos_id=tok.eos_token_id,
                                   max_new_tokens=G, prefix_kv=pkv)

    def prefill():
        return llama.prefill_kv(cfg, params, embeds, pos, kv_lens=lens_d, kv_quant=True,
                                prefix_kv=pkv)

    run()
    walls = []
    for _ in range(3):
        _, gen_ms = cs.timed_ms(run)
        _, pre_ms = cs.timed_ms(prefill)
        walls.append((gen_ms - pre_ms) / (G - 1))
    kernels.reset_launches()
    _, gen_busy, gen_ev = cs.profiled(run)
    launches = kernels.LAUNCHES["decode_attention"]
    _, pre_busy, pre_ev = cs.profiled(prefill)
    k3 = sum(e.device_time_total for e in gen_ev if "decode_attn_kernel" in e.name) / 1e3
    path.unlink()
    return {"root": str(root), "wall_ms": statistics.median(walls), "walls": walls,
            "busy_ms": (gen_busy - pre_busy) / (G - 1), "k3_ms": k3 / (G - 1),
            "k3_launches": launches}


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print(json.dumps(measure(Path(sys.argv[2]).resolve())), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("torch_glm_step_ab: CUDA is not available", file=sys.stderr)
        return 3
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    rc = 0
    for i, root in enumerate(sys.argv[1:]):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--one",
                               str(Path(root).resolve())], capture_output=True, text=True,
                              cwd=root)
        if proc.returncode != 0:
            print(f"run {i} ({root}): exit {proc.returncode}\n{proc.stderr[-3000:]}", flush=True)
            rc = 1
            continue
        r = json.loads(proc.stdout.strip().splitlines()[-1])
        print(f"run {i} ({root}): a decode step {r['wall_ms']:.2f} ms wall (median of 3: "
              f"{', '.join(f'{w:.2f}' for w in r['walls'])}), {r['busy_ms']:.3f} ms busy, K3 "
              f"{r['k3_ms']:.4f} ms of it ({r['k3_launches']} launches a generate); "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    print(smi, flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
