#!/usr/bin/env python3
"""The bf16 noise floor of chip_smoke.py's chapters compare, on the CPU.

    python3 scripts/torch_chapters_noise.py [WINDOW_TOKENS ...]   # default 20 100

Builds what `chip_smoke.chapters_compare` builds (the 2-layer Vicuna-width
int8 model, the chapters_stage2_100 cross_attn adapter, 8 windows of 32
frames of 4096-d features, all from its seeds), with WINDOW_TOKENS window
tokens a pass in place of the preset's 100, runs the same rows' prefill
once in bf16 and once with the embeddings and the residual stream in f32,
and prints the largest first-step logit difference as a share of the
largest logit: the noise that bf16 alone puts against the compare's 5%
limit, before any kernel runs. CPU only; it times nothing.
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as C  # noqa: E402
from revisionllm_tpu_torch.config import LlamaConfig, get_preset  # noqa: E402
from revisionllm_tpu_torch.constants import QUESTIONS  # noqa: E402
from revisionllm_tpu_torch.eval.engine import GroundingEngine  # noqa: E402
from revisionllm_tpu_torch.models import generation, llama, revisionllm  # noqa: E402
from revisionllm_tpu_torch.models.multimodal import build_splice_plan, stack_plans  # noqa: E402
from revisionllm_tpu_torch.ops import flash_attention, quant  # noqa: E402
from revisionllm_tpu_torch.ops import windows as W  # noqa: E402


def noise(batch: int) -> float:
    """max |bf16 - f32 logits| / max |f32 logits| at `batch` window tokens."""
    cpu = torch.device("cpu")
    wl = get_preset("chapters_stage2_100")
    acfg = wl.adapter.with_hidden(4096)
    ecfg = dataclasses.replace(wl.eval, max_new_tokens=C.CHAPTERS_TOKENS,
                               num_frames=C.CHAPTERS_CPU["num_frames"], batch=batch)
    cfg = LlamaConfig(num_layers=2)
    params = llama.init_params(cfg, seed=0, dtype=torch.bfloat16, device=cpu, quantize=True)
    vision = revisionllm.init_vision_params(acfg, seed=2, dtype=torch.bfloat16, device=cpu)
    movie = C.chapters_movie(C.CHAPTERS_CPU["windows"], ecfg, cfg.hidden_size, seed=9)
    qf = np.random.default_rng(8).standard_normal((25, acfg.d_model), dtype=np.float32)
    eng = GroundingEngine(cfg, acfg, params, vision, C.fake_tokenizer(), ecfg, device=cpu)
    row_idx = eng._stage2_passes(eng._stage2_win_idx(len(movie)), np.random.default_rng(0))[4]
    ids = eng._prompt_ids(C.SENTENCE, QUESTIONS["retrieval"])
    nv = row_idx[0].shape[0]
    plan = {k: torch.as_tensor(v) for k, v in stack_plans(
        [build_splice_plan(ids, nv, len(ids) - 1 + nv + 8)] * len(row_idx)).items()}
    images = W.gather_windows(eng._features_to_device(movie), np.stack(row_idx)).to(torch.bfloat16)
    video = revisionllm.encode_video(acfg, vision, images, *eng._broadcast_query_feats(qf, len(row_idx)))
    out = []
    for dt in (torch.bfloat16, torch.float32):
        p = {**params, "embed": params["embed"].to(dt), "final_norm": params["final_norm"].to(dt),
             "layers": {k: (v.to(dt) if isinstance(v, torch.Tensor) else v)
                        for k, v in params["layers"].items()}}
        embeds, pos, lens = revisionllm.assemble_inputs(p, plan, video.to(dt), dtype=dt)
        out.append(llama.prefill_kv(cfg, p, embeds, pos, kv_lens=lens)[0].float())
    return ((out[0] - out[1]).abs().max() / out[1].abs().max()).item()


def main() -> int:
    quant.set_w8a8(True)
    generation.set_kv8(True)
    flash_attention.set_attn_bf16(False)
    for batch in [int(a) for a in sys.argv[1:]] or [20, 100]:
        print(f"{batch} window tokens a pass: bf16 against f32 first-step logits, max abs "
              f"difference {noise(batch) * 100:.2f}% of the largest (the compare's limit: 5%)",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
