"""ReVisionLLM assembly for inference: adapter, splice, then the LM.

Counterpart of revisionllm_tpu/models/revisionllm.py (the inference half):
encode window features into LLM tokens, splice them into the embedding
stream by a host-built plan, and decode with inline confidence. Training
(`forward_train`, `lm_loss`) waits for the training slice.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from revisionllm_tpu_torch.config import AdapterConfig, LlamaConfig
from revisionllm_tpu_torch.models import generation, llama
from revisionllm_tpu_torch.models.adapter import clip_encoder_forward, init_adapter_params
from revisionllm_tpu_torch.models.multimodal import splice_embeds
from revisionllm_tpu_torch.utils.device import resolve_device

Params = Dict[str, Any]


def init_vision_params(
    adapter_cfg: AdapterConfig, seed: int = 1, d_in: int = 768,
    dtype=torch.float32, device=None,
) -> Params:
    """ClipEncoder adapter init from `seed` on `device` (default CUDA).
    `d_in` is kept for JAX's signature: the adapter's width is d_model."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return {"mm_projector": init_adapter_params(adapter_cfg, gen, dtype, device)}


def encode_video(
    adapter_cfg: AdapterConfig,
    vision_params: Params,
    images: torch.Tensor,
    query_feats: Optional[torch.Tensor] = None,
    query_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Frame features [B, T, d], one window per row -> LLM token block
    [B, T, hidden] (temporal) or [B, 1, hidden] (cls). The hierarchy input
    [B, V, T, d] of stage-2 retrieval waits for that slice."""
    return clip_encoder_forward(
        adapter_cfg, vision_params["mm_projector"], images, query_feats, query_valid
    )


def assemble_inputs(
    params: Params,
    plan: Dict[str, torch.Tensor],
    video_tokens: torch.Tensor,
    memory_tokens: Optional[torch.Tensor] = None,
    dtype=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Splice plan + video tokens -> (embeds, positions, lengths)."""
    text_embeds = llama.embed_tokens(params, plan["text_ids"])
    if dtype is not None:
        text_embeds = text_embeds.to(dtype)
    embeds = splice_embeds(text_embeds, plan["kind"], plan["src_idx"], video_tokens, memory_tokens)
    return embeds, plan["positions"], plan["lengths"]


def generate_grounding(
    cfg: LlamaConfig,
    adapter_cfg: AdapterConfig,
    params: Params,
    vision_params: Params,
    plan: Dict[str, torch.Tensor],
    images: torch.Tensor,
    query_feats: Optional[torch.Tensor] = None,
    query_valid: Optional[torch.Tensor] = None,
    memory_tokens: Optional[torch.Tensor] = None,
    *,
    eos_id: int,
    max_new_tokens: int = 32,
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
) -> Dict[str, torch.Tensor]:
    """Full inference call: encode windows -> splice -> batched decode.
    Returns tokens/entropy/logprob/valid [B, G] and entropy_stats [B, 4]."""
    video_tokens = encode_video(adapter_cfg, vision_params, images, query_feats, query_valid)
    embeds, positions, lengths = assemble_inputs(
        params, plan, video_tokens, memory_tokens, dtype=llama.torch_dtype(cfg.dtype)
    )
    out = generation.generate(
        cfg, params, embeds, positions, lengths, eos_id=eos_id,
        max_new_tokens=max_new_tokens, temperature=temperature, generator=generator,
    )
    out["entropy_stats"] = generation.entropy_stats_from_steps(out["entropy"], out["valid"])
    return out
