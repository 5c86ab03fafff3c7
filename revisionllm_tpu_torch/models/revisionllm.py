"""ReVisionLLM assembly: adapter, splice, then the LM.

Counterpart of revisionllm_tpu/models/revisionllm.py: encode window features
into LLM tokens, splice them into the embedding stream by a host-built plan,
and either decode with inline confidence (`generate_grounding`) or return
the causal LM loss of a training batch (`forward_train`, `lm_loss`).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from revisionllm_tpu_torch.config import AdapterConfig, LlamaConfig
from revisionllm_tpu_torch.constants import IGNORE_INDEX
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
    deterministic: bool = True,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Frame features [B, T, d], one window per row -> LLM token block
    [B, T, hidden] (temporal) or [B, 1, hidden] (cls). The hierarchy input
    [B, V, T, d] of stage-2 retrieval waits for that slice."""
    return clip_encoder_forward(
        adapter_cfg, vision_params["mm_projector"], images, query_feats, query_valid,
        deterministic, generator,
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


def lm_loss(logits: torch.Tensor, labels: torch.Tensor, ignore_index: int = IGNORE_INDEX) -> torch.Tensor:
    """Shifted causal cross-entropy in f32, mean over supervised positions
    (the HF CausalLM loss the reference trains with)."""
    shift_logits = logits[:, :-1].float()
    shift_labels = labels[:, 1:].long()
    mask = shift_labels != ignore_index
    logp = torch.log_softmax(shift_logits, dim=-1)
    token_lp = torch.gather(logp, -1, shift_labels.clamp(min=0)[..., None])[..., 0]
    total = torch.where(mask, -token_lp, torch.zeros_like(token_lp)).sum()
    return total / mask.sum().clamp(min=1)


def forward_train(
    cfg: LlamaConfig,
    adapter_cfg: AdapterConfig,
    params: Params,
    vision_params: Params,
    plan: Dict[str, torch.Tensor],
    images: torch.Tensor,
    query_feats: Optional[torch.Tensor] = None,
    query_valid: Optional[torch.Tensor] = None,
    memory_tokens: Optional[torch.Tensor] = None,
    lora: Optional[Params] = None,
    lora_scale: float = 0.0,
    deterministic: bool = True,
    generator: Optional[torch.Generator] = None,
    remat: bool = False,
) -> torch.Tensor:
    """One training forward -> scalar LM loss: encode the windows, splice,
    run the backbone with LoRA and the differentiable attention, LM head in
    f32, shifted CE over the plan's labels (reference vtimellm_llama.py:38-90)."""
    video_tokens = encode_video(
        adapter_cfg, vision_params, images, query_feats, query_valid, deterministic, generator
    )
    embeds, positions, lengths = assemble_inputs(
        params, plan, video_tokens, memory_tokens, dtype=llama.torch_dtype(cfg.dtype)
    )
    hidden = llama.forward_hidden(
        cfg, params, embeds, positions, kv_lens=lengths, lora=lora, lora_scale=lora_scale,
        trainable=True, remat=remat,
    )
    logits = llama.logits_from_hidden(params, hidden)
    return lm_loss(logits, plan["labels"])


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
