"""Batch decoding with inline confidence capture.

Counterpart of revisionllm_tpu/models/generation.py::generate: prefill once,
then a greedy decode loop that computes each step's softmax entropy and the
chosen token's log-probability in f32, and masks rows after their eos. The
`lax.scan` becomes a Python loop that only enqueues device work (no host
sync inside the loop).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch

from revisionllm_tpu_torch.config import LlamaConfig
from revisionllm_tpu_torch.models import llama

_KV8: Optional[bool] = None


def set_kv8(enabled: Optional[bool]) -> None:
    """Override the int8 prompt-KV switch (None = back to the environment and
    the device default)."""
    global _KV8
    _KV8 = enabled


def _kv8_enabled(device: torch.device) -> bool:
    """Int8 prompt-KV cache: set_kv8, else REVISIONLLM_KV8=0/1, else ON for
    CUDA tensors (serving numerics) and OFF on the CPU (exact parity), as
    JAX defaults it ON for the TPU only."""
    if _KV8 is not None:
        return _KV8
    env = os.environ.get("REVISIONLLM_KV8")
    if env is not None:
        return env == "1"
    return device.type == "cuda"


def generate(
    cfg: LlamaConfig,
    params: Dict[str, Any],
    embeds: torch.Tensor,
    positions: torch.Tensor,
    prompt_lens: torch.Tensor,
    *,
    eos_id: int,
    max_new_tokens: int,
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
) -> Dict[str, torch.Tensor]:
    """Decode `max_new_tokens` for a right-padded batch of spliced prompts.

    embeds [B, T, D], positions [B, T], prompt_lens [B]. Returns tokens,
    entropy, logprob and valid, each [B, G].

    Greedy (temperature 0) matches JAX token for token. temperature > 0
    samples from softmax(logits / temperature) with `generator`; it cannot
    replay JAX's PRNG, so it agrees with JAX by distribution only.

    JAX's scan also runs a decode step after the last token and discards its
    logits; this loop skips that step, which changes no output."""
    B = embeds.shape[0]
    G = max_new_tokens
    prompt_lens = prompt_lens.to(torch.int32)
    logits, prompt_kv = llama.prefill_kv(
        cfg, params, embeds, positions, kv_lens=prompt_lens,
        kv_quant=_kv8_enabled(embeds.device),
    )
    gen_cache = llama.init_gen_cache(cfg, B, G, embeds.dtype, embeds.device)

    done = torch.zeros(B, dtype=torch.bool, device=embeds.device)
    tokens, entropies, logprobs, valids = [], [], [], []
    for g in range(G):
        logits32 = logits.float()
        probs = torch.softmax(logits32, dim=-1)
        entropy = -(probs * torch.log(probs + 1e-10)).sum(dim=-1)
        if temperature > 0.0:
            token = torch.multinomial(
                torch.softmax(logits32 / temperature, dim=-1), 1, generator=generator
            )[:, 0]
        else:
            token = torch.argmax(logits32, dim=-1)
        logprob = torch.log(probs.gather(-1, token[:, None])[:, 0] + 1e-10)
        valid = ~done
        token_out = torch.where(valid, token, torch.full_like(token, eos_id))
        if g + 1 < G:
            tok_embed = llama.embed_tokens(params, token_out[:, None]).to(embeds.dtype)
            logits, gen_cache = llama.decode_step_split(
                cfg, params, prompt_kv, prompt_lens, gen_cache, g, tok_embed
            )
        done = done | (token_out == eos_id)
        tokens.append(token_out)
        entropies.append(entropy)
        logprobs.append(logprob)
        valids.append(valid)
    return {
        "tokens": torch.stack(tokens, dim=1),
        "entropy": torch.stack(entropies, dim=1),
        "logprob": torch.stack(logprobs, dim=1),
        "valid": torch.stack(valids, dim=1),
    }


def entropy_stats_from_steps(entropy: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """[B, G] per-step entropies + validity -> [B, 4] (max, min, mean, std)."""
    m = valid.float()
    n = m.sum(dim=1).clamp(min=1.0)
    neg_inf = torch.tensor(-3.4e38, dtype=torch.float32, device=entropy.device)
    e_max = torch.where(valid, entropy, neg_inf).amax(dim=1)
    e_min = torch.where(valid, entropy, -neg_inf).amin(dim=1)
    e_mean = (entropy * m).sum(dim=1) / n
    var = (m * (entropy - e_mean[:, None]) ** 2).sum(dim=1) / (n - 1.0).clamp(min=1.0)
    e_std = torch.where(n > 1, torch.sqrt(var), torch.zeros_like(var))
    return torch.stack([e_max, e_min, e_mean, e_std], dim=1)
