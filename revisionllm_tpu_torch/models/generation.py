"""Batch decoding with inline confidence capture.

Counterpart of revisionllm_tpu/models/generation.py::generate: prefill once,
then a greedy decode loop that computes each step's softmax entropy and the
chosen token's log-probability in f32, and masks rows after their eos. The
`lax.scan` becomes a Python loop that only enqueues device work (no host
sync inside the loop). With REVISIONLLM_MEGAKERNEL=1 (or set_megakernel)
each decode step is one ops.decode_step launch (row 9 on the card), then the
final norm and the lm_head, wherever JAX takes that path (generation.py:
165-172). A tree packed by ops.decode_serve.pack_serving_weights takes the
serving layout instead (generation.py:131-219): the full prefill writes the
unified int8 KV slab (a shared-prefix prefill's split cache is repacked into
it), and each step is one ops.decode_serve launch (row 10 on the card), then
the final norm and the lm_head; REVISIONLLM_SERVE=0 (or set_serve(False))
sends the packed tree through decode_step_split instead. Every other step is
llama.decode_step_split. `generate_stream` yields one greedy token a step
for interactive use (the streaming chat).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Iterator, Optional

import torch

from revisionllm_tpu_torch.config import LlamaConfig
from revisionllm_tpu_torch.models import llama
from revisionllm_tpu_torch.ops import decode_serve as DSV
from revisionllm_tpu_torch.ops import decode_step as DS
from revisionllm_tpu_torch.ops.norms import rms_norm
from revisionllm_tpu_torch.ops.rope import rope_angles

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


_MEGAKERNEL: Optional[bool] = None


def set_megakernel(enabled: Optional[bool]) -> None:
    """Override the megakernel switch (None = back to the environment)."""
    global _MEGAKERNEL
    _MEGAKERNEL = enabled


def _megakernel_enabled() -> bool:
    """The fused whole-step decode (ops/decode_step.py): set_megakernel,
    else REVISIONLLM_MEGAKERNEL=1; off by default, as in JAX. It also needs
    the int8 tree and KV8 (`generate` checks)."""
    if _MEGAKERNEL is not None:
        return _MEGAKERNEL
    return os.environ.get("REVISIONLLM_MEGAKERNEL", "0") == "1"


_SERVE: Optional[bool] = None


def set_serve(enabled: Optional[bool]) -> None:
    """Override the serving-layout switch (None = back to the environment)."""
    global _SERVE
    _SERVE = enabled


def _serve_enabled() -> Optional[bool]:
    """The serving-layout decode (ops/decode_serve.py): set_serve, else
    REVISIONLLM_SERVE=0/1, else None, which follows the weight layout: a
    packed tree decodes through it, a standard tree cannot (JAX's
    generation.py:85-98). It also needs KV8 (`generate` checks)."""
    if _SERVE is not None:
        return _SERVE
    env = os.environ.get("REVISIONLLM_SERVE")
    return None if env is None else env == "1"


def decode_step_serve(cfg: LlamaConfig, params: Dict[str, Any], slab: Dict[str, torch.Tensor],
                      s0: int, prompt_lens: torch.Tensor, step: int,
                      token_embeds: torch.Tensor) -> torch.Tensor:
    """One serving-layout decode step (JAX's generate, generation.py:
    207-228): the rope angles at prompt_lens + step, one ops.decode_serve
    call over the packed layers and the slab (which gets this step's k/v at
    s0 + step), the final norm and the lm_head. token_embeds [B, 1, D];
    returns logits [B, V] f32."""
    cos, sin = rope_angles((prompt_lens + step)[:, None], cfg.head_dim, cfg.rope_theta)
    hidden, _ = DSV.decode_step_serve(params["layers"], slab, prompt_lens, step,
                                      token_embeds[:, 0], cos[:, 0], sin[:, 0], s0,
                                      eps=cfg.rms_norm_eps)
    h = rms_norm(hidden[:, None, :], params["final_norm"], cfg.rms_norm_eps)
    return llama.logits_from_hidden(params, h[:, 0])


def decode_step_mega(cfg: LlamaConfig, params: Dict[str, Any], pkv: Dict[str, torch.Tensor],
                     prompt_lens: torch.Tensor, gen_cache: torch.Tensor, step: int,
                     token_embeds: torch.Tensor) -> torch.Tensor:
    """One megakernel decode step (JAX's generate, generation.py:207-228):
    the rope angles at prompt_lens + step, one ops.decode_step call over
    the packed prompt cache (gen_cache [L, 2, B, KH, Gp, hd] gets this
    step's k/v), the final norm and the lm_head. token_embeds [B, 1, D];
    returns logits [B, V] f32."""
    cos, sin = rope_angles((prompt_lens + step)[:, None], cfg.head_dim, cfg.rope_theta)
    hidden, _ = DS.decode_step_fused(params, pkv, gen_cache, prompt_lens, step,
                                     token_embeds[:, 0], cos[:, 0], sin[:, 0],
                                     eps=cfg.rms_norm_eps)
    h = rms_norm(hidden[:, None, :], params["final_norm"], cfg.rms_norm_eps)
    return llama.logits_from_hidden(params, h[:, 0])


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
    shared_prefix_len: int = 0,
) -> Dict[str, torch.Tensor]:
    """Decode `max_new_tokens` for a right-padded batch of spliced prompts.

    embeds [B, T, D], positions [B, T], prompt_lens [B]. Returns tokens,
    entropy, logprob and valid, each [B, G]. When every row shares its first
    `shared_prefix_len` embeddings (the engine's window batches do), the
    prefill runs that prefix once (llama.prefill_shared_prefix).

    Greedy (temperature 0) matches JAX token for token. temperature > 0
    samples from softmax(logits / temperature) with `generator`; it cannot
    replay JAX's PRNG, so it agrees with JAX by distribution only.

    JAX's scan also runs a decode step after the last token and discards its
    logits; this loop skips that step, which changes no output."""
    B, T = embeds.shape[:2]
    G = max_new_tokens
    prompt_lens = prompt_lens.to(torch.int32)
    kv_quant = _kv8_enabled(embeds.device)
    lq = params["layers"].get("q_proj")
    serve_intent = (
        isinstance(lq, dict) and "q8c" in lq and _serve_enabled() is not False and kv_quant
        and DSV.supports_serve(cfg, params)
    )
    if shared_prefix_len > 1 and B > 1:
        logits, prompt_kv = llama.prefill_shared_prefix(
            cfg, params, embeds, positions, shared_prefix_len, kv_lens=prompt_lens,
            kv_quant=kv_quant,
        )
    else:
        logits, prompt_kv = llama.prefill_kv(
            cfg, params, embeds, positions, kv_lens=prompt_lens, kv_quant=kv_quant,
            kv_slab_slots=G if serve_intent else None,
        )
    use_mega = (
        not serve_intent and _megakernel_enabled() and kv_quant and "k_scale" in prompt_kv
        and DS.supports_megakernel(cfg, params)
    )
    if serve_intent:
        if "kv" in prompt_kv:
            slab, s0 = prompt_kv, T
        else:  # the shared-prefix prefill's split cache
            slab, s0 = DSV.pack_unified_kv(prompt_kv, G)
        del prompt_kv  # the split cache is not read again
    elif use_mega:
        pkv = DS.pack_prompt_kv(prompt_kv)
        del prompt_kv  # the split cache is not read again
        gen_cache = DS.init_gen_cache(cfg.num_layers, B, cfg.num_kv_heads, cfg.head_dim, G,
                                      embeds.dtype, embeds.device)
    else:
        gen_cache = llama.init_gen_cache(cfg, B, G, embeds.dtype, embeds.device)

    def decode_one(g, tok_embed):
        if serve_intent:
            return decode_step_serve(cfg, params, slab, s0, prompt_lens, g, tok_embed)
        if use_mega:
            return decode_step_mega(cfg, params, pkv, prompt_lens, gen_cache, g, tok_embed)
        return llama.decode_step_split(
            cfg, params, prompt_kv, prompt_lens, gen_cache, g, tok_embed)[0]

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
            logits = decode_one(g, tok_embed)
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


def generate_stream(
    cfg: LlamaConfig,
    params: Dict[str, Any],
    embeds: torch.Tensor,
    positions: torch.Tensor,
    prompt_lens: torch.Tensor,
    *,
    eos_id: int,
    max_new_tokens: int,
) -> Iterator[int]:
    """Greedy decoding as a generator of row 0's token ids, one host
    round-trip a token (JAX's generation.py:280-322; the role of the
    reference demo's TextStreamer). The prefill runs once (prefill_kv, int8
    prompt KV under the same switch as `generate`); every step is one
    llama.decode_step_split over a [L, B, G, KH, hd] generated-token cache.
    It stops at eos without running the step after it, and skips the step
    after the last token, whose logits JAX computes and drops."""
    B = embeds.shape[0]
    G = max_new_tokens
    prompt_lens = prompt_lens.to(torch.int32)
    logits, prompt_kv = llama.prefill_kv(
        cfg, params, embeds, positions, kv_lens=prompt_lens,
        kv_quant=_kv8_enabled(embeds.device),
    )
    gen_cache = llama.init_gen_cache(cfg, B, G, embeds.dtype, embeds.device)
    for g in range(G):
        token = int(torch.argmax(logits[0]))
        if token == eos_id:
            return
        yield token
        if g + 1 == G:
            return
        ids = torch.full((B, 1), token, dtype=torch.long, device=embeds.device)
        tok_embed = llama.embed_tokens(params, ids).to(embeds.dtype)
        logits = llama.decode_step_split(cfg, params, prompt_kv, prompt_lens, gen_cache, g,
                                         tok_embed)[0]
