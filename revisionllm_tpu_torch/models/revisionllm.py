"""ReVisionLLM assembly: adapter, splice, then the LM.

Counterpart of revisionllm_tpu/models/revisionllm.py: encode window features
into LLM tokens, splice them into the embedding stream by a host-built plan,
and either decode with inline confidence (`generate_grounding`) or return
the causal LM loss of a training batch (`forward_train`, `lm_loss`). Both
take `mesh=` for a sharded model (models/llama.py); forward_train then
also splits the batch over the (data, fsdp) axes.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from revisionllm_tpu_torch.config import AdapterConfig, LlamaConfig
from revisionllm_tpu_torch.constants import IGNORE_INDEX
from revisionllm_tpu_torch.models import generation, llama
from revisionllm_tpu_torch.models.adapter import clip_encoder_forward, init_adapter_params
from revisionllm_tpu_torch.models.multimodal import splice_embeds
from revisionllm_tpu_torch.ops.norms import layer_norm
from revisionllm_tpu_torch.parallel.mesh import batch_sharding
from revisionllm_tpu_torch.utils import spans
from revisionllm_tpu_torch.utils.device import resolve_device

Params = Dict[str, Any]

HIERARCHY_CHUNK = 256  # windows per adapter call for the hierarchy input


def init_mlp_projector(gen: torch.Generator, d_in: int, hidden: int, dtype=torch.float32,
                       device=None) -> Params:
    """The plain Linear projector (vtimellm_arch.py:125): w ~ N(0, 1/d_in)
    [d_in, hidden], b zero."""
    w = torch.randn((d_in, hidden), generator=gen, device=device) * d_in ** -0.5
    return {"w": w.to(dtype), "b": torch.zeros((hidden,), dtype=dtype, device=device)}


def init_vision_params(
    adapter_cfg: AdapterConfig, seed: int = 1, d_in: int = 768,
    dtype=torch.float32, device=None,
) -> Params:
    """Vision module init from `seed` on `device` (default CUDA): the mlp
    projector from `d_in` features, or the ClipEncoder adapter (whose width
    is d_model, or hidden_size for cross_attn), with the LayerNorm
    `alternate_ln` over its output in 'alternate' mode (reference
    vtimellm_arch.py:72-73)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    if adapter_cfg.kind == "mlp":
        return {"mm_projector": init_mlp_projector(gen, d_in, adapter_cfg.hidden_size, dtype,
                                                   device)}
    out = {"mm_projector": init_adapter_params(adapter_cfg, gen, dtype, device)}
    if adapter_cfg.feature_mode == "alternate":
        out["alternate_ln"] = {
            "w": torch.ones((adapter_cfg.hidden_size,), dtype=dtype, device=device),
            "b": torch.zeros((adapter_cfg.hidden_size,), dtype=dtype, device=device),
        }
    return out


def encode_video(
    adapter_cfg: AdapterConfig,
    vision_params: Params,
    images: torch.Tensor,
    query_feats: Optional[torch.Tensor] = None,
    query_valid: Optional[torch.Tensor] = None,
    deterministic: bool = True,
    generator: Optional[torch.Generator] = None,
    iteration_step: int = 0,
) -> torch.Tensor:
    """Frame features -> LLM token block. images [B, T, d], one window per
    row -> [B, T, hidden] (temporal) or [B, 1, hidden] (cls); or the
    hierarchy input [B, V, T, d] of stage-2 retrieval, V windows per row ->
    [B, V, hidden], one CLS token per window. 'alternate' mode picks the
    adapter's output by iteration_step's parity and applies `alternate_ln`
    to it (vtimellm_arch.py:146-147).

    The hierarchy input runs as B * V windows, the query features repeated
    V times in place for each row (jnp.repeat on axis 0; Tensor.repeat would
    tile the batch instead), in slices of HIERARCHY_CHUNK windows: the
    adapter's f32 attention scores for a stage-2 batch of 1400 windows would
    take several GB at once. The mlp projector maps every frame to a token."""
    proj = vision_params["mm_projector"]
    if adapter_cfg.kind == "mlp":
        return images.to(proj["w"].dtype) @ proj["w"] + proj["b"]

    def post(toks):
        if adapter_cfg.feature_mode == "alternate" and "alternate_ln" in vision_params:
            ln = vision_params["alternate_ln"]
            return layer_norm(toks, ln["w"], ln["b"])
        return toks

    if images.dim() == 4:
        B, V, T, d = images.shape
        flat = images.reshape(B * V, T, d)
        qf = None if query_feats is None else query_feats.repeat_interleave(V, dim=0)
        qv = None if query_valid is None else query_valid.repeat_interleave(V, dim=0)
        toks = [
            clip_encoder_forward(
                adapter_cfg, proj, flat[i : i + HIERARCHY_CHUNK],
                None if qf is None else qf[i : i + HIERARCHY_CHUNK],
                None if qv is None else qv[i : i + HIERARCHY_CHUNK],
                deterministic, generator, iteration_step,
            )
            for i in range(0, B * V, HIERARCHY_CHUNK)
        ]
        return post(torch.cat(toks, dim=0).reshape(B, V, -1))
    return post(clip_encoder_forward(
        adapter_cfg, proj, images, query_feats, query_valid, deterministic, generator,
        iteration_step,
    ))


def assemble_inputs(
    params: Params,
    plan: Dict[str, torch.Tensor],
    video_tokens: torch.Tensor,
    memory_tokens: Optional[torch.Tensor] = None,
    dtype=None,
    mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Splice plan + video tokens -> (embeds, positions, lengths)."""
    text_embeds = llama.embed_tokens(params, plan["text_ids"], mesh)
    if dtype is not None:
        text_embeds = text_embeds.to(dtype)
    embeds = splice_embeds(text_embeds, plan["kind"], plan["src_idx"], video_tokens, memory_tokens)
    return embeds, plan["positions"], plan["lengths"]


def supervised_count(labels: torch.Tensor, ignore_index: int = IGNORE_INDEX) -> torch.Tensor:
    """The positions lm_loss averages over: shifted labels not ignored."""
    return (labels[:, 1:].long() != ignore_index).sum()


def lm_loss(logits: torch.Tensor, labels: torch.Tensor, ignore_index: int = IGNORE_INDEX,
            count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Shifted causal cross-entropy in f32, mean over supervised positions
    (the HF CausalLM loss the reference trains with). `count` replaces this
    batch's own count of them (a rank's rows of a larger batch divide by
    the whole batch's, so the ranks' losses sum to its mean)."""
    shift_logits = logits[:, :-1].float()
    shift_labels = labels[:, 1:].long()
    mask = shift_labels != ignore_index
    logp = torch.log_softmax(shift_logits, dim=-1)
    token_lp = torch.gather(logp, -1, shift_labels.clamp(min=0)[..., None])[..., 0]
    total = torch.where(mask, -token_lp, torch.zeros_like(token_lp)).sum()
    return total / (mask.sum() if count is None else count).clamp(min=1)


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
    iteration_step: int = 0,
    mesh=None,
) -> torch.Tensor:
    """One training forward -> scalar LM loss: encode the windows, splice,
    run the backbone with LoRA and the differentiable attention, LM head in
    f32, shifted CE over the plan's labels (reference vtimellm_llama.py:38-90).
    iteration_step selects the 'alternate' adapter's output (encode_video).

    mesh: the inputs are the whole batch, `params` this rank's shards. The
    adapter runs on the whole batch, so its dropout draws the one-process
    noise from `generator`; this rank keeps its rows of the (data, fsdp)
    split and returns their share of the whole batch's mean, so the ranks'
    losses (and gradients) sum to the one-process ones. The batch must
    split evenly (ValueError)."""
    video_tokens = encode_video(
        adapter_cfg, vision_params, images, query_feats, query_valid, deterministic, generator,
        iteration_step,
    )
    count = None
    shard = batch_sharding(mesh)
    if shard.n > 1:
        B = images.shape[0]
        if B % shard.n:
            raise ValueError(f"a batch of {B} does not split over the mesh's {shard.n} "
                             f"(data, fsdp) ranks")
        count = supervised_count(plan["labels"])
        plan = {k: shard.local(v, B) for k, v in plan.items()}
        video_tokens = shard.local(video_tokens, B)
        if memory_tokens is not None:
            memory_tokens = shard.local(memory_tokens, B)
    embeds, positions, lengths = assemble_inputs(
        params, plan, video_tokens, memory_tokens, dtype=llama.torch_dtype(cfg.dtype), mesh=mesh
    )
    hidden = llama.forward_hidden(
        cfg, params, embeds, positions, kv_lens=lengths, lora=lora, lora_scale=lora_scale,
        trainable=True, remat=remat, mesh=mesh,
    )
    logits = llama.logits_from_hidden(params, hidden, mesh)
    return lm_loss(logits, plan["labels"], count=count)


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
    shared_prefix_len: int = 0,
    mesh=None,
) -> Dict[str, torch.Tensor]:
    """Full inference call: encode windows -> splice -> batched decode.
    Returns tokens/entropy/logprob/valid [B, G] and entropy_stats [B, 4].
    `shared_prefix_len` marks the leading tokens every row shares, which
    the prefill then runs once (generation.generate). mesh: `params` are
    this rank's shards; the rows are the ones this rank was given. Spans
    `model.adapter` and `model.splice` (utils/spans.py) time the first two
    on both clocks; `generate` opens its own."""
    with spans.span("model.adapter", device=images.device):
        video_tokens = encode_video(adapter_cfg, vision_params, images, query_feats, query_valid)
    with spans.span("model.splice", device=images.device):
        embeds, positions, lengths = assemble_inputs(
            params, plan, video_tokens, memory_tokens, dtype=llama.torch_dtype(cfg.dtype),
            mesh=mesh
        )
    out = generation.generate(
        cfg, params, embeds, positions, lengths, eos_id=eos_id,
        max_new_tokens=max_new_tokens, temperature=temperature, generator=generator,
        shared_prefix_len=shared_prefix_len, mesh=mesh,
    )
    out["entropy_stats"] = generation.entropy_stats_from_steps(out["entropy"], out["valid"])
    return out
