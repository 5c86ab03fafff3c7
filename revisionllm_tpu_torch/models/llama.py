"""LLaMA / Vicuna backbone in PyTorch: serving, and training with LoRA.

Counterpart of revisionllm_tpu/models/llama.py: RMSNorm pre-norm, RoPE,
MHA/GQA attention, SwiGLU MLP. Parameters keep JAX's layout, so a tree
converted by models/weights.py runs unchanged: matrices [in, out] stacked on
a leading L axis (dense tensors or {"q8", "scale"} dicts), norms [L, D].
`lax.scan` over layers becomes a Python loop over layer views.

Matmuls go through ops.quant.q8_apply (kernel K1 at M <= 256), prefill
attention through ops.flash_attention.attention (kernel K2 on the card), and
each decode step's attention is one ops.decode_attention launch per layer
(kernel K3). Training (`forward_hidden(trainable=True)`) applies LoRA in
line and takes ops.flash_attention.trainable_attention (the row-4 kernels);
`remat=True` recomputes each layer in the backward
(torch.utils.checkpoint, in place of jax.checkpoint). The P-tuning prefix,
shared-prefix prefill, the serving slab and the ChatGLM2 geometry wait for
later slices.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from revisionllm_tpu_torch.config import LlamaConfig
from revisionllm_tpu_torch.ops.decode_attention import decode_attention
from revisionllm_tpu_torch.ops.flash_attention import attention, trainable_attention
from revisionllm_tpu_torch.ops.norms import rms_norm
from revisionllm_tpu_torch.ops.quant import q8_apply, q8_apply_multi, quantize_int8
from revisionllm_tpu_torch.ops.rope import apply_rope_tables, rope_angles, rope_tables
from revisionllm_tpu_torch.utils.device import resolve_device

Params = Dict[str, Any]

LAYER_MATRICES = {
    "q_proj": ("hidden", "q_out"),
    "k_proj": ("hidden", "kv_out"),
    "v_proj": ("hidden", "kv_out"),
    "o_proj": ("q_out", "hidden"),
    "gate_proj": ("hidden", "ffn"),
    "up_proj": ("hidden", "ffn"),
    "down_proj": ("ffn", "hidden"),
}

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def torch_dtype(name: Union[str, torch.dtype]) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else _DTYPES[name]


def _check_cfg(cfg: LlamaConfig) -> None:
    if cfg.qkv_bias or cfg.rope_interleaved or cfg.rope_fraction != 1.0:
        raise NotImplementedError("the ChatGLM2 geometry is not ported yet")


def _dims(cfg: LlamaConfig) -> Dict[str, int]:
    return {
        "hidden": cfg.hidden_size,
        "q_out": cfg.num_heads * cfg.head_dim,
        "kv_out": cfg.num_kv_heads * cfg.head_dim,
        "ffn": cfg.intermediate_size,
    }


def init_params(
    cfg: LlamaConfig,
    seed: int = 0,
    dtype=None,
    device=None,
    quantize: bool = False,
    quantize_lm_head: bool = True,
) -> Params:
    """Random init (scaled normal) from `seed`, on `device` (default CUDA).

    quantize=True draws one layer's matrix at a time and keeps only its int8
    values and scales, so a 7B tree never holds a full-precision copy; the
    lm_head is quantized too unless quantize_lm_head=False (the training
    base keeps a dense lm_head, as train_cli does), and the embedding keeps
    `dtype`. The numbers
    differ from the JAX package's init (another generator); parity tests
    carry JAX's weights across with models/weights.py instead."""
    device = resolve_device(device)
    dtype = torch_dtype(dtype or cfg.dtype)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    dims = _dims(cfg)
    L = cfg.num_layers

    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=device, dtype=torch.float32) * std

    def matrix(n, din, dout, quantize=quantize):
        # one [din, dout] draw at a time, so quantize=True holds at most one
        # layer's matrix in f32; n=None gives an unstacked matrix
        std = din ** -0.5
        if quantize:
            out = {
                "q8": torch.empty((n or 1, din, dout), dtype=torch.int8, device=device),
                "scale": torch.empty((n or 1, dout), dtype=torch.float32, device=device),
            }
        else:
            out = torch.empty((n or 1, din, dout), dtype=dtype, device=device)
        for i in range(n or 1):
            w = normal((din, dout), std)
            if quantize:
                out["q8"][i], out["scale"][i] = quantize_int8(w)
            else:
                out[i] = w.to(dtype)
        if n is None:
            return {k: v[0] for k, v in out.items()} if quantize else out[0]
        return out

    layers: Params = {}
    for name, (din, dout) in LAYER_MATRICES.items():
        layers[name] = matrix(L, dims[din], dims[dout])
    layers["attn_norm"] = torch.ones((L, cfg.hidden_size), dtype=dtype, device=device)
    layers["mlp_norm"] = torch.ones((L, cfg.hidden_size), dtype=dtype, device=device)
    return {
        "embed": normal((cfg.vocab_size, cfg.hidden_size), 0.02).to(dtype),
        "layers": layers,
        "final_norm": torch.ones((cfg.hidden_size,), dtype=dtype, device=device),
        "lm_head": matrix(None, cfg.hidden_size, cfg.vocab_size, quantize and quantize_lm_head),
    }


def layer_params(params: Params, i: int) -> Params:
    """Views of layer i of the stacked layer tree (no copies)."""
    out = {}
    for name, w in params["layers"].items():
        out[name] = {k: t[i] for k, t in w.items()} if isinstance(w, dict) else w[i]
    return out


def embed_tokens(params: Params, ids: torch.Tensor) -> torch.Tensor:
    """Token ids -> embeddings; negative sentinel ids are clamped to 0."""
    return params["embed"][ids.clamp(min=0).long()]


def _lora_apply(x, w, lora_layer, scale):
    """x @ W (q8_apply) plus scale * (x @ A) @ B. JAX's `x @ a` promotes a
    bf16 activation times the f32 adapter to f32, so the delta is computed
    in the promoted type and cast back to the output's."""
    y = q8_apply(x, w)
    if lora_layer is not None:
        a, b = lora_layer["a"], lora_layer["b"]
        dt = torch.promote_types(x.dtype, a.dtype)
        delta = (x.to(dt) @ a.to(dt)) @ b.to(dt) * scale
        y = y + delta.to(y.dtype)
    return y


def _attention_block(cfg, lp, x, rope, kv_lens, lora_lp=None, lora_scale=0.0, trainable=False):
    B, T, _ = x.shape
    H, KH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if lora_lp is None:
        qm, km, vm = q8_apply_multi(x, (lp["q_proj"], lp["k_proj"], lp["v_proj"]))
    else:
        qm, km, vm = (_lora_apply(x, lp[n], lora_lp.get(n), lora_scale)
                      for n in ("q_proj", "k_proj", "v_proj"))
    q = apply_rope_tables(qm.reshape(B, T, H, hd), *rope)
    k = apply_rope_tables(km.reshape(B, T, KH, hd), *rope)
    v = vm.reshape(B, T, KH, hd)
    if trainable:
        o = trainable_attention(q, k, v, causal=True, kv_lens=kv_lens)
    else:
        o = attention(q, k, v, causal=True, kv_lens=kv_lens)
    o = o.reshape(B, T, H * hd)
    lo = None if lora_lp is None else lora_lp.get("o_proj")
    return _lora_apply(o, lp["o_proj"], lo, lora_scale), k, v


def _mlp_block(lp, x, lora_lp=None, lora_scale=0.0):
    if lora_lp is None:
        g_lin, up = q8_apply_multi(x, (lp["gate_proj"], lp["up_proj"]))
        return q8_apply(F.silu(g_lin) * up, lp["down_proj"])
    g_lin, up = (_lora_apply(x, lp[n], lora_lp.get(n), lora_scale) for n in ("gate_proj", "up_proj"))
    return _lora_apply(F.silu(g_lin) * up, lp["down_proj"], lora_lp.get("down_proj"), lora_scale)


def lora_layer_params(lora: Optional[Params], i: int) -> Optional[Params]:
    """Views of layer i of a LoRA tree (models/lora.py), or None."""
    if lora is None:
        return None
    return {name: {k: t[i] for k, t in mats.items()} for name, mats in lora["layers"].items()}


def _quantize_rows(x: torch.Tensor):
    """absmax-int8 over the last axis: (int8 values, f32 scale with the last
    axis reduced to 1)."""
    # abs and max are exact in x's own type; x / sc promotes to f32
    absmax = x.abs().amax(dim=-1, keepdim=True).float()
    sc = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    return torch.div(x, sc).round_().clamp_(-127, 127).to(torch.int8), sc


def forward_hidden(
    cfg: LlamaConfig,
    params: Params,
    embeds: torch.Tensor,
    positions: torch.Tensor,
    kv_lens: Optional[torch.Tensor] = None,
    return_kv: bool = False,
    kv_quant: bool = False,
    lora: Optional[Params] = None,
    lora_scale: float = 0.0,
    trainable: bool = False,
    remat: bool = False,
):
    """Full-sequence forward. embeds [B, T, D], positions [B, T].

    Returns the final hidden [B, T, D]; with return_kv=True also the
    per-layer cache {"k", "v"} [L, B, T, KH, hd], which kv_quant=True writes
    as int8 plus per-(position, head) scales {"k_scale", "v_scale"}
    [L, B, T, KH] layer by layer, so a full-precision cache never exists.

    Training: `lora` (models/lora.py tree) adds scale * x A B to every
    adapted matmul; trainable=True takes the differentiable attention
    (row-4 kernels on the card); remat=True checkpoints each layer, which is
    exact because the layers draw no random numbers."""
    _check_cfg(cfg)
    if remat and return_kv:
        raise ValueError("remat is for training; it returns no cache")
    B, T, _ = embeds.shape
    L, KH, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    rope = rope_tables(*rope_angles(positions, hd, cfg.rope_theta))
    cache = None
    if return_kv:
        kv_dtype = torch.int8 if kv_quant else embeds.dtype
        shape = (L, B, T, KH, hd)
        cache = {
            "k": torch.empty(shape, dtype=kv_dtype, device=embeds.device),
            "v": torch.empty(shape, dtype=kv_dtype, device=embeds.device),
        }
        if kv_quant:
            cache["k_scale"] = torch.empty(shape[:-1], dtype=torch.float32, device=embeds.device)
            cache["v_scale"] = torch.empty(shape[:-1], dtype=torch.float32, device=embeds.device)
    def layer(x, lp, lora_lp):
        h = rms_norm(x, lp["attn_norm"], cfg.rms_norm_eps)
        attn_out, k, v = _attention_block(cfg, lp, h, rope, kv_lens, lora_lp, lora_scale, trainable)
        x = x + attn_out
        h = rms_norm(x, lp["mlp_norm"], cfg.rms_norm_eps)
        return x + _mlp_block(lp, h, lora_lp, lora_scale), k, v

    x = embeds
    for i in range(L):
        lp = layer_params(params, i)
        lora_lp = lora_layer_params(lora, i)
        if remat:
            x = checkpoint(lambda x, lp=lp, lora_lp=lora_lp: layer(x, lp, lora_lp)[0], x,
                           use_reentrant=False)
            continue
        x, k, v = layer(x, lp, lora_lp)
        if cache is not None:
            if kv_quant:
                for name, t in (("k", k), ("v", v)):
                    tq, ts = _quantize_rows(t)
                    cache[name][i] = tq
                    cache[f"{name}_scale"][i] = ts[..., 0]
            else:
                cache["k"][i] = k
                cache["v"][i] = v
    hidden = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    if return_kv:
        return hidden, cache
    return hidden


def logits_from_hidden(params: Params, hidden: torch.Tensor) -> torch.Tensor:
    """LM head, returned in f32 (decode entropy needs full-precision logits)."""
    return q8_apply(hidden, params["lm_head"]).float()


def prefill_kv(
    cfg: LlamaConfig,
    params: Params,
    embeds: torch.Tensor,
    positions: torch.Tensor,
    kv_lens: Optional[torch.Tensor] = None,
    kv_quant: bool = False,
) -> Tuple[torch.Tensor, Params]:
    """Prefill: (logits at each row's last position [B, V], read-only prompt
    cache {"k", "v"[, "k_scale", "v_scale"]} [L, B, T, KH, hd])."""
    hidden, cache = forward_hidden(
        cfg, params, embeds, positions, kv_lens, return_kv=True, kv_quant=kv_quant
    )
    if kv_lens is None:
        last = hidden[:, -1]
    else:
        idx = (kv_lens.long() - 1).clamp(min=0)
        last = hidden[torch.arange(hidden.shape[0], device=hidden.device), idx]
    return logits_from_hidden(params, last), cache


def init_gen_cache(cfg: LlamaConfig, batch: int, slots: int, dtype, device) -> Params:
    """Zeroed generated-token cache {"k", "v"} [L, B, G, KH, hd]."""
    shape = (cfg.num_layers, batch, slots, cfg.num_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def decode_step_split(
    cfg: LlamaConfig,
    params: Params,
    prompt_kv: Params,
    prompt_lens: torch.Tensor,
    gen_cache: Params,
    step: int,
    token_embeds: torch.Tensor,
    mask_lens: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Params]:
    """One decode step with the split KV layout.

    prompt_kv [L, B, S, KH, hd] stays read-only after prefill; this step's
    k/v land in gen_cache [L, B, G, KH, hd] at slot `step`, written IN PLACE
    (JAX returns an updated copy; the returned dict is the same tensors).
    Attention over [prompt | generated] is one decode_attention call per
    layer. mask_lens: valid prompt positions per row (default prompt_lens).
    Returns (logits [B, V] f32, gen_cache)."""
    _check_cfg(cfg)
    B = token_embeds.shape[0]
    H, KH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    group = H // KH
    positions = (prompt_lens.long() + step)[:, None]
    rope = rope_tables(*rope_angles(positions, hd, cfg.rope_theta))
    if mask_lens is None:
        mask_lens = prompt_lens
    quantized = "k_scale" in prompt_kv

    x = token_embeds
    for i in range(cfg.num_layers):
        lp = layer_params(params, i)
        h = rms_norm(x, lp["attn_norm"], cfg.rms_norm_eps)
        q = apply_rope_tables(q8_apply(h, lp["q_proj"]).reshape(B, 1, H, hd), *rope)
        k = apply_rope_tables(q8_apply(h, lp["k_proj"]).reshape(B, 1, KH, hd), *rope)
        v = q8_apply(h, lp["v_proj"]).reshape(B, 1, KH, hd)
        gk, gv = gen_cache["k"][i], gen_cache["v"][i]
        gk[:, step] = k[:, 0].to(gk.dtype)
        gv[:, step] = v[:, 0].to(gv.dtype)
        o = decode_attention(
            q.reshape(B, KH, group, hd),
            prompt_kv["k"][i], prompt_kv["v"][i],
            prompt_kv["k_scale"][i] if quantized else None,
            prompt_kv["v_scale"][i] if quantized else None,
            gk, gv, mask_lens, step,
        )
        x = x + q8_apply(o.reshape(B, 1, H * hd).to(x.dtype), lp["o_proj"])
        h = rms_norm(x, lp["mlp_norm"], cfg.rms_norm_eps)
        x = x + _mlp_block(lp, h)
    hidden = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return logits_from_hidden(params, hidden[:, 0]), gen_cache


def quantize_prompt_kv(prompt_kv: Params) -> Params:
    """Int8 prompt KV: per-(layer, batch, position, head) absmax over hd."""
    out = {}
    for name in ("k", "v"):
        q, sc = _quantize_rows(prompt_kv[name])
        out[name] = q
        out[f"{name}_scale"] = sc[..., 0]
    return out
