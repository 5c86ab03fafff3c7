"""ClipEncoder vision adapter (inference), in PyTorch.

Counterpart of revisionllm_tpu/models/adapter.py: a learned CLS token and a
normalized sine position embedding are prepended to the window's frames;
the optional T2V encoder (clip_adapter_text) lets the frames cross-attend
to the query tokens; a 2-layer post-norm self-attention encoder mixes them;
the output is the CLS token ('cls' / hierarchy) or the per-frame tokens
('temporal'), projected by `mm_projector` to the LLM width. Parameters keep
JAX's tree ({"w": [in, out], "b"} linears, lists of layer dicts).

Training (deterministic=False) applies dropout at every site where JAX
does (revisionllm_tpu/models/adapter.py:141-264): the attention
probabilities, each residual branch and the FFN's hidden layer. Its keep
masks come from an explicit torch.Generator; they cannot replay JAX's PRNG
bits, so the two agree in distribution (keep rate 1 - dropout, kept values
scaled by 1 / (1 - dropout)), not bit for bit, and parity tests run with
dropout 0. The mlp projector is models/revisionllm.py's. The 'alternate'
and 'all' modes, the CrossLayer self-attention variants (ca_self_attn:
performer, linformer) and the chapters text projection (cross_attn) are not
ported yet.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from revisionllm_tpu_torch.config import AdapterConfig
from revisionllm_tpu_torch.ops.norms import layer_norm

Params = Dict[str, Any]


def sine_positions(
    valid_mask: torch.Tensor, num_pos_feats: int, temperature: float = 10000.0,
    normalize: bool = True, scale: Optional[float] = None, eps: float = 1e-6,
) -> torch.Tensor:
    """Normalized 1-D sine embedding. valid_mask [B, L] -> [B, L, F] f32, even
    channels sin, odd channels cos, interleaved."""
    if scale is None:
        scale = 2 * math.pi
    x_embed = torch.cumsum(valid_mask.float(), dim=1)
    if normalize:
        x_embed = x_embed / (x_embed[:, -1:] + eps) * scale
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=valid_mask.device)
    dim_t = temperature ** (2 * torch.floor(dim_t / 2) / num_pos_feats)
    pos = x_embed[:, :, None] / dim_t
    interleaved = torch.stack([torch.sin(pos[:, :, 0::2]), torch.cos(pos[:, :, 1::2])], dim=3)
    return interleaved.reshape(pos.shape[0], pos.shape[1], -1)


def _init_linear(gen, din, dout, dtype, device):
    # xavier-uniform, as the reference's _reset_parameters
    bound = math.sqrt(6.0 / (din + dout))
    w = (torch.rand((din, dout), generator=gen, device=device) * 2 - 1) * bound
    return {"w": w.to(dtype), "b": torch.zeros((dout,), dtype=dtype, device=device)}


def _init_encoder_layer(gen, d, f, dtype, device):
    layer = {name: _init_linear(gen, d, d, dtype, device) for name in ("wq", "wk", "wv", "wo")}
    layer["ffn1"] = _init_linear(gen, d, f, dtype, device)
    layer["ffn2"] = _init_linear(gen, f, d, dtype, device)
    for n in ("norm1", "norm2"):
        layer[f"{n}_w"] = torch.ones((d,), dtype=dtype, device=device)
        layer[f"{n}_b"] = torch.zeros((d,), dtype=dtype, device=device)
    return layer


def _check_cfg(cfg: AdapterConfig) -> None:
    if (cfg.kind != "clip_encoder" or cfg.cross_attn or cfg.ca_self_attn
            or cfg.feature_mode not in ("temporal", "cls")):
        raise NotImplementedError(
            "only the ClipEncoder adapter in 'temporal' or 'cls' mode is ported yet")


def init_adapter_params(
    cfg: AdapterConfig, gen: torch.Generator, dtype, device: torch.device
) -> Params:
    """Random adapter init from `gen` (xavier linears, normal CLS token)."""
    _check_cfg(cfg)
    d = cfg.d_model
    params: Params = {
        "global_token": torch.randn((d,), generator=gen, device=device).to(dtype),
        "global_pos": torch.randn((d,), generator=gen, device=device).to(dtype),
        "enc_layers": [
            _init_encoder_layer(gen, d, cfg.ffn_dim, dtype, device) for _ in range(cfg.num_layers)
        ],
    }
    if cfg.clip_adapter_text:
        params["t2v_layers"] = [
            _init_encoder_layer(gen, d, cfg.ffn_dim, dtype, device) for _ in range(cfg.num_layers)
        ]
    params["mm_projector"] = _init_linear(gen, d, cfg.hidden_size, dtype, device)
    if cfg.projector_init == "zero":
        params["mm_projector"]["w"].zero_()
    return params


def linear(p, x):
    """x @ w + b in the promoted type of x and w, as JAX promotes a bf16
    activation times f32 weights to f32 (torch would refuse the mix)."""
    dt = torch.promote_types(x.dtype, p["w"].dtype)
    return x.to(dt) @ p["w"].to(dt) + p["b"].to(dt)


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout: keep each element with probability 1 - rate (uniform
    draws from `generator` on x's device) and scale kept values by
    1 / (1 - rate). generator=None or rate 0: the identity."""
    if generator is None or rate <= 0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def _mha(layer: Params, q_in, k_in, v_in, key_valid, num_heads: int, rate=0.0, gen=None):
    """Batch-first multi-head attention with key-padding masking, f32 scores;
    dropout on the probabilities when training."""
    B, Lq, d = q_in.shape
    Lk = k_in.shape[1]
    hd = d // num_heads
    q = linear(layer["wq"], q_in).reshape(B, Lq, num_heads, hd)
    k = linear(layer["wk"], k_in).reshape(B, Lk, num_heads, hd)
    v = linear(layer["wv"], v_in).reshape(B, Lk, num_heads, hd)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(hd)
    if key_valid is not None:
        s = torch.where(key_valid[:, None, None, :], s, torch.full_like(s, -2.0e30))
    p = dropout(torch.softmax(s, dim=-1), rate, gen)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return linear(layer["wo"], o.reshape(B, Lq, d).to(q_in.dtype))


def _ffn(layer, x, rate=0.0, gen=None):
    return linear(layer["ffn2"], dropout(torch.relu(linear(layer["ffn1"], x)), rate, gen))


def _encoder_layer_post(layer, src, pos, key_valid, num_heads, rate=0.0, gen=None):
    """Post-norm self-attention layer: q = k = src + pos, v = src;
    residual -> LN -> FFN -> residual -> LN."""
    qk = src + pos
    src = src + dropout(_mha(layer, qk, qk, src, key_valid, num_heads, rate, gen), rate, gen)
    src = layer_norm(src, layer["norm1_w"], layer["norm1_b"])
    src = src + dropout(_ffn(layer, src, rate, gen), rate, gen)
    return layer_norm(src, layer["norm2_w"], layer["norm2_b"])


def _t2v_cross_part(layer, src, pos, video_length, text_valid, num_heads, rate=0.0, gen=None):
    """Cross-attention half of the T2V layer: queries = frames (pos added),
    keys/values = text tokens; CLS and text pass through."""
    pos_src = src + pos
    q = pos_src[:, 1 : video_length + 1]
    k = pos_src[:, video_length + 1 :]
    v = src[:, video_length + 1 :]
    attn = dropout(_mha(layer, q, k, v, text_valid, num_heads, rate, gen), rate, gen)
    src2 = src[:, 1 : video_length + 1] + attn
    return torch.cat([src[:, :1], src2, src[:, video_length + 1 :]], dim=1)


def _t2v_ffn_part(layer, src, video_length, rate=0.0, gen=None):
    """FFN half of the T2V layer on the frames: norm1 -> FFN -> residual -> norm2."""
    src2 = src[:, 1 : video_length + 1]
    src3 = layer_norm(src2, layer["norm1_w"], layer["norm1_b"])
    ff = dropout(_ffn(layer, src3, rate, gen), rate, gen)
    src2 = layer_norm(src2 + ff, layer["norm2_w"], layer["norm2_b"])
    return torch.cat([src[:, :1], src2, src[:, video_length + 1 :]], dim=1)


def clip_encoder_forward(
    cfg: AdapterConfig,
    params: Params,
    video: torch.Tensor,
    text: Optional[torch.Tensor] = None,
    text_valid: Optional[torch.Tensor] = None,
    deterministic: bool = True,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """video [B, T, d_in] frame features; text [B, Lt, d_in] query tokens.
    Returns [B, 1, hidden] (cls / hierarchy) or [B, T, hidden] (temporal).
    deterministic=False applies dropout cfg.dropout with masks drawn from
    `generator` (required then)."""
    _check_cfg(cfg)
    if not deterministic and cfg.dropout > 0 and generator is None:
        raise ValueError("training-mode dropout needs a torch.Generator")
    rate, gen = (0.0, None) if deterministic else (cfg.dropout, generator)
    B, T, d = video.shape
    frame_valid = torch.ones((B, T), dtype=torch.float32, device=video.device)
    pos = sine_positions(frame_valid, d).to(video.dtype)
    glob = params["global_token"].to(video.dtype).expand(B, 1, d)
    glob_pos = params["global_pos"].to(video.dtype).expand(B, 1, d)
    src = torch.cat([glob, video], dim=1)
    pos_embed = torch.cat([glob_pos, pos], dim=1)
    valid = torch.ones((B, 1 + T), dtype=torch.bool, device=video.device)

    if cfg.clip_adapter_text and text is not None:
        if text_valid is None:
            text_valid = torch.ones(text.shape[:2], dtype=torch.bool, device=text.device)
        src_t2v = torch.cat([src, text], dim=1)
        pos_t2v = torch.cat([pos_embed, torch.zeros_like(text)], dim=1)
        for layer in params["t2v_layers"]:
            src_t2v = _t2v_cross_part(layer, src_t2v, pos_t2v, T, text_valid.bool(), cfg.num_heads,
                                      rate, gen)
            src_t2v = _t2v_ffn_part(layer, src_t2v, T, rate, gen)
        src = src_t2v[:, : T + 1]

    for layer in params["enc_layers"]:
        src = _encoder_layer_post(layer, src, pos_embed, valid, cfg.num_heads, rate, gen)

    cls_only = cfg.hierarchy or cfg.feature_mode == "cls"
    return linear(params["mm_projector"], src[:, :1] if cls_only else src[:, 1:])
