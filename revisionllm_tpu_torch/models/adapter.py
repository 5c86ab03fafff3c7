"""ClipEncoder vision adapter (inference), in PyTorch.

Counterpart of revisionllm_tpu/models/adapter.py: a learned CLS token and a
normalized sine position embedding are prepended to the window's frames;
the optional T2V encoder (clip_adapter_text) lets the frames cross-attend
to the query tokens; a 2-layer post-norm self-attention encoder mixes them;
the output is the CLS token ('cls' / hierarchy), the per-frame tokens
('temporal'), both ('all'), or by the training iteration's parity
('alternate': CLS on even steps, frames on odd ones), projected by
`mm_projector` to the LLM width. Parameters keep JAX's tree ({"w": [in,
out], "b"} linears, lists of layer dicts).

The chapters variant (`cross_attn`) runs the whole adapter at the LLM width
(hidden_size), as JAX's does (revisionllm_tpu/models/adapter.py:77): the
query tokens go through `text_proj` (d_model -> hidden_size), the projector
is the identity, and the frames must already be hidden_size wide (JAX's
broadcast of the CLS token raises for any other width; so does this
module, with a ValueError). The CrossLayer self-attention variants
(`ca_self_attn`: 'performer', 'linformer' or 'self-attn', ops/
linear_attention.py) run on the frames of each T2V layer before
(sa_pos 1) or after (sa_pos 2) its cross-attention, with JAX's norm
placement (its "Known deviation" from the reference CrossLayer, :308-316).
The performer's random `features` are a fixed buffer: detached at use, so
its gradient is zero, as under JAX's stop_gradient.

Training (deterministic=False) applies dropout at every site where JAX
does (revisionllm_tpu/models/adapter.py:141-264): the attention
probabilities, each residual branch and the FFN's hidden layer. Its keep
masks come from an explicit torch.Generator; they cannot replay JAX's PRNG
bits, so the two agree in distribution (keep rate 1 - dropout, kept values
scaled by 1 / (1 - dropout)), not bit for bit, and parity tests run with
dropout 0. The mlp projector is models/revisionllm.py's.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from revisionllm_tpu_torch.config import AdapterConfig
from revisionllm_tpu_torch.ops.linear_attention import (
    linformer_self_attention,
    orthogonal_gaussian,
    performer_self_attention,
)
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


def init_adapter_params(
    cfg: AdapterConfig, gen: torch.Generator, dtype, device: torch.device
) -> Params:
    """Random adapter init from `gen` (xavier linears, normal CLS token), at
    d_model wide, or hidden_size wide for cross_attn (with `text_proj` in
    place of `mm_projector`)."""
    d = cfg.hidden_size if cfg.cross_attn else cfg.d_model
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
        if cfg.ca_self_attn:
            for layer in params["t2v_layers"]:
                layer["sa"] = _init_ca_self_attn(cfg, gen, d, dtype, device)
    if cfg.cross_attn:
        params["text_proj"] = _init_linear(gen, cfg.d_model, cfg.hidden_size, dtype, device)
    else:
        params["mm_projector"] = _init_linear(gen, d, cfg.hidden_size, dtype, device)
        if cfg.projector_init == "zero":
            params["mm_projector"]["w"].zero_()
    return params


def _init_ca_self_attn(cfg: AdapterConfig, gen, d, dtype, device) -> Params:
    """A CrossLayer self-attention variant's parameters (reference
    adapter/cross_attn.py:109-117), each with its own residual LayerNorm:
    linformer one shared kv head "wkv" [d, hd] and `e_proj`
    [max_video_length, linformer_k]; performer and 'self-attn' wk / wv; the
    performer also its f32 random `features` [hd, m], m =
    performer_nb_features or int(hd ln hd)."""
    hd = d // cfg.num_heads
    sa = {
        "wq": _init_linear(gen, d, d, dtype, device),
        "wo": _init_linear(gen, d, d, dtype, device),
        "norm_w": torch.ones((d,), dtype=dtype, device=device),
        "norm_b": torch.zeros((d,), dtype=dtype, device=device),
    }
    if cfg.ca_self_attn == "linformer":
        sa["wkv"] = _init_linear(gen, d, hd, dtype, device)
        e = torch.randn((cfg.max_video_length, cfg.linformer_k), generator=gen, device=device)
        sa["e_proj"] = (e / math.sqrt(cfg.linformer_k)).to(dtype)
    else:
        sa["wk"] = _init_linear(gen, d, d, dtype, device)
        sa["wv"] = _init_linear(gen, d, d, dtype, device)
    if cfg.ca_self_attn == "performer":
        m = cfg.performer_nb_features or int(hd * math.log(hd))
        sa["features"] = orthogonal_gaussian(gen, hd, m, device)
    return sa


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


def _apply_ca_self_attn(cfg: AdapterConfig, layer, src, video_length, rate=0.0, gen=None):
    """frames = norm(frames + dropout(self_attn(frames))) on the video block
    of src (reference cross_attn.py:120-127); CLS and text pass through.
    The performer's features are detached (zero gradient)."""
    sa = layer["sa"]
    video = src[:, 1 : video_length + 1]
    if cfg.ca_self_attn == "performer":
        attn = performer_self_attention(sa, video, cfg.num_heads, sa["features"].detach())
    elif cfg.ca_self_attn == "linformer":
        attn = linformer_self_attention(sa, video, cfg.num_heads, sa["e_proj"])
    else:  # 'self-attn': exact MHA
        attn = _mha(sa, video, video, video, None, cfg.num_heads, rate, gen)
    video = layer_norm(video + dropout(attn, rate, gen), sa["norm_w"], sa["norm_b"])
    return torch.cat([src[:, :1], video, src[:, video_length + 1 :]], dim=1)


def clip_encoder_forward(
    cfg: AdapterConfig,
    params: Params,
    video: torch.Tensor,
    text: Optional[torch.Tensor] = None,
    text_valid: Optional[torch.Tensor] = None,
    deterministic: bool = True,
    generator: Optional[torch.Generator] = None,
    iteration_step: int = 0,
) -> torch.Tensor:
    """video [B, T, d_in] frame features (d_in = d_model, or hidden_size for
    cross_attn); text [B, Lt, d_model] query tokens. Returns [B, 1, hidden]
    (cls / hierarchy), [B, T, hidden] (temporal), [B, 1 + T, hidden] ('all'),
    or by iteration_step's parity ('alternate': even the CLS token, odd the
    frames). deterministic=False applies dropout cfg.dropout with masks drawn
    from `generator` (required then)."""
    if not deterministic and cfg.dropout > 0 and generator is None:
        raise ValueError("training-mode dropout needs a torch.Generator")
    rate, gen = (0.0, None) if deterministic else (cfg.dropout, generator)
    B, T, d = video.shape
    width = params["global_token"].shape[-1]
    if d != width:
        raise ValueError(f"frames of width {d} into an adapter of width {width} (a cross_attn "
                         f"adapter takes hidden_size-wide frames)")
    if cfg.cross_attn and text is not None:
        text = linear(params["text_proj"], text)
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
            # sa_pos 1: self-attention before the cross-attention, 2: between
            # it and the FFN, which always runs last (JAX's norm placement)
            if cfg.ca_self_attn and cfg.sa_pos == 1:
                src_t2v = _apply_ca_self_attn(cfg, layer, src_t2v, T, rate, gen)
            src_t2v = _t2v_cross_part(layer, src_t2v, pos_t2v, T, text_valid.bool(), cfg.num_heads,
                                      rate, gen)
            if cfg.ca_self_attn and cfg.sa_pos == 2:
                src_t2v = _apply_ca_self_attn(cfg, layer, src_t2v, T, rate, gen)
            src_t2v = _t2v_ffn_part(layer, src_t2v, T, rate, gen)
        src = src_t2v[:, : T + 1]

    for layer in params["enc_layers"]:
        src = _encoder_layer_post(layer, src, pos_embed, valid, cfg.num_heads, rate, gen)

    def project(x):
        return x if cfg.cross_attn else linear(params["mm_projector"], x)

    if cfg.feature_mode == "alternate":
        return project(src[:, :1] if iteration_step % 2 == 0 else src[:, 1:])
    if cfg.hierarchy or cfg.feature_mode == "cls":
        return project(src[:, :1])
    if cfg.feature_mode == "temporal":
        return project(src[:, 1:])
    return project(src)
