"""Plain float32 reference of DeepSeek-V2's decoder (HF `deepseek_v2`,
modeling_deepseek.py: DeepseekV2Attention with q_lora_rank None,
DeepseekV2YarnRotaryEmbedding, DeepseekV2MLP, MoEGate and DeepseekV2MoE),
for the tests that hold the serving path (models/llama.py, ops/moe.py) to
it. Plain torch operations in f32 over a whole sequence: no kernel, no
cache, no batching tricks, TF32 off.

It reads the serving tree of models/llama.py (`init_params` or the loader's):
int8 matrices are dequantized (the values served), dense ones widened to
f32. Departures from modeling_deepseek.py, none of which changes a result:
- weights are [in, out] and applied as x @ W (HF's nn.Linear holds W^T);
- the router's top-k is taken sorted (HF: sorted=False); the weighted sum
  over a token's experts does not depend on their order;
- experts are computed token by token for the experts each token chose
  (HF's moe_infer sorts them first);
- the causal mask is built here (HF gets it from the model's mask helper).
"""

from __future__ import annotations

import math

import torch


def f32_matmuls() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _w(m) -> torch.Tensor:
    if isinstance(m, dict):
        return m["q8"].float() * m["scale"].float().unsqueeze(-2)
    return m.float()


def _at(tree, i):
    if isinstance(tree, dict):
        return {k: _at(v, i) for k, v in tree.items()}
    return tree[i]


def rms_norm(x, w, eps):
    """DeepseekV2RMSNorm in f32."""
    return w.float() * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def yarn_get_mscale(scale=1.0, mscale=1.0):
    if scale <= 1:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def yarn_inv_freq(dim, base, factor, original_max_position, beta_fast, beta_slow):
    """DeepseekV2YarnRotaryEmbedding._set_cos_sin_cache's inv_freq."""
    def find_correction_dim(num_rotations):
        return (dim * math.log(original_max_position / (num_rotations * 2 * math.pi))) / (
            2 * math.log(base))

    low = max(math.floor(find_correction_dim(beta_fast)), 0)
    high = min(math.ceil(find_correction_dim(beta_slow)), dim - 1)
    freq_extra = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))
    if factor <= 1:
        return freq_extra
    freq_inter = 1.0 / (factor * base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - low) / (high - low), 0, 1)
    inv_freq_mask = 1.0 - ramp
    return freq_inter * (1 - inv_freq_mask) + freq_extra * inv_freq_mask


def _rotate_half(x):
    x1, x2 = x[..., : x.shape[-1] // 2], x[..., x.shape[-1] // 2:]
    return torch.cat((-x2, x1), dim=-1)


def apply_rotary_pos_emb(q, k, cos, sin):
    """modeling_deepseek.py's: the (even, odd) pairs gathered into halves,
    then the half rotation. q [b, h, s, d], cos/sin [b, 1, s, d]."""
    b, h, s, d = q.shape
    q = q.view(b, h, s, d // 2, 2).transpose(4, 3).reshape(b, h, s, d)
    b, h, s, d = k.shape
    k = k.view(b, h, s, d // 2, 2).transpose(4, 3).reshape(b, h, s, d)
    return q * cos + _rotate_half(q) * sin, k * cos + _rotate_half(k) * sin


def attention(cfg, lp, x, pos):
    """DeepseekV2Attention.forward (q_lora_rank None) in f32 over x [B, T, D]."""
    B, T, _ = x.shape
    H, C = cfg.num_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    q = (x @ _w(lp["q_proj"])).view(B, T, H, dn + dr).transpose(1, 2)
    q_nope, q_pe = q[..., :dn], q[..., dn:]
    ckv = x @ _w(lp["kv_a_proj"])
    ckv, k_pe = ckv[..., :C], ckv[..., C:]
    k_pe = k_pe.view(B, T, 1, dr).transpose(1, 2)
    kv = (rms_norm(ckv, lp["kv_a_norm"], cfg.rms_norm_eps) @ _w(lp["kv_b_proj"]))
    kv = kv.view(B, T, H, dn + dv).transpose(1, 2)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    f = cfg.rope_scaling_factor
    inv = yarn_inv_freq(dr, cfg.rope_theta, f, cfg.rope_original_max_position,
                        cfg.yarn_beta_fast, cfg.yarn_beta_slow).to(x.device)
    freqs = pos.float()[..., None] * inv                                    # [B, T, dr / 2]
    emb = torch.cat((freqs, freqs), dim=-1)
    _mscale = yarn_get_mscale(f, cfg.yarn_mscale) / yarn_get_mscale(f, cfg.yarn_mscale_all_dim)
    cos, sin = (emb.cos() * _mscale)[:, None], (emb.sin() * _mscale)[:, None]
    q_pe, k_pe = apply_rotary_pos_emb(q_pe, k_pe, cos, sin)
    qs = torch.cat([q_nope, q_pe], dim=-1)
    ks = torch.cat([k_nope, k_pe.expand(B, H, T, dr)], dim=-1)
    m = yarn_get_mscale(f, cfg.yarn_mscale_all_dim)
    scale = (dn + dr) ** -0.5 * m * m
    s = qs @ ks.transpose(2, 3) * scale
    mask = torch.ones((T, T), dtype=torch.bool, device=x.device).triu(1)
    p = torch.softmax(s.masked_fill(mask, float("-inf")), dim=-1)
    o = (p @ v).transpose(1, 2).reshape(B, T, H * dv)
    return o @ _w(lp["o_proj"])


def mlp(x, gate, up, down):
    """DeepseekV2MLP: down(silu(gate(x)) * up(x))."""
    g = x @ _w(gate)
    return (torch.nn.functional.silu(g) * (x @ _w(up))) @ _w(down)


def moe(cfg, mp, x):
    """DeepseekV2MoE.forward: MoEGate (softmax in f32, greedy top-k), the
    chosen experts' weighted sum, plus the shared experts."""
    B, T, D = x.shape
    h = x.reshape(-1, D)
    scores = torch.softmax(h @ mp["router"].float(), dim=-1)
    # norm_topk_prob false and routed_scaling_factor 1: the weights as they are
    w, idx = torch.topk(scores, cfg.num_experts_per_tok, dim=-1)
    Fm = cfg.moe_intermediate_size
    ex = mp["experts"]
    y = torch.zeros_like(h)
    for t in range(h.shape[0]):
        for j in range(idx.shape[1]):
            e = int(idx[t, j])
            gu = h[t] @ _w(_at(ex["gu"], e))
            y[t] += w[t, j] * ((torch.nn.functional.silu(gu[:Fm]) * gu[Fm:])
                               @ _w(_at(ex["down"], e)))
    y = y + mlp(h, mp["shared_gate"], mp["shared_up"], mp["shared_down"])
    return y.view(B, T, D)


def forward_logits(cfg, params, embeds: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Logits [B, T, V] in f32 of embeds [B, T, D] at positions [B, T]."""
    with torch.no_grad():
        x = embeds.float()
        k = cfg.first_k_dense_replace
        for i in range(cfg.num_layers):
            lp = _at(params["layers"], i)
            x = x + attention(cfg, lp, rms_norm(x, lp["attn_norm"], cfg.rms_norm_eps), positions)
            h = rms_norm(x, lp["mlp_norm"], cfg.rms_norm_eps)
            if i < k:
                d = _at(params["dense"], i)
                x = x + mlp(h, d["gate_proj"], d["up_proj"], d["down_proj"])
            else:
                x = x + moe(cfg, _at(params["moe"], i - k), h)
        x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
        return x @ _w(params["lm_head"])
