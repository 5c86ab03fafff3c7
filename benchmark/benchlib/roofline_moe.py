"""The yardstick's arithmetic for DeepSeek-V2 (MLA and DeepSeekMoE): the
operations and bytes a stage-1 query needs, counted from the model's sizes
and the query's shapes at the precision the configuration states, and the
bounds of the two grouped expert kernels. Peaks: benchlib.roofline's (the
H100 SXM data sheet, dense, at 700 W), and its 67 TFLOP/s of f32 outside
the tensor cores for the f32 router."""

from __future__ import annotations

from benchlib.roofline import BF16_OPS_PER_S, INT8_OPS_PER_S, adapter_ops, bound_s

F32_OPS_PER_S = 67e12


def attention_params(dims, absorbed: bool) -> int:
    """Weights a token multiplies in one layer's MLA: q_proj, kv_a_proj,
    o_proj, and kv_b_proj decompressed (the prefill) or, absorbed (decode),
    each head's W_uk and W_uv."""
    D, H, C, R = dims["hidden"], dims["heads"], dims["kv_lora"], dims["qk_rope"]
    dn, dv = dims["qk_nope"], dims["v_head"]
    common = D * H * (dn + R) + D * (C + R) + H * dv * D
    return common + (H * (dn * C + C * dv) if absorbed else C * H * (dn + dv))


def expert_params(dims) -> int:
    """One expert's gate, up and down."""
    return 3 * dims["hidden"] * dims["moe_ffn"]


def mlp_params(dims) -> int:
    """Weights a token multiplies in the MLPs of all layers: the dense
    layers' SwiGLU, and in each MoE layer top_k routed experts and the
    shared experts (the router apart)."""
    D, Ld = dims["hidden"], dims["dense_layers"]
    Lm = dims["layers"] - Ld
    return Ld * 3 * D * dims["ffn"] + Lm * (dims["top_k"] + dims["shared"]) * expert_params(dims)


def router_ops(dims) -> int:
    return 2 * (dims["layers"] - dims["dense_layers"]) * dims["hidden"] * dims["experts"]


def query_least_s(dims, acfg, windows: int, live: int, text_tokens: int, frames: int,
                  new_tokens: int) -> float:
    """The least time of one query's model arithmetic: for each of `windows`
    live windows the adapter (bf16), the prefill of its `live` positions
    (int8: MLA decompressed, the dense MLP, 6 routed and the shared experts;
    bf16 causal attention over q/k heads of nope + rope and v heads; the
    router f32), the lm_head at its last position, and new_tokens - 1
    decode steps (bf16: weight-only int8 widens to bf16; MLA absorbed,
    attending the latent (C + R) and reading it back (C) over the prompt
    and the steps so far). Padding counts as no work."""
    D, V, H, L = dims["hidden"], dims["vocab"], dims["heads"], dims["layers"]
    C, R, dn, dv = dims["kv_lora"], dims["qk_rope"], dims["qk_nope"], dims["v_head"]
    int8 = 2 * live * (L * attention_params(dims, False) + mlp_params(dims))
    f32 = live * router_ops(dims)
    bf16 = adapter_ops(acfg, frames, text_tokens, D)
    bf16 += L * 2 * H * (dn + R + dv) * live * (live + 1) / 2      # causal QK^T and PV
    bf16 += 2 * D * V
    for g in range(new_tokens - 1):
        f32 += router_ops(dims)
        bf16 += 2 * (L * attention_params(dims, True) + mlp_params(dims) + D * V)
        bf16 += L * 2 * H * (C + R + C) * (live + g + 1)
    return windows * (int8 / INT8_OPS_PER_S + bf16 / BF16_OPS_PER_S + f32 / F32_OPS_PER_S)


def expert_matrices(dims):
    """(K, N) of the two grouped products of an MoE layer: gate and up side
    by side, then down."""
    D, Fm = dims["hidden"], dims["moe_ffn"]
    return ((D, 2 * Fm), (Fm, D))


def moe_layers(dims) -> int:
    return dims["layers"] - dims["dense_layers"]


def moe_w8a8_bound_s(dims, windows: int, live: int) -> float:
    """The grouped W8A8 GEMMs of one query's prefill: in every MoE layer one
    call a matrix over top_k routed rows a live position (padding rows and
    positions count as no work); each reads its int8 rows and every
    expert's weights once and writes bf16."""
    Rr, E = dims["top_k"] * windows * live, dims["experts"]
    one = sum(bound_s(2 * Rr * K * N, Rr * K + E * K * N + 4 * E * N + 4 * Rr + 2 * Rr * N,
                      INT8_OPS_PER_S) for K, N in expert_matrices(dims))
    return moe_layers(dims) * one


def moe_w8a8_calls(dims) -> int:
    return 2 * moe_layers(dims)


def moe_k1_bound_s(dims, windows: int, counts) -> float:
    """The grouped W8A16 products of one query's decode steps: for each MoE
    layer-step (its routed rows per expert `counts` [E], as the program's
    dispatch counted them) one call a matrix over top_k routed rows a live
    window, each reading the int8 weights and f32 scales of the experts
    some row chose, the rows in bf16, and writing bf16. The rows of a chunk
    route alike (its windows share the prompt and the served tokens), so
    the experts hit are counted, not assumed to be all."""
    Rr = dims["top_k"] * windows
    total = 0.0
    for c in counts:
        hit = int((c > 0).sum())
        total += sum(bound_s(2 * Rr * K * N, hit * K * N + 4 * hit * N + 2 * Rr * K + 2 * Rr * N,
                             BF16_OPS_PER_S) for K, N in expert_matrices(dims))
    return total


def moe_k1_calls(dims, steps: int) -> int:
    return steps * 2 * moe_layers(dims)
