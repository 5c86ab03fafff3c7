"""DeepSeek-V2's weights, made from the seed on the device: one generator a
(seed, layer) for each layer's attention, one for its MLP (dense, or the
router, the experts and the shared experts) and one for its norms, so one
layer can be drawn again without the layers before it. The embedding, the
final norm, the lm_head and the adapter are benchlib.weights'.

Shapes ([in, out], the program's layout): q_proj [D, H (nope + rope)],
kv_a_proj [D, C + rope], kv_b_proj [C, H (nope + v)], o_proj [H v, D];
dense gate/up [D, F], down [F, D]; the router [D, E] f32; each expert's gate
and up side by side [E, D, 2 Fm] and its down [E, Fm, D]; the shared
experts' gate/up [D, S Fm] and down [S Fm, D]."""

from __future__ import annotations

import torch

from benchlib.weights import generator


def attention_shapes(dims):
    D, H, C, R = dims["hidden"], dims["heads"], dims["kv_lora"], dims["qk_rope"]
    return (("q_proj", D, H * (dims["qk_nope"] + R)), ("kv_a_proj", D, C + R),
            ("kv_b_proj", C, H * (dims["qk_nope"] + dims["v_head"])),
            ("o_proj", H * dims["v_head"], D))


def _draw(g, shapes, device):
    """{name: f32 [*lead, a, b]} N(0, 1/a), views of one draw."""
    n = sum(torch.Size(s).numel() for _, s in shapes)
    flat = torch.randn(n, generator=g, device=device)
    out, off = {}, 0
    for name, s in shapes:
        k = torch.Size(s).numel()
        out[name] = flat[off: off + k].view(s).mul_(s[-2] ** -0.5)
        off += k
    return out


def layer_attention(dims, seed: int, i: int, device):
    return _draw(generator(seed, f"layer{i}/attention", device),
                 [(n, (a, b)) for n, a, b in attention_shapes(dims)], device)


def is_dense(dims, i: int) -> bool:
    return i < dims["dense_layers"]


def layer_mlp(dims, seed: int, i: int, device):
    """Layer i's MLP: {gate_proj, up_proj, down_proj} for a dense layer;
    {router, gu, down, shared_gate, shared_up, shared_down} for an MoE one."""
    g = generator(seed, f"layer{i}/mlp", device)
    D = dims["hidden"]
    if is_dense(dims, i):
        F = dims["ffn"]
        return _draw(g, [("gate_proj", (D, F)), ("up_proj", (D, F)), ("down_proj", (F, D))],
                     device)
    E, Fm, S = dims["experts"], dims["moe_ffn"], dims["shared"] * dims["moe_ffn"]
    return _draw(g, [("router", (D, E)), ("gu", (E, D, 2 * Fm)), ("down", (E, Fm, D)),
                     ("shared_gate", (D, S)), ("shared_up", (D, S)), ("shared_down", (S, D))],
                 device)


def layer_vectors(dims, seed: int, i: int, device):
    """Layer i's norms, 1 + N(0, 0.1^2) in bfloat16: attn_norm, mlp_norm
    [D] and kv_a_norm [C]."""
    g = generator(seed, f"layer{i}/vectors", device)
    return {n: (1 + 0.1 * torch.randn(w, generator=g, device=device)).to(torch.bfloat16)
            for n, w in (("attn_norm", dims["hidden"]), ("mlp_norm", dims["hidden"]),
                         ("kv_a_norm", dims["kv_lora"]))}
