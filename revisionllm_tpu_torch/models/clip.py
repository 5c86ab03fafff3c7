"""CLIP ViT-L/14 image and text encoders in plain PyTorch.

Counterpart of revisionllm_tpu/models/clip.py (the vendored OpenAI CLIP the
reference extracts features with, revisionllm/data/feature_extraction/clip/
model.py): a pre-norm ViT with a class token and absolute position
embeddings, QuickGELU MLPs, a final LayerNorm and a linear projection; a
causal text transformer pooled at the EOT token. `encode_text` returns both
the per-token features and the pooled EOT feature (reference
clip/model.py:339-352), which is what the query-feature stores hold
(token_features + cls_features).

No Pallas kernel stands behind the JAX module (its attention is plain jnp),
so this one is plain torch ops with the same math: the patch embedding as a
reshape and a matmul, f32 attention scores, the causal mask filled with
-2.0e30. Weights convert from the HF `openai/clip-vit-large-patch14` layout
(convert_hf_clip); the image preprocessing stays on the host in
data/feature_extraction.py.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from revisionllm_tpu_torch.ops.norms import layer_norm

Params = Dict[str, Any]


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def _lin(p: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"] + p["b"]


def _attn(layer: Params, x: torch.Tensor, num_heads: int, causal: bool) -> torch.Tensor:
    B, L, d = x.shape
    hd = d // num_heads
    q = _lin(layer["wq"], x).reshape(B, L, num_heads, hd)
    k = _lin(layer["wk"], x).reshape(B, L, num_heads, hd)
    v = _lin(layer["wv"], x).reshape(B, L, num_heads, hd)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(hd)
    if causal:
        keep = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
        s = torch.where(keep[None, None], s, torch.full_like(s, -2.0e30))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float()).reshape(B, L, d).to(x.dtype)
    return _lin(layer["wo"], o)


def _block(layer: Params, x: torch.Tensor, num_heads: int, causal: bool) -> torch.Tensor:
    h = layer_norm(x, layer["ln1_w"], layer["ln1_b"])
    x = x + _attn(layer, h, num_heads, causal)
    h = layer_norm(x, layer["ln2_w"], layer["ln2_b"])
    return x + _lin(layer["fc2"], quick_gelu(_lin(layer["fc1"], h)))


def encode_image(params: Params, pixels: torch.Tensor) -> torch.Tensor:
    """pixels [B, 3, H, W], normalized -> [B, proj_dim] image features. The
    patch embedding (a strided conv) is a reshape to [B, gh * gw, 3 * P * P]
    in (channel, row, column) order, then a matmul."""
    v = params["visual"]
    B = pixels.shape[0]
    P, heads = v["patch_size"], v["num_heads"]
    x = pixels.to(v["patch_embed"].dtype)
    x = x.reshape(B, 3, x.shape[2] // P, P, x.shape[3] // P, P)
    x = x.permute(0, 2, 4, 1, 3, 5).reshape(B, -1, 3 * P * P)
    x = x @ v["patch_embed"]
    cls = v["class_embed"].to(x.dtype).expand(B, 1, x.shape[-1])
    x = torch.cat([cls, x], dim=1) + v["pos_embed"][None]
    x = layer_norm(x, v["ln_pre_w"], v["ln_pre_b"])
    for layer in v["blocks"]:
        x = _block(layer, x, heads, causal=False)
    x = layer_norm(x[:, 0], v["ln_post_w"], v["ln_post_b"])
    return x @ v["proj"]


def encode_text(params: Params, token_ids: torch.Tensor) -> Dict[str, torch.Tensor]:
    """token_ids [B, 77] -> {last_hidden_state: [B, 77, proj], pooler_output:
    [B, proj]}: the per-token features projected, and the one at argmax(ids)
    (the EOT token), the reference's modified return."""
    t = params["text"]
    heads = t["num_heads"]
    x = t["token_embed"][token_ids.long()]
    x = x + t["pos_embed"][None, : x.shape[1]]
    for layer in t["blocks"]:
        x = _block(layer, x, heads, causal=True)
    x = layer_norm(x, t["ln_final_w"], t["ln_final_b"])
    projected = x @ t["proj"]
    eot = torch.argmax(token_ids, dim=-1)
    pooled = projected[torch.arange(projected.shape[0], device=projected.device), eot]
    return {"last_hidden_state": projected, "pooler_output": pooled}


# ---------------------------------------------------------------------------
# HF weight conversion (host arrays; models/weights.params_from_numpy moves
# them and keeps the geometry as Python ints)
# ---------------------------------------------------------------------------


def _hf_lin(state, prefix, dtype):
    return {"w": state[f"{prefix}.weight"].T.astype(dtype),
            "b": state[f"{prefix}.bias"].astype(dtype)}


def _hf_block(state, prefix, dtype):
    return {
        "wq": _hf_lin(state, f"{prefix}.self_attn.q_proj", dtype),
        "wk": _hf_lin(state, f"{prefix}.self_attn.k_proj", dtype),
        "wv": _hf_lin(state, f"{prefix}.self_attn.v_proj", dtype),
        "wo": _hf_lin(state, f"{prefix}.self_attn.out_proj", dtype),
        "fc1": _hf_lin(state, f"{prefix}.mlp.fc1", dtype),
        "fc2": _hf_lin(state, f"{prefix}.mlp.fc2", dtype),
        "ln1_w": state[f"{prefix}.layer_norm1.weight"].astype(dtype),
        "ln1_b": state[f"{prefix}.layer_norm1.bias"].astype(dtype),
        "ln2_w": state[f"{prefix}.layer_norm2.weight"].astype(dtype),
        "ln2_b": state[f"{prefix}.layer_norm2.bias"].astype(dtype),
    }


def _num_layers(state, tower: str) -> int:
    prefix = f"{tower}.encoder.layers."
    return max(int(k.split(".")[3]) for k in state if k.startswith(prefix)) + 1


def convert_hf_clip(state: Dict[str, np.ndarray], dtype=np.float32) -> Params:
    """HF CLIPModel state dict (numpy) -> the encoders' tree of numpy arrays
    and ints (ViT-L/14 or any size); num_heads = width // 64, as the
    checkpoints have it."""
    patch_w = state["vision_model.embeddings.patch_embedding.weight"]  # [d, 3, P, P]
    d_v, P = patch_w.shape[0], patch_w.shape[-1]
    d_t = state["text_model.embeddings.token_embedding.weight"].shape[1]
    visual = {
        "patch_size": P,
        "num_heads": d_v // 64,
        # conv [d, 3, P, P] -> matmul [3 * P * P, d] in encode_image's order
        "patch_embed": patch_w.reshape(d_v, -1).T.astype(dtype),
        "class_embed": state["vision_model.embeddings.class_embedding"].astype(dtype),
        "pos_embed": state["vision_model.embeddings.position_embedding.weight"].astype(dtype),
        "ln_pre_w": state["vision_model.pre_layrnorm.weight"].astype(dtype),
        "ln_pre_b": state["vision_model.pre_layrnorm.bias"].astype(dtype),
        "ln_post_w": state["vision_model.post_layernorm.weight"].astype(dtype),
        "ln_post_b": state["vision_model.post_layernorm.bias"].astype(dtype),
        "proj": state["visual_projection.weight"].T.astype(dtype),
        "blocks": [_hf_block(state, f"vision_model.encoder.layers.{i}", dtype)
                   for i in range(_num_layers(state, "vision_model"))],
    }
    text = {
        "num_heads": d_t // 64,
        "token_embed": state["text_model.embeddings.token_embedding.weight"].astype(dtype),
        "pos_embed": state["text_model.embeddings.position_embedding.weight"].astype(dtype),
        "ln_final_w": state["text_model.final_layer_norm.weight"].astype(dtype),
        "ln_final_b": state["text_model.final_layer_norm.bias"].astype(dtype),
        "proj": state["text_projection.weight"].T.astype(dtype),
        "blocks": [_hf_block(state, f"text_model.encoder.layers.{i}", dtype)
                   for i in range(_num_layers(state, "text_model"))],
    }
    return {"visual": visual, "text": text}
