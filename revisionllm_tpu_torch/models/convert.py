"""Checkpoint conversion: reference artifacts -> the port's NumPy trees.

Counterpart of revisionllm_tpu/models/convert.py (the load side of reference
revisionllm/model/builder.py:21-67): HF Vicuna base weights, then
`mm_projector.bin` / `pretrain_clip_adapter` with its key surgery
(vtimellm_arch.py:27-40), then the stage-2 / stage-3 PEFT LoRA merge
(builder.py:47-60) -- producing the stacked-layer trees of models/llama.py,
models/adapter.py and models/lora.py as NumPy arrays, for
`models.weights.params_from_numpy`; and the ChatGLM2-6B backbone with a
P-tuning checkpoint's prefix encoder (`convert_chatglm`).

Files are read with torch and numpy alone: `.bin` through torch.load, and
`.safetensors` through `read_safetensors`, a reader of the format's own (an
8-byte little-endian header length, a JSON header, raw little-endian bytes).
NumPy has no bf16, so `load_pretrained(dtype=torch.bfloat16)` returns f32
arrays whose values are rounded to bf16; casting them to bf16 is exact.
"""

from __future__ import annotations

import glob
import json
import os
import struct
from typing import Any, Dict, Optional

import numpy as np
import torch

from revisionllm_tpu_torch.config import AdapterConfig, LlamaConfig, LoraConfig

_ST_DTYPES = {"F64": "<f8", "F32": "<f4", "F16": "<f2", "I64": "<i8", "I32": "<i4",
              "I16": "<i2", "I8": "i1", "U8": "u1", "BOOL": "?"}


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """A .safetensors file -> {name: array}, in the stored types except BF16,
    which is read as f32 (exactly)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    size = os.path.getsize(path) - 8 - n
    data = np.memmap(path, np.uint8, "r", 8 + n) if size else np.zeros(0, np.uint8)
    out = {}
    for name, info in header.items():
        start, end = info["data_offsets"]
        raw = data[start:end]
        if info["dtype"] == "BF16":
            arr = (raw.view("<u2").astype(np.uint32) << 16).view(np.float32)
        else:
            stored = np.dtype(_ST_DTYPES[info["dtype"]])
            arr = raw.view(stored).astype(stored.newbyteorder("="))
        out[name] = arr.reshape(info["shape"])
    return out


def _load_torch_state(path: str) -> Dict[str, np.ndarray]:
    """Load a .bin (torch pickle) or .safetensors file to numpy."""
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    state = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy()
            for k, v in state.items()}


def _mat(w: np.ndarray, dtype) -> np.ndarray:
    """An HF [out, in] matrix as a fresh C-ordered [in, out] array of
    `dtype` (the transposing copy in torch, which spreads it over the
    cores: 4x NumPy's at 7B width)."""
    out = np.empty(w.shape[::-1], dtype)
    torch.from_numpy(out).copy_(torch.from_numpy(w if w.flags.writeable else w.copy()).T)
    return out


def load_hf_llama_state(model_dir: str) -> Dict[str, np.ndarray]:
    """Gather the full HF state dict from sharded .safetensors or .bin files."""
    files = sorted(glob.glob(os.path.join(model_dir, "*.safetensors")))
    if not files:
        files = sorted(glob.glob(os.path.join(model_dir, "pytorch_model*.bin")))
    if not files:
        raise FileNotFoundError(f"no weight files under {model_dir}")
    state: Dict[str, np.ndarray] = {}
    for f in files:
        state.update(_load_torch_state(f))
    return state


def llama_config_from_hf(model_dir: str) -> LlamaConfig:
    with open(os.path.join(model_dir, "config.json")) as f:
        hf = json.load(f)
    return LlamaConfig(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"],
        num_kv_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
        head_dim=hf["hidden_size"] // hf["num_attention_heads"],
        rope_theta=hf.get("rope_theta", 10000.0),
        rms_norm_eps=hf.get("rms_norm_eps", 1e-5),
        max_position_embeddings=hf.get("max_position_embeddings", 4096),
    )


_HF_LAYER_MAP = {
    "q_proj": "self_attn.q_proj.weight",
    "k_proj": "self_attn.k_proj.weight",
    "v_proj": "self_attn.v_proj.weight",
    "o_proj": "self_attn.o_proj.weight",
    "gate_proj": "mlp.gate_proj.weight",
    "up_proj": "mlp.up_proj.weight",
    "down_proj": "mlp.down_proj.weight",
    "attn_norm": "input_layernorm.weight",
    "mlp_norm": "post_attention_layernorm.weight",
}


def convert_llama(
    state: Dict[str, np.ndarray], cfg: LlamaConfig, dtype=np.float32
) -> Dict[str, Any]:
    """HF LlamaForCausalLM state dict -> stacked tree.

    HF Linear stores [out, in]; ours is [in, out] (x @ W), so matrices are
    transposed. Layer matrices stack on a leading L axis."""

    def key(name):
        for prefix in ("model.", ""):
            k = prefix + name
            if k in state:
                return state[k]
        raise KeyError(name)

    layers: Dict[str, np.ndarray] = {}
    for ours, theirs in _HF_LAYER_MAP.items():
        mats = []
        for i in range(cfg.num_layers):
            w = key(f"layers.{i}.{theirs}")
            mats.append(w.astype(dtype) if ours.endswith("_norm") else _mat(w, dtype))
        layers[ours] = np.stack(mats, axis=0)

    return {
        "embed": key("embed_tokens.weight").astype(dtype),
        "layers": layers,
        "final_norm": key("norm.weight").astype(dtype),
        "lm_head": _mat(state["lm_head.weight"], dtype),
    }


# ---------------------------------------------------------------------------
# ClipEncoder adapter (mm_projector.bin / non_lora_trainables.bin)
# ---------------------------------------------------------------------------


def _strip_projector_keys(state: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Key surgery equivalent to get_wc (reference vtimellm_arch.py:30-37):
    the sub-dict rooted at 'mm_projector.', tolerating the
    'model.mm_projector.' and 'base_model.model.model.mm_projector.'
    prefixes of non_lora_trainables.bin."""
    out = {}
    for k, v in state.items():
        if "mm_projector." in k:
            out[k.split("mm_projector.", 1)[1]] = v
        elif "cross_attn." in k:
            out[k.split("cross_attn.", 1)[1]] = v
    return out


def _convert_mha_layer(prefix: str, sd: Dict[str, np.ndarray], d: int, dtype):
    inw = sd[f"{prefix}.self_attn.in_proj_weight"]  # [3d, d]
    inb = sd[f"{prefix}.self_attn.in_proj_bias"]    # [3d]

    def lin(w, b):
        return {"w": _mat(w, dtype), "b": b.astype(dtype)}

    def mod(name):
        return lin(sd[f"{prefix}.{name}.weight"], sd[f"{prefix}.{name}.bias"])

    return {
        "wq": lin(inw[:d], inb[:d]),
        "wk": lin(inw[d : 2 * d], inb[d : 2 * d]),
        "wv": lin(inw[2 * d :], inb[2 * d :]),
        "wo": mod("self_attn.out_proj"),
        "ffn1": mod("linear1"),
        "ffn2": mod("linear2"),
        "norm1_w": sd[f"{prefix}.norm1.weight"].astype(dtype),
        "norm1_b": sd[f"{prefix}.norm1.bias"].astype(dtype),
        "norm2_w": sd[f"{prefix}.norm2.weight"].astype(dtype),
        "norm2_b": sd[f"{prefix}.norm2.bias"].astype(dtype),
    }


def convert_clip_adapter(
    raw_state: Dict[str, np.ndarray], cfg: AdapterConfig, dtype=np.float32
) -> Dict[str, Any]:
    """Reference ClipEncoder state dict -> models/adapter.py param tree."""
    sd = _strip_projector_keys(raw_state) or raw_state
    d = cfg.hidden_size if cfg.cross_attn else cfg.d_model
    params: Dict[str, Any] = {
        "global_token": sd["global_rep_token"].astype(dtype),
        "global_pos": sd["global_rep_pos"].astype(dtype),
        "enc_layers": [
            _convert_mha_layer(f"encoder.layers.{i}", sd, d, dtype)
            for i in range(cfg.num_layers)
        ],
    }
    if cfg.clip_adapter_text and "t2v_encoder.layers.0.self_attn.in_proj_weight" in sd:
        params["t2v_layers"] = [
            _convert_mha_layer(f"t2v_encoder.layers.{i}", sd, d, dtype)
            for i in range(cfg.num_layers)
        ]
    if cfg.cross_attn and "text_mm_projector.weight" in sd:
        params["text_proj"] = {
            "w": _mat(sd["text_mm_projector.weight"], dtype),
            "b": sd["text_mm_projector.bias"].astype(dtype),
        }
    if "mm_projector.weight" in sd:  # the inner Linear d->hidden
        params["mm_projector"] = {
            "w": _mat(sd["mm_projector.weight"], dtype),
            "b": sd["mm_projector.bias"].astype(dtype),
        }
    return params


def convert_mlp_projector(raw_state: Dict[str, np.ndarray], dtype=np.float32) -> Dict[str, Any]:
    """Plain Linear mm_projector.bin (the get_w path, vtimellm_arch.py:46-49)."""
    sd = _strip_projector_keys(raw_state) or raw_state
    return {"w": _mat(sd["weight"], dtype), "b": sd["bias"].astype(dtype)}


def convert_projector(raw_state: Dict[str, np.ndarray], adapter_cfg: AdapterConfig,
                      dtype=np.float32) -> Dict[str, Any]:
    """A projector state dict -> the mm_projector tree of `adapter_cfg`'s
    kind: the plain Linear (mlp) or the ClipEncoder."""
    if adapter_cfg.kind == "mlp":
        return convert_mlp_projector(raw_state, dtype)
    return convert_clip_adapter(raw_state, adapter_cfg, dtype)


# ---------------------------------------------------------------------------
# PEFT LoRA adapters
# ---------------------------------------------------------------------------


def convert_peft_lora(
    lora_dir: str, cfg: LlamaConfig, dtype=np.float32
) -> tuple[Dict[str, Any], LoraConfig]:
    """PEFT adapter dir (adapter_model.bin/.safetensors + adapter_config.json)
    -> (lora tree, LoraConfig). Parity: load_lora (builder.py:9-19). A
    projection counts only when every layer has both of its matrices."""
    with open(os.path.join(lora_dir, "adapter_config.json")) as f:
        pcfg = json.load(f)
    lora_cfg = LoraConfig(
        r=pcfg["r"], alpha=pcfg["lora_alpha"], dropout=pcfg.get("lora_dropout", 0.0),
        target_patterns=tuple(pcfg.get("target_modules", [])),
    )
    for name in ("adapter_model.safetensors", "adapter_model.bin"):
        p = os.path.join(lora_dir, name)
        if os.path.isfile(p):
            state = _load_torch_state(p)
            break
    else:
        raise FileNotFoundError(f"no adapter weights in {lora_dir}")

    proj_names = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")
    layers: Dict[str, Dict[str, np.ndarray]] = {}
    for name in proj_names:
        a_mats, b_mats = [], []
        for i in range(cfg.num_layers):
            a = b = None
            for k, v in state.items():
                if f"layers.{i}." in k and f"{name}.lora_A" in k:
                    a = v
                if f"layers.{i}." in k and f"{name}.lora_B" in k:
                    b = v
            if a is None or b is None:
                break
            a_mats.append(_mat(a, dtype))  # [in, r]
            b_mats.append(_mat(b, dtype))  # [r, out]
        if len(a_mats) == cfg.num_layers:
            layers[name] = {"a": np.stack(a_mats), "b": np.stack(b_mats)}
    return {"layers": layers}, lora_cfg


# ---------------------------------------------------------------------------
# Full assembly
# ---------------------------------------------------------------------------


def _round_in_place(tree: Any, dtype: torch.dtype) -> Any:
    """Round every f32 array of a freshly made `tree` to `dtype` (round to
    nearest even), in place, and return the tree; f32 leaves it as it is."""
    if isinstance(tree, dict):
        for v in tree.values():
            _round_in_place(v, dtype)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _round_in_place(v, dtype)
    elif dtype != torch.float32:
        t = torch.from_numpy(tree)
        t.copy_(t.to(dtype))
    return tree


def merge_lora(params: Dict[str, Any], lora: Dict[str, Any], lora_cfg: LoraConfig,
               dtype: torch.dtype) -> Dict[str, Any]:
    """models.lora.merge on NumPy trees whose values are of `dtype`: each
    target W <- round(W + scale * A @ B, dtype), the sum in f32, as JAX merges
    a bf16 base (revisionllm_tpu/models/lora.py:77). Returns f32 arrays."""
    from revisionllm_tpu_torch.models import lora as lora_mod

    base = {n: torch.from_numpy(params["layers"][n]).to(dtype) for n in lora["layers"]}
    adapter = {n: {k: torch.from_numpy(v) for k, v in m.items()}
               for n, m in lora["layers"].items()}
    merged = lora_mod.merge({"layers": base}, {"layers": adapter}, lora_cfg)["layers"]
    out = dict(params)
    out["layers"] = {**params["layers"], **{n: w.float().numpy() for n, w in merged.items()}}
    return out


def load_pretrained(
    model_base: str,
    adapter_cfg: AdapterConfig,
    mm_projector_path: Optional[str] = None,
    stage2_lora: Optional[str] = None,
    stage3_lora: Optional[str] = None,
    dtype: torch.dtype = torch.float32,
):
    """Full checkpoint assembly (parity: load_pretrained_model,
    builder.py:21-67): base -> vision modules -> merge stage2 -> merge stage3.
    Every value is rounded to `dtype` (f32 arrays; torch.bfloat16 rounds as
    JAX's bf16 load does), the merged matrices again after each merge.

    Returns (llama_cfg, params, vision_params)."""
    cfg = llama_config_from_hf(model_base)
    params = _round_in_place(convert_llama(load_hf_llama_state(model_base), cfg), dtype)

    def adapter(raw):
        return {"mm_projector": _round_in_place(convert_projector(raw, adapter_cfg), dtype)}

    vision = None
    if mm_projector_path is not None:
        vision = adapter(_load_torch_state(mm_projector_path))

    for lora_dir in (stage2_lora, stage3_lora):
        if lora_dir is None:
            continue
        non_lora = os.path.join(lora_dir, "non_lora_trainables.bin")
        # as JAX's loader (convert.py:284-302), beyond the reference: a stage
        # dir's saved projector is the fallback -- never over an explicit
        # mm_projector_path, and only when its keys match the adapter kind
        if mm_projector_path is None and os.path.isfile(non_lora):
            raw = _load_torch_state(non_lora)
            proj = _strip_projector_keys(raw)
            is_clip_state = any("global_rep_token" in k for k in proj)
            if proj and (adapter_cfg.kind == "mlp") == (not is_clip_state):
                vision = adapter(raw)
        lora_tree, lora_cfg = convert_peft_lora(lora_dir, cfg)
        params = merge_lora(params, _round_in_place(lora_tree, dtype), lora_cfg, dtype)

    return cfg, params, vision


# ---------------------------------------------------------------------------
# ChatGLM2 backbone
# ---------------------------------------------------------------------------


def convert_chatglm(
    state: Dict[str, np.ndarray], cfg: LlamaConfig, dtype=np.float32
) -> Dict[str, Any]:
    """ChatGLM2-6B state dict -> the backbone tree (the reference's secondary
    LLM, model/vtimellm_chatglm.py over model/chatglm/modeling_chatglm.py),
    with its q/k/v biases.

    Packed tensors are split: query_key_value rows [q | k | v] and their
    bias; dense_h_to_4h rows [gate | up] (SwiGLU's silu(x0) * x1). A P-tuning
    checkpoint's prefix encoder (modeling_chatglm.py PrefixEncoder :61-89)
    becomes "prefix": {"embed"[, "proj": {"w1", "b1", "w2", "b2"}]}."""
    L = cfg.num_layers
    q_out = cfg.num_heads * cfg.head_dim
    kv_out = cfg.num_kv_heads * cfg.head_dim
    ffn = cfg.intermediate_size

    def key(name):
        for prefix in ("transformer.", ""):
            k = prefix + name
            if k in state:
                return state[k]
        raise KeyError(name)

    layers: Dict[str, list] = {
        n: [] for n in (
            "q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
            "down_proj", "attn_norm", "mlp_norm", "q_bias", "k_bias", "v_bias",
        )
    }
    for i in range(L):
        pre = f"encoder.layers.{i}"
        qkv_w = key(f"{pre}.self_attention.query_key_value.weight")
        qkv_b = key(f"{pre}.self_attention.query_key_value.bias")
        layers["q_proj"].append(_mat(qkv_w[:q_out], dtype))
        layers["k_proj"].append(_mat(qkv_w[q_out : q_out + kv_out], dtype))
        layers["v_proj"].append(_mat(qkv_w[q_out + kv_out :], dtype))
        layers["q_bias"].append(qkv_b[:q_out].astype(dtype))
        layers["k_bias"].append(qkv_b[q_out : q_out + kv_out].astype(dtype))
        layers["v_bias"].append(qkv_b[q_out + kv_out :].astype(dtype))
        layers["o_proj"].append(_mat(key(f"{pre}.self_attention.dense.weight"), dtype))
        h4 = key(f"{pre}.mlp.dense_h_to_4h.weight")
        layers["gate_proj"].append(_mat(h4[:ffn], dtype))
        layers["up_proj"].append(_mat(h4[ffn:], dtype))
        layers["down_proj"].append(_mat(key(f"{pre}.mlp.dense_4h_to_h.weight"), dtype))
        layers["attn_norm"].append(key(f"{pre}.input_layernorm.weight").astype(dtype))
        layers["mlp_norm"].append(key(f"{pre}.post_attention_layernorm.weight").astype(dtype))

    out: Dict[str, Any] = {
        "embed": key("embedding.word_embeddings.weight").astype(dtype),
        "layers": {n: np.stack(v) for n, v in layers.items()},
        "final_norm": key("encoder.final_layernorm.weight").astype(dtype),
        "lm_head": _mat(key("output_layer.weight"), dtype),
    }
    for pe in ("prefix_encoder.", "transformer.prefix_encoder."):
        if pe + "embedding.weight" in state:
            prefix: Dict[str, Any] = {"embed": state[pe + "embedding.weight"].astype(dtype)}
            if pe + "trans.0.weight" in state:  # torch Linear [out, in] -> [in, out]
                prefix["proj"] = {
                    "w1": _mat(state[pe + "trans.0.weight"], dtype),
                    "b1": state[pe + "trans.0.bias"].astype(dtype),
                    "w2": _mat(state[pe + "trans.2.weight"], dtype),
                    "b2": state[pe + "trans.2.bias"].astype(dtype),
                }
            out["prefix"] = prefix
            break
    return out
