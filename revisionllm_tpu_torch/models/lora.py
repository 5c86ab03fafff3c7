"""LoRA adapters as parameter trees beside the frozen base.

Counterpart of revisionllm_tpu/models/lora.py (PEFT's LoRA without module
surgery, reference train/train.py:281-318: r=64, alpha=128, every linear of
the decoder but lm_head): the adapter mirrors the stacked layer matrices,
{"layers": {name: {"a": [L, in, r], "b": [L, r, out]}}}, is applied in line
by the backbone (llama._lora_apply) and folded into the base weights for
inference (`merge`, the merge_and_unload of reference model/builder.py:53-60).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from revisionllm_tpu_torch.config import LlamaConfig, LoraConfig
from revisionllm_tpu_torch.models.llama import LAYER_MATRICES, _dims
from revisionllm_tpu_torch.ops.quant import dequantize_int8, quantize_int8

Params = Dict[str, Any]


def init_lora(
    cfg: LlamaConfig, lora_cfg: LoraConfig, generator: torch.Generator,
    dtype=torch.float32,
) -> Params:
    """A ~ N(0, 1/in), B = 0, so the adapter starts as the identity; drawn
    from `generator` on its device. The numbers differ from JAX's (another
    generator); parity tests carry JAX's tree across instead."""
    dims = _dims(cfg)
    L, r = cfg.num_layers, lora_cfg.r
    device = generator.device
    layers = {}
    for name in lora_cfg.target_patterns:
        if name not in LAYER_MATRICES:
            continue
        din, dout = (dims[d] for d in LAYER_MATRICES[name])
        a = torch.randn((L, din, r), generator=generator, device=device) * din ** -0.5
        layers[name] = {
            "a": a.to(dtype),
            "b": torch.zeros((L, r, dout), dtype=dtype, device=device),
        }
    return {"layers": layers}


def lora_scale(lora_cfg: LoraConfig) -> float:
    return lora_cfg.alpha / lora_cfg.r


@torch.no_grad()
def merge(params: Params, lora: Params, lora_cfg: LoraConfig) -> Params:
    """Fold the adapter into the base weights, W <- W + scale * A @ B in f32.
    An int8 base ({"q8", "scale"}) is dequantized, folded and requantized
    per output channel."""
    scale = lora_scale(lora_cfg)
    new_layers = dict(params["layers"])
    for name, mats in lora["layers"].items():
        w = params["layers"][name]
        delta = torch.einsum("ldr,lro->ldo", mats["a"].float(), mats["b"].float()) * scale
        if isinstance(w, dict) and "q8" in w:
            merged = dequantize_int8(w["q8"], w["scale"], torch.float32) + delta
            q, s = quantize_int8(merged)
            new_layers[name] = {"q8": q, "scale": s}
        else:
            new_layers[name] = (w.float() + delta).to(w.dtype)
    out = dict(params)
    out["layers"] = new_layers
    return out


def num_lora_params(lora: Params) -> int:
    return sum(m.numel() for mats in lora["layers"].values() for m in mats.values())
