"""Engine construction from the eval CLIs' arguments: checkpoint assembly,
serving quantization and the tokenizer. Counterpart of
revisionllm_tpu/eval/loader.py, the glue of the reference's
load_pretrained_model call sites (eval_nlq_negative.py:143,
eval_nlq_retrieval_e2e2.py:180).

`load_model` resolves the device first (CUDA unless --device says
otherwise), then converts the HF checkpoint and the stage directories
(models/convert.py), quantizes it in host RAM (`serving_params_host`) and
moves it to the device. The tokenizer comes from `transformers` unless the
caller passes one. `build_engine_from_args` wraps the model in a
GroundingEngine for the eval CLIs; the demo chats over it directly.
"""

from __future__ import annotations

import os

import torch

from revisionllm_tpu_torch.config import AdapterConfig, EvalConfig


def adapter_cfg_from_args(args) -> AdapterConfig:
    hierarchy = bool(getattr(args, "hierarchy", False))
    if getattr(args, "clip_adapter", False) or getattr(args, "pretrain_clip_adapter", None):
        return AdapterConfig(
            kind="clip_encoder",
            d_model=getattr(args, "adapter_d_model", 768),
            num_heads=getattr(args, "adapter_heads", 8),
            num_layers=getattr(args, "adapter_layers", 2),
            ffn_dim=getattr(args, "adapter_ffn", 2048),
            clip_adapter_text=bool(getattr(args, "clip_adapter_text", False)),
            cross_attn=bool(getattr(args, "cross_attn", False)),
            hierarchy=hierarchy,
            feature_mode="cls" if hierarchy else getattr(args, "clip_adapter_feature", "temporal"),
        )
    return AdapterConfig(kind="mlp", hierarchy=hierarchy)


def eval_cfg_from_args(args) -> EvalConfig:
    return EvalConfig(
        debug_window=args.debug_window,
        num_frames=args.num_frames,
        feature_fps=args.feature_fps,
        batch=args.batch,
        stride=getattr(args, "stride", 2),
        split=args.split,
        total_split=args.total_split,
        score=getattr(args, "score", "mean_entropy"),
        score_merge=getattr(args, "score_merge", "multiply"),
        normalize=bool(getattr(args, "normalize", True)),
        topk_pool=bool(getattr(args, "topk_pool", True)),
        skip_small_videos=bool(getattr(args, "skip_small_videos", True)),
        single=bool(getattr(args, "single", True)),
        max_new_tokens=getattr(args, "max_new_tokens", 32),
        baseline=bool(getattr(args, "baseline", False)),
        plus_baseline=bool(getattr(args, "plus_baseline", False)),
        hierarchy_zooms=tuple(
            int(z) for z in str(getattr(args, "zooms", None) or "4,2,1").split(",")
        ),
    )


def serving_params_host(llama_cfg, params, device):
    """A converted checkpoint's NumPy tree, quantized in host RAM for serving
    on `device` (revisionllm_tpu/eval/loader.py:85-101), so a 7B tree never
    stages its bf16 copy on the card: REVISIONLLM_QUANT=int8 (the default on
    CUDA; "none" on the CPU) quantizes every layer matrix and the lm_head;
    then REVISIONLLM_SERVE=1 packs the layers into the serving chunks
    (ops.decode_serve) where supports_serve holds, so the packed copy
    replaces the standard one and decode takes row 10."""
    from revisionllm_tpu_torch.ops.decode_serve import supports_serve
    from revisionllm_tpu_torch.ops.quant import (
        pack_serving_weights_host,
        quantize_llama_params_host,
    )

    default_quant = "int8" if torch.device(device).type == "cuda" else "none"
    if os.environ.get("REVISIONLLM_QUANT", default_quant) != "int8":
        return params
    params = quantize_llama_params_host(params)
    if os.environ.get("REVISIONLLM_SERVE", "0") == "1" and supports_serve(llama_cfg, params):
        params = dict(params)
        params["layers"] = pack_serving_weights_host(params["layers"])
    return params


def load_model(args, tokenizer=None):
    """(llama_cfg, adapter_cfg, params, vision, tokenizer, device): the
    checkpoint of --model_base with the projector flags and the --stage2 /
    --stage3 LoRA directories, quantized in host RAM for serving and moved
    to `args.device` (default CUDA). `tokenizer`, when given, replaces
    AutoTokenizer.from_pretrained."""
    from revisionllm_tpu_torch.models.convert import load_pretrained
    from revisionllm_tpu_torch.models.llama import torch_dtype
    from revisionllm_tpu_torch.models.weights import params_from_numpy
    from revisionllm_tpu_torch.utils.device import resolve_device

    device = resolve_device(getattr(args, "device", None))
    if getattr(args, "mesh", None):
        raise NotImplementedError("--mesh waits for the distributed layer "
                                  "(ROADMAP Queue A step 7)")
    adapter_cfg = adapter_cfg_from_args(args)
    llama_cfg, params, vision = load_pretrained(
        args.model_base,
        adapter_cfg,
        mm_projector_path=(
            getattr(args, "pretrain_clip_adapter", None)
            or getattr(args, "pretrain_mm_mlp_adapter", None)
        ),
        stage2_lora=getattr(args, "stage2", None),
        stage3_lora=getattr(args, "stage3", None),
        dtype=torch.bfloat16,
    )
    adapter_cfg = adapter_cfg.with_hidden(llama_cfg.hidden_size)
    params = serving_params_host(llama_cfg, params, device)
    # the values are bf16 already; the leaves take the model's type
    dtype = torch_dtype(llama_cfg.dtype)
    params = params_from_numpy(params, device, dtype)
    if vision is not None:
        vision = params_from_numpy(vision, device, dtype)

    if tokenizer is None:
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(args.model_base, use_fast=True)
    return llama_cfg, adapter_cfg, params, vision, tokenizer, device


def build_engine_from_args(args, tokenizer=None):
    """A GroundingEngine on `args.device` (default CUDA) over `load_model`'s
    checkpoint; `tokenizer`, when given, replaces
    AutoTokenizer.from_pretrained."""
    from revisionllm_tpu_torch.eval.engine import GroundingEngine

    llama_cfg, adapter_cfg, params, vision, tokenizer, device = load_model(args, tokenizer)
    return GroundingEngine(
        llama_cfg, adapter_cfg, params, vision, tokenizer, eval_cfg_from_args(args),
        eos_id=tokenizer.eos_token_id or 2, device=device,
    )
