"""Engine configuration from the eval CLIs' arguments: the config half of
revisionllm_tpu/eval/loader.py.

`build_engine_from_args` assembles an engine from an HF checkpoint and its
tokenizer. It waits for the checkpoint loader (ROADMAP Queue A step 9b)
and raises until then; `stage1.run` and `stage2.run` take an engine built
by the caller. `serving_params_host` is the serving quantization that it
will apply to the converted checkpoint before the transfer to the card.
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


def build_engine_from_args(args):
    raise NotImplementedError(
        "building an engine from --model_base needs the HF checkpoint loader, which is "
        "not ported yet (ROADMAP Queue A step 9b); build a GroundingEngine and call "
        "stage1.run / stage2.run with it"
    )
