"""Engine configuration from the eval CLIs' arguments: the config half of
revisionllm_tpu/eval/loader.py.

`build_engine_from_args` assembles an engine from an HF checkpoint and its
tokenizer. It waits for the checkpoint loader (ROADMAP Queue A step 9b)
and raises until then; `stage1.run` and `stage2.run` take an engine built
by the caller.
"""

from __future__ import annotations

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


def build_engine_from_args(args):
    raise NotImplementedError(
        "building an engine from --model_base needs the HF checkpoint loader, which is "
        "not ported yet (ROADMAP Queue A step 9b); build a GroundingEngine and call "
        "stage1.run / stage2.run with it"
    )
