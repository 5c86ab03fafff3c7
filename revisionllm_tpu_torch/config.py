"""Typed configuration for the ported path.

A copy of the three configs the stage-1 grounding path reads from
`revisionllm_tpu/config.py` (LlamaConfig, AdapterConfig, EvalConfig); the
port keeps its own copy so that it never imports the JAX package.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class LlamaConfig:
    """Vicuna-7B-v1.5 geometry (HF llama-7b defaults)."""

    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: int = 128
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    max_position_embeddings: int = 4096
    dtype: str = "bfloat16"
    # ChatGLM2 knobs, kept so configs round-trip; the port's llama rejects
    # them until the GLM slice lands
    rope_fraction: float = 1.0
    rope_interleaved: bool = False
    qkv_bias: bool = False

    @staticmethod
    def vicuna_7b() -> "LlamaConfig":
        return LlamaConfig()

    @staticmethod
    def tiny(vocab_size: int = 512) -> "LlamaConfig":
        """Small config for tests: same structure, toy sizes."""
        return LlamaConfig(
            vocab_size=vocab_size,
            hidden_size=128,
            intermediate_size=256,
            num_layers=2,
            num_heads=4,
            num_kv_heads=4,
            head_dim=32,
            max_position_embeddings=512,
        )


@dataclass(frozen=True)
class AdapterConfig:
    """ClipEncoder adapter geometry."""

    kind: str = "clip_encoder"       # clip_encoder | mlp
    d_model: int = 768
    num_heads: int = 8
    num_layers: int = 2
    ffn_dim: int = 2048
    hidden_size: int = 4096          # LLM embedding dim for mm_projector
    clip_adapter_text: bool = False  # T2V text->video cross-attn encoder
    cross_attn: bool = False         # chapters variant (not ported yet)
    hierarchy: bool = True           # CLS-token output (1 token per window)
    feature_mode: str = "cls"        # cls | temporal | alternate | all
    dropout: float = 0.1
    ca_self_attn: Optional[str] = None  # not ported yet
    sa_pos: int = 2
    linformer_k: int = 256
    max_video_length: int = 512
    performer_nb_features: int = 0
    projector_init: str = "xavier"   # xavier | zero

    def with_hidden(self, hidden_size: int) -> "AdapterConfig":
        return dataclasses.replace(self, hidden_size=hidden_size)


@dataclass(frozen=True)
class EvalConfig:
    """Eval driver knobs."""

    debug_window: int = 125
    num_frames: int = 250
    feature_fps: float = 5.0
    batch: int = 1                   # windows per LLM call
    stride: int = 2
    split: int = 0
    total_split: int = 1
    score: str = "mean_entropy"      # cosine_sim | max_entropy | mean_entropy
    score_merge: str = "multiply"    # add | multiply
    normalize: bool = True
    topk_pool: bool = True
    skip_small_videos: bool = True
    hierarchy_zooms: Tuple[int, ...] = (4, 2, 1)
    single: bool = True
    max_new_tokens: int = 32
    temperature: float = 0.05
    greedy: bool = True
    baseline: bool = False           # single globally-resampled window
    plus_baseline: bool = False      # append a whole-movie window
