"""Typed configuration for the ported paths.

A copy of what stage-1 grounding and training read from
`revisionllm_tpu/config.py` (LlamaConfig, AdapterConfig, LoraConfig,
DataConfig, TrainConfig, EvalConfig, MeshConfig, WorkloadConfig and the
presets); the port keeps its own copy so that it never imports the JAX
package.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
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
    # ChatGLM2 knobs (the reference's secondary backbone)
    rope_fraction: float = 1.0      # fraction of head_dim rotated (GLM2: 0.5)
    rope_interleaved: bool = False  # GLM2 pairs (even, odd) dims instead of halves
    qkv_bias: bool = False          # GLM2 has bias on q/k/v only

    @staticmethod
    def vicuna_7b() -> "LlamaConfig":
        return LlamaConfig()

    @staticmethod
    def chatglm2_6b() -> "LlamaConfig":
        """ChatGLM2-6B geometry: 28 layers, 32 query heads over 2 kv heads,
        half-dim interleaved rotary, q/k/v biases, SwiGLU 13696."""
        return LlamaConfig(
            vocab_size=65024, hidden_size=4096, intermediate_size=13696,
            num_layers=28, num_heads=32, num_kv_heads=2, head_dim=128,
            rope_theta=10000.0, rms_norm_eps=1e-5,
            max_position_embeddings=32768,
            rope_fraction=0.5, rope_interleaved=True, qkv_bias=True,
        )

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

    @property
    def latent_attention(self) -> bool:
        """Whether the layers are DeepSeek-V2's MLA and DeepSeekMoE
        (DeepseekV2Config); False for the Llama and ChatGLM2 geometries."""
        return False

    @staticmethod
    def deepseek_v2_lite() -> "DeepseekV2Config":
        return DeepseekV2Config.lite()


@dataclass(frozen=True)
class DeepseekV2Config(LlamaConfig):
    """DeepSeek-V2's block (HF `deepseek_v2`, modeling_deepseek.py):
    multi-head latent attention (MLA) without a q low-rank, YaRN rotary on
    the rope part of each head, a leading run of dense SwiGLU layers and
    then DeepSeekMoE layers (a softmax router over `n_routed_experts`,
    greedy top-`num_experts_per_tok`, plus shared experts). `num_heads` and
    `intermediate_size` (the dense layers' width) keep their meaning;
    `head_dim` is the value head. The fields live on this subclass, so the
    dense configurations' fields stay those of the JAX package's LlamaConfig."""

    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    moe_intermediate_size: int = 1408
    first_k_dense_replace: int = 1
    # YaRN (rope_scaling {"type": "yarn", ...}); factor 1 is plain rotary
    rope_scaling_factor: float = 40.0
    rope_original_max_position: int = 4096
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0
    yarn_mscale: float = 0.707
    yarn_mscale_all_dim: float = 0.707

    @property
    def latent_attention(self) -> bool:
        return True

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def num_moe_layers(self) -> int:
        return self.num_layers - self.first_k_dense_replace

    @staticmethod
    def lite() -> "DeepseekV2Config":
        """DeepSeek-V2-Lite (huggingface.co/deepseek-ai/DeepSeek-V2-Lite
        config.json): 27 layers, hidden 2048, 16 heads, latent 512 + rope
        64, layer 0 dense (10944), 26 MoE layers of 64 experts (1408), top 6,
        2 shared, vocabulary 102400."""
        return DeepseekV2Config(
            vocab_size=102400, hidden_size=2048, intermediate_size=10944, num_layers=27,
            num_heads=16, num_kv_heads=16, head_dim=128, rope_theta=10000.0,
            rms_norm_eps=1e-6, max_position_embeddings=163840)

    @staticmethod
    def tiny(vocab_size: int = 512) -> "DeepseekV2Config":
        """The CPU tests' size: 3 layers (the first dense), hidden 128, 4
        heads, latent 32 + rope 16, nope 32, v 32, 8 experts, top 2, 1
        shared."""
        return DeepseekV2Config(
            vocab_size=vocab_size, hidden_size=128, intermediate_size=256, num_layers=3,
            num_heads=4, num_kv_heads=4, head_dim=32, rms_norm_eps=1e-6,
            max_position_embeddings=512, kv_lora_rank=32, qk_nope_head_dim=32,
            qk_rope_head_dim=16, v_head_dim=32, n_routed_experts=8, n_shared_experts=1,
            num_experts_per_tok=2, moe_intermediate_size=64, first_k_dense_replace=1,
            rope_scaling_factor=40.0, rope_original_max_position=64)


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
    cross_attn: bool = False         # chapters variant: the adapter at hidden_size, text_proj
    hierarchy: bool = True           # CLS-token output (1 token per window)
    feature_mode: str = "cls"        # cls | temporal | alternate | all
    dropout: float = 0.1
    ca_self_attn: Optional[str] = None  # None | performer | linformer | self-attn
    sa_pos: int = 2
    linformer_k: int = 256
    max_video_length: int = 512
    performer_nb_features: int = 0
    projector_init: str = "xavier"   # xavier | zero

    def with_hidden(self, hidden_size: int) -> "AdapterConfig":
        return dataclasses.replace(self, hidden_size=hidden_size)


@dataclass(frozen=True)
class LoraConfig:
    """LoRA hyperparameters (reference scripts/mad/stage1_dense.sh:44-46:
    r=64, alpha=128, dropout 0.05; applied to all linears except lm_head per
    train/train.py:129-140)."""

    r: int = 64
    alpha: int = 128
    dropout: float = 0.05
    target_patterns: Tuple[str, ...] = (
        "q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj",
    )


@dataclass(frozen=True)
class DataConfig:
    """Dataset/windowing knobs
    (reference revisionllm/train/dataset.py:28-55 DataArguments)."""

    data_path: Optional[str] = None
    feat_folder: Optional[str] = None
    q_feat_dir: Optional[str] = None
    vis_feat_storage: str = "lmdb"   # lmdb | npy
    num_frames: int = 250
    feature_fps: float = 5.0
    debug_window: int = 125          # seconds per window
    max_q_l: int = 25
    dataset: str = "mad"
    hierarchy: bool = False
    hierarchy_num_videos: int = 100
    hierarchy_zoom: bool = False
    fix_hierarchy_zoom: int = 0
    hierarchy_neg: bool = False
    # positive windows per hierarchy sample, drawn as rng.integers(lo, hi).
    # (2, 4) is the reference's hard-coded randint(2,3) (dataset.py:571);
    # eval permutes windows so single positives appear scattered — small
    # synthetic models need (1, ...) to see that case in training
    hierarchy_pos_range: Tuple[int, int] = (2, 4)
    neg_window: bool = False
    neg_samples: float = 1.0
    neg_factor: int = 1
    retrieval_only: bool = False
    stream: bool = False
    keep_longer_gt: bool = False
    ignore_temporal: bool = False
    sparse_dataset: bool = False
    sparse_length: int = 0
    long_baseline: bool = False
    clip_adapter_feature: str = "cls"  # mirrors AdapterConfig.feature_mode for
                                       # the 'alternate' schedule (dataset.py:565-567)
    t2v: Optional[str] = None          # MSRVTT text->video retrieval: csv of video
                                       # ids; negatives sampled from OTHER videos
                                       # (dataset.py:52,475-480,657-693)


@dataclass(frozen=True)
class TrainConfig:
    """Training runtime knobs (reference train/train.py:72-106 +
    scripts/mad/stage1_dense.sh:42-64)."""

    training_stage: int = 2          # 1|2|3|4 LoRA state machine (train.py:299-318)
    learning_rate: float = 1e-4
    weight_decay: float = 0.0
    warmup_ratio: float = 0.03
    lr_scheduler: str = "cosine"
    num_epochs: int = 5
    per_device_batch_size: int = 128
    gradient_accumulation: int = 1
    model_max_length: int = 2048
    bf16: bool = True
    gradient_checkpointing: bool = True
    lora: Optional[LoraConfig] = field(default_factory=LoraConfig)
    tune_mm_mlp_adapter: bool = False
    freeze_mm_mlp_adapter: bool = False
    freeze_backbone: bool = True     # v5e: backbone frozen bf16, LoRA+adapter trained
    memory_type: str = "mean_pool"   # mean_pool | gt_mean_pool | gt_multi | multi_pool
    stream_loss: str = "single"      # single | double
    seed: int = 42
    save_steps: int = 500
    log_steps: int = 10


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


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh layout. Axes: data (dp), fsdp (param shard), tensor (tp)."""

    dp: int = 1
    fsdp: int = 1
    tp: int = 1

    @property
    def num_devices(self) -> int:
        return self.dp * self.fsdp * self.tp


@dataclass(frozen=True)
class WorkloadConfig:
    name: str
    model: LlamaConfig = field(default_factory=LlamaConfig.vicuna_7b)
    adapter: AdapterConfig = field(default_factory=AdapterConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)


def _preset_stage1_dense() -> WorkloadConfig:
    """MAD stage-1 dense grounding training
    (reference scripts/mad/stage1_dense.sh: bs 128/dev, 5 epochs, lr 1e-4,
    window 125 s, 250 frames, temporal adapter features)."""
    return WorkloadConfig(
        name="stage1_dense",
        adapter=AdapterConfig(hierarchy=False, feature_mode="temporal", clip_adapter_text=True),
        data=DataConfig(num_frames=250, debug_window=125, neg_window=True, neg_samples=1.0),
        train=TrainConfig(training_stage=2, per_device_batch_size=128, num_epochs=5),
        eval=EvalConfig(stride=2, batch=1),
    )


def _preset_stage1_sparse() -> WorkloadConfig:
    """MAD stage-1 sparse adapter tuning
    (reference scripts/mad/stage1_sparse.sh: 1 epoch, bs 32 x ga 2,
    tunes the ClipEncoder adapter)."""
    return WorkloadConfig(
        name="stage1_sparse",
        adapter=AdapterConfig(hierarchy=False, feature_mode="temporal", clip_adapter_text=True),
        data=DataConfig(num_frames=250, debug_window=125, sparse_dataset=True),
        train=TrainConfig(
            training_stage=1,
            per_device_batch_size=32,
            gradient_accumulation=2,
            num_epochs=1,
            tune_mm_mlp_adapter=True,
        ),
    )


def _preset_stage2_long(num_windows: int) -> WorkloadConfig:
    """MAD stage-2 hierarchical retrieval training
    (reference scripts/mad/stage2_long_100.sh: 8xA40, bs 8 x ga 2, 2 epochs,
    hierarchy=True, 100 or 33 windows per sample)."""
    return WorkloadConfig(
        name=f"stage2_long_{num_windows}",
        adapter=AdapterConfig(hierarchy=True, feature_mode="cls", clip_adapter_text=True),
        data=DataConfig(
            num_frames=250,
            debug_window=125,
            hierarchy=True,
            hierarchy_num_videos=num_windows,
            hierarchy_zoom=True,
            neg_window=True,
        ),
        train=TrainConfig(
            training_stage=3,
            per_device_batch_size=8,
            gradient_accumulation=2,
            num_epochs=2,
        ),
        eval=EvalConfig(stride=5, batch=num_windows, hierarchy_zooms=(4, 2, 1)),
    )


def _preset_chapters_stage2() -> WorkloadConfig:
    """VidChapters-7M stage-2 (reference scripts/chapters/eval_stage2_100.sh:
    window 500 s x 2 fps, 250 frames, 100 windows)."""
    return WorkloadConfig(
        name="chapters_stage2_100",
        adapter=AdapterConfig(hierarchy=True, feature_mode="cls", cross_attn=True),
        data=DataConfig(
            num_frames=250,
            debug_window=500,
            feature_fps=2.0,
            hierarchy=True,
            hierarchy_num_videos=100,
            dataset="vidchapters7m",
        ),
        eval=EvalConfig(debug_window=500, feature_fps=2.0, stride=5, batch=100),
    )


def _preset_stage1_stream() -> WorkloadConfig:
    """Streaming-memory training: paired clips, pooled clip1 memory injected
    into clip2 at the <memory> sentinel (reference stream flags:
    dataset.py:46 `stream`, train.py:104-105 memory_type/stream_loss;
    the mlp projector is the memory-compatible adapter)."""
    return WorkloadConfig(
        name="stage1_stream",
        adapter=AdapterConfig(kind="mlp", hierarchy=False),
        data=DataConfig(num_frames=250, debug_window=125, stream=True),
        train=TrainConfig(
            training_stage=2, per_device_batch_size=8, num_epochs=2,
            memory_type="mean_pool", stream_loss="single",
        ),
    )


def _preset_synthetic_tiny() -> WorkloadConfig:
    """Tiny synthetic-grounding sanity workload (data/synthetic.py): the
    stage-1 dense recipe scaled down so the full train->export->eval chain
    demonstrably LEARNS localization above chance. No reference counterpart;
    the pipeline shape mirrors scripts/mad/stage1_dense.sh."""
    return WorkloadConfig(
        name="synthetic_tiny",
        model=LlamaConfig(dtype="float32"),  # tiny scale trains in f32
        adapter=AdapterConfig(kind="mlp", d_model=16, hierarchy=False),
        data=DataConfig(
            num_frames=16, debug_window=90, feature_fps=1.0,
            neg_window=True, neg_samples=1.0, max_q_l=8,
        ),
        train=TrainConfig(
            training_stage=2, per_device_batch_size=8, num_epochs=20,
            learning_rate=2e-3, model_max_length=128,
            lora=LoraConfig(r=32, alpha=64, dropout=0.0),
            gradient_checkpointing=False, warmup_ratio=0.05,
        ),
        eval=EvalConfig(
            debug_window=90, num_frames=16, feature_fps=1.0,
            stride=2, batch=8, max_new_tokens=8,
        ),
    )


def _preset_synthetic_tiny_stream() -> WorkloadConfig:
    """Streaming-memory variant of synthetic_tiny over the stream corpus
    (data/synthetic.py::make_stream_corpus): paired clips, clip-1 memory
    pooled per memory_type and injected at clip-2's <memory> sentinel —
    the learning witness for the reference's stream mode
    (vtimellm_trainer.py:78-129, vtimellm_arch.py:208-232)."""
    base = _preset_synthetic_tiny()
    return WorkloadConfig(
        name="synthetic_tiny_stream",
        model=base.model,
        adapter=base.adapter,
        data=DataConfig(**{**base.data.__dict__, "stream": True}),
        train=TrainConfig(**{
            **base.train.__dict__,
            "memory_type": "gt_mean_pool", "stream_loss": "single",
        }),
        eval=base.eval,
    )


def _preset_synthetic_tiny_sparse() -> WorkloadConfig:
    """ClipEncoder adapter pretraining at synthetic-tiny scale — the
    scripts/mad/stage1_sparse.sh phase: tune ONLY the adapter (temporal
    mode) against the frozen stage-1 LoRA'd backbone. Stage-2 retrieval
    cannot bootstrap a RANDOM ClipEncoder (the LLM learns to ignore the
    noisy CLS tokens first — measured plateau at the answer-template
    optimum); the reference's own pipeline pretrains it here."""
    return WorkloadConfig(
        name="synthetic_tiny_sparse",
        model=LlamaConfig(dtype="float32"),
        adapter=AdapterConfig(
            kind="clip_encoder", d_model=16, num_heads=4, num_layers=2,
            ffn_dim=32, hierarchy=False, feature_mode="temporal",
            clip_adapter_text=True, dropout=0.0,
        ),
        data=DataConfig(
            num_frames=16, debug_window=90, feature_fps=1.0,
            neg_window=True, neg_samples=1.0, max_q_l=8,
        ),
        train=TrainConfig(
            training_stage=1, tune_mm_mlp_adapter=True,
            per_device_batch_size=8, num_epochs=20, learning_rate=1e-3,
            model_max_length=128, lora=LoraConfig(r=32, alpha=64, dropout=0.0),
            gradient_checkpointing=False, warmup_ratio=0.05,
        ),
        eval=EvalConfig(
            debug_window=90, num_frames=16, feature_fps=1.0,
            stride=2, batch=8, max_new_tokens=8,
        ),
    )


def _preset_synthetic_tiny_stage2() -> WorkloadConfig:
    """Stage-2 retrieval recipe at synthetic-tiny scale: hierarchy batches of
    8 windows, ClipEncoder CLS adapter, training_stage=3 over the stage-1
    LoRA (the scripts/mad/stage2_long recipe shape, scaled down)."""
    return WorkloadConfig(
        name="synthetic_tiny_stage2",
        model=LlamaConfig(dtype="float32"),
        adapter=AdapterConfig(
            kind="clip_encoder", d_model=16, num_heads=4, num_layers=2,
            ffn_dim=32, hierarchy=True, feature_mode="cls",
            clip_adapter_text=True, dropout=0.0, projector_init="zero",
        ),
        data=DataConfig(
            num_frames=16, debug_window=90, feature_fps=1.0, max_q_l=8,
            hierarchy=True, hierarchy_num_videos=8, neg_window=True,
            neg_samples=1.0, hierarchy_pos_range=(1, 3),
            # without this, negative records would be assembled as positive
            # hierarchies over away-from-GT crops (the reference masks the
            # same poisoning behind its pos_data index-shadowing bug,
            # dataset.py:605-613 — PARITY.md)
            hierarchy_neg=True,
        ),
        train=TrainConfig(
            # lr 5e-4: at 2e-3 the retrieval objective collapses into the
            # 'answer the majority template' optimum before the adapter can
            # inject signal (measured: constant-lr 1e-4 probes converge,
            # full runs at 2e-3 plateau at loss ~0.55 answering Not Present)
            training_stage=3, per_device_batch_size=4, num_epochs=20,
            learning_rate=5e-4, model_max_length=128,
            lora=LoraConfig(r=32, alpha=64, dropout=0.0),
            gradient_checkpointing=False, warmup_ratio=0.05,
        ),
        eval=EvalConfig(
            debug_window=90, num_frames=16, feature_fps=1.0,
            stride=5, batch=8, max_new_tokens=8, hierarchy_zooms=(1,),
        ),
    )


PRESETS = {
    "stage1_dense": _preset_stage1_dense,
    "synthetic_tiny": _preset_synthetic_tiny,
    "synthetic_tiny_stream": _preset_synthetic_tiny_stream,
    "synthetic_tiny_sparse": _preset_synthetic_tiny_sparse,
    "synthetic_tiny_stage2": _preset_synthetic_tiny_stage2,
    "stage1_sparse": _preset_stage1_sparse,
    "stage1_stream": _preset_stage1_stream,
    "stage2_long_33": lambda: _preset_stage2_long(33),
    "stage2_long_100": lambda: _preset_stage2_long(100),
    "chapters_stage2_100": _preset_chapters_stage2,
}


def get_preset(name: str) -> WorkloadConfig:
    if name not in PRESETS:
        raise KeyError(f"Unknown preset {name!r}; available: {sorted(PRESETS)}")
    return PRESETS[name]()
