"""Training runtime: the LoRA stage machine, the loss and the train step.

Counterpart of revisionllm_tpu/train/trainer.py for one GPU. PyTorch runs
eagerly, so the step is a function that runs the loss, its backward and the
optimizer update, and changes the trainable tensors in place; there is no
jit and no mesh (parallel/ waits). Gradient checkpointing is
`remat=True` on the layer loop.

Trainable selection mirrors the reference flags:
- tune_mm_mlp_adapter: only the vision adapter gets grads (train.py:351-357)
- freeze_mm_mlp_adapter: adapter excluded (train.py:359-364)
- LoRA: backbone frozen, adapter matrices trained (lora_enable path)
The streaming-memory loss (`make_stream_loss_fn`) trains clip 2 with clip
1's pooled memory at its <memory> sentinel.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional, Tuple

import torch

from revisionllm_tpu_torch.config import AdapterConfig, LlamaConfig, LoraConfig, TrainConfig
from revisionllm_tpu_torch.models import llama
from revisionllm_tpu_torch.models import lora as lora_mod
from revisionllm_tpu_torch.models import revisionllm
from revisionllm_tpu_torch.models.adapter import linear
from revisionllm_tpu_torch.ops import quant

Params = Dict[str, Any]
PLAN_KEYS = ("text_ids", "kind", "src_idx", "labels", "positions", "lengths")


@contextlib.contextmanager
def _dequant_trace():
    """Send every int8 matmul to the differentiable dequantize-then-matmul
    route while a loss and its backward run (QLoRA: frozen int8 base,
    LoRA/adapter grads): W8A8 off and the exact trace on. K1 and
    torch._int_mm have no backward, and W8A8's rounding would otherwise
    change the numbers of the recomputed (remat) forward."""
    prev, prev_exact = quant._W8A8, quant._EXACT_TRACE
    quant.set_w8a8(False)
    quant.set_exact_trace(True)
    try:
        yield
    finally:
        # restore what was set before, so that nested uses (the train step
        # around the loss) keep the trace on until the outermost one ends
        quant.set_w8a8(prev)
        quant.set_exact_trace(prev_exact)


def tree_leaves(tree) -> List[torch.Tensor]:
    """Tensors of a nested dict / list tree, in a fixed order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def build_trainable(
    llama_cfg: LlamaConfig,
    train_cfg: TrainConfig,
    vision_params: Params,
    generator: torch.Generator,
    prior_lora: Optional[Params] = None,
) -> Tuple[Params, Params]:
    """Apply the training_stage state machine (trainer.py:56-92).

    Returns (trainable, frozen_extra), trainable leaves with requires_grad
    set and frozen ones without:
    - stage 1 (+ a prior LoRA): prior LoRA frozen, adapter trainable
    - stage 2: fresh LoRA + adapter trainable
    - stage 3: the caller merges the prior LoRA into the base first
      (lora.merge), then a fresh LoRA here
    - stage 4: continue training the prior LoRA
    A fresh LoRA is drawn from `generator` on its device."""
    stage = train_cfg.training_stage
    trainable: Params = {}
    frozen: Params = {}

    if train_cfg.tune_mm_mlp_adapter or not train_cfg.freeze_mm_mlp_adapter:
        trainable["vision"] = vision_params
    else:
        frozen["vision"] = vision_params

    if train_cfg.lora is not None and not train_cfg.tune_mm_mlp_adapter:
        if stage == 4 and prior_lora is not None:
            trainable["lora"] = prior_lora
        elif stage == 1 and prior_lora is not None:
            frozen["lora"] = prior_lora
        else:  # stage 2 or 3: fresh adapter
            trainable["lora"] = lora_mod.init_lora(llama_cfg, train_cfg.lora, generator)
    elif prior_lora is not None:
        frozen["lora"] = prior_lora

    for t in tree_leaves(trainable):
        t.requires_grad_(True)
    for t in tree_leaves(frozen):
        t.requires_grad_(False)
    return trainable, frozen


def make_loss_fn(llama_cfg: LlamaConfig, adapter_cfg: AdapterConfig, train_cfg: TrainConfig):
    """loss_fn(trainable, frozen, base_params, batch, generator) -> scalar
    loss, in training mode (adapter dropout from `generator`), inside the
    exact trace."""
    lora_cfg = train_cfg.lora or LoraConfig()
    scale = lora_mod.lora_scale(lora_cfg)

    def loss_fn(trainable, frozen, base_params, batch, generator):
        lora = trainable.get("lora", frozen.get("lora"))
        vision = trainable.get("vision", frozen.get("vision"))
        plan = {k: batch[k] for k in PLAN_KEYS}
        with _dequant_trace():
            return revisionllm.forward_train(
                llama_cfg, adapter_cfg, base_params, vision, plan, batch["images"],
                query_feats=batch.get("query_feats"), query_valid=batch.get("query_valid"),
                memory_tokens=batch.get("memory_tokens"), lora=lora,
                lora_scale=scale if lora is not None else 0.0,
                deterministic=False, generator=generator,
                remat=train_cfg.gradient_checkpointing,
            )

    return loss_fn


def make_stream_loss_fn(llama_cfg: LlamaConfig, adapter_cfg: AdapterConfig,
                        train_cfg: TrainConfig):
    """Streaming-memory loss (reference vtimellm_trainer.compute_loss
    :67-133, JAX's trainer.py:142-190): clip 2's forward sees [prefix text,
    pooled clip-1 memory] tokens at its <memory> sentinel; stream_loss
    'double' adds clip 1's own loss.

    Batch layout: clip-1 fields at top level, clip-2 fields prefixed 'c2_',
    plus the host-built `visual_memory` [B, M, d] (data/stream.py) and
    `prefix_ids` [B, P]. The memory goes through the mlp projector in the
    promoted type (JAX's f32 @ bf16), the prefix through embed_tokens."""
    lora_cfg = train_cfg.lora or LoraConfig()
    scale = lora_mod.lora_scale(lora_cfg)

    def loss_fn(trainable, frozen, base_params, batch, generator):
        lora = trainable.get("lora", frozen.get("lora"))
        vision = trainable.get("vision", frozen.get("vision"))
        lscale = scale if lora is not None else 0.0
        mem_tokens = linear(vision["mm_projector"], batch["visual_memory"])  # [B, M, D]
        prefix_emb = llama.embed_tokens(base_params, batch["prefix_ids"])
        memory_tokens = torch.cat([prefix_emb.to(mem_tokens.dtype), mem_tokens], dim=1)
        plan2 = {k: batch[f"c2_{k}"] for k in PLAN_KEYS}
        with _dequant_trace():
            loss = revisionllm.forward_train(
                llama_cfg, adapter_cfg, base_params, vision, plan2, batch["c2_images"],
                memory_tokens=memory_tokens, lora=lora, lora_scale=lscale,
                deterministic=False, generator=generator,
                remat=train_cfg.gradient_checkpointing,
            )
            if train_cfg.stream_loss == "double":
                plan1 = {k: batch[k] for k in PLAN_KEYS}
                loss = loss + revisionllm.forward_train(
                    llama_cfg, adapter_cfg, base_params, vision, plan1, batch["images"],
                    lora=lora, lora_scale=lscale, deterministic=False, generator=generator,
                    remat=train_cfg.gradient_checkpointing,
                )
        return loss

    return loss_fn


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """The global L2 norm of `grads`, in f32."""
    return torch.sqrt(sum(g.float().pow(2).sum() for g in grads))


def make_train_step(llama_cfg: LlamaConfig, adapter_cfg: AdapterConfig,
                    train_cfg: TrainConfig, optimizer, stream: bool = False):
    """train_step(trainable, frozen, base_params, batch, generator) ->
    {"loss", "grad_norm"} (0-d f32 tensors on the device). The loss (the
    streaming-memory loss when `stream`) and its backward both run inside
    the exact trace (the remat recomputation runs in the backward);
    `optimizer` (train/optimizer.py, built over the trainable leaves) then
    updates them in place."""
    make = make_stream_loss_fn if stream else make_loss_fn
    loss_fn = make(llama_cfg, adapter_cfg, train_cfg)

    def train_step(trainable, frozen, base_params, batch, generator):
        params = optimizer.params
        with _dequant_trace():
            loss = loss_fn(trainable, frozen, base_params, batch, generator)
            # a parameter the batch does not reach (the T2V encoder without
            # query features) gets a zero gradient, as under jax.grad
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        gnorm = global_norm(grads)
        with torch.no_grad():
            optimizer.step(grads)
        return {"loss": loss.detach(), "grad_norm": gnorm}

    return train_step
