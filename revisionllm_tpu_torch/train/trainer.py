"""Training runtime: the LoRA stage machine, the loss and the train step.

Counterpart of revisionllm_tpu/train/trainer.py. PyTorch runs eagerly, so
the step is a function that runs the loss, its backward and the optimizer
update, and changes the trainable tensors in place; there is no jit.
Gradient checkpointing is `remat=True` on the layer loop.
With `mesh=`, the same step runs as one rank of a mesh
(parallel/mesh.py): the base sharded by parallel/sharding.py, the trainable
tree whole on every rank, the gradients summed over the ranks that share
them.

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
from revisionllm_tpu_torch.parallel import comm

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


def make_loss_fn(llama_cfg: LlamaConfig, adapter_cfg: AdapterConfig, train_cfg: TrainConfig,
                 iteration_step: int = 0, mesh=None):
    """loss_fn(trainable, frozen, base_params, batch, generator) -> scalar
    loss, in training mode (adapter dropout from `generator`), inside the
    exact trace. `iteration_step` selects the 'alternate' adapter's output
    (CLS tokens on even steps, frame tokens on odd ones): one loss per
    parity, as JAX builds one program per parity (trainer.py:95-103).
    mesh: this rank's share of the loss (revisionllm.forward_train)."""
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
                remat=train_cfg.gradient_checkpointing, iteration_step=iteration_step,
                mesh=mesh,
            )

    return loss_fn


def make_stream_loss_fn(llama_cfg: LlamaConfig, adapter_cfg: AdapterConfig,
                        train_cfg: TrainConfig, mesh=None):
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
        prefix_emb = llama.embed_tokens(base_params, batch["prefix_ids"], mesh)
        memory_tokens = torch.cat([prefix_emb.to(mem_tokens.dtype), mem_tokens], dim=1)
        plan2 = {k: batch[f"c2_{k}"] for k in PLAN_KEYS}
        with _dequant_trace():
            loss = revisionllm.forward_train(
                llama_cfg, adapter_cfg, base_params, vision, plan2, batch["c2_images"],
                memory_tokens=memory_tokens, lora=lora, lora_scale=lscale,
                deterministic=False, generator=generator,
                remat=train_cfg.gradient_checkpointing, mesh=mesh,
            )
            if train_cfg.stream_loss == "double":
                plan1 = {k: batch[k] for k in PLAN_KEYS}
                loss = loss + revisionllm.forward_train(
                    llama_cfg, adapter_cfg, base_params, vision, plan1, batch["images"],
                    lora=lora, lora_scale=lscale, deterministic=False, generator=generator,
                    remat=train_cfg.gradient_checkpointing, mesh=mesh,
                )
        return loss

    return loss_fn


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """The global L2 norm of `grads`, in f32."""
    return torch.sqrt(sum(g.float().pow(2).sum() for g in grads))


def make_grad_fn(llama_cfg: LlamaConfig, adapter_cfg: AdapterConfig, train_cfg: TrainConfig,
                 stream: bool = False, iteration_step: int = 0, mesh=None):
    """grad_fn(trainable, frozen, base_params, batch, generator, params) ->
    (loss, grads): the batch's loss (the streaming-memory loss when
    `stream`) and its gradients with respect to `params` (leaves of
    `trainable`), both inside the exact trace (the remat recomputation runs
    in the backward). `iteration_step` goes to make_loss_fn.

    With a `mesh`, this is one rank of it: `base_params` are this rank's
    shards (parallel.sharding.shard_params over llama_param_specs), the
    trainable and frozen trees and `batch` are whole on every rank, and
    `generator` is in the same state on every rank. Each rank's loss is its
    rows' share of the batch's mean (the batch splits over the (data, fsdp)
    axes; models/revisionllm.forward_train), so its gradients are shares
    too: a LoRA leaf's are summed over every rank (a rank also sees only its
    tensor slice of the base), the adapter's over the batch axes (it is
    replicated over tensor, whose ranks compute the same gradient), one
    all-reduce a dtype. The loss and gradients are then the whole batch's,
    equal on every rank."""
    if stream:
        loss_fn = make_stream_loss_fn(llama_cfg, adapter_cfg, train_cfg, mesh)
    else:
        loss_fn = make_loss_fn(llama_cfg, adapter_cfg, train_cfg, iteration_step, mesh)

    def reduce(grads, axis):
        if mesh.axis_size(axis) == 1 or not grads:
            return
        for dt in sorted({g.dtype for g in grads}, key=str):
            part = [g for g in grads if g.dtype == dt]
            flat = comm.all_reduce(torch.cat([g.reshape(-1) for g in part]), mesh, axis)
            for g, f in zip(part, flat.split([g.numel() for g in part])):
                g.copy_(f.view_as(g))

    def grad_fn(trainable, frozen, base_params, batch, generator, params):
        with _dequant_trace():
            loss = loss_fn(trainable, frozen, base_params, batch, generator)
            # a parameter the batch does not reach (the T2V encoder without
            # query features) gets a zero gradient, as under jax.grad
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        loss = loss.detach()
        if mesh is not None:
            grads = [g.contiguous() for g in grads]
            lora_ids = {id(t) for t in tree_leaves(trainable.get("lora", {}))}
            reduce([g for p, g in zip(params, grads) if id(p) in lora_ids], "world")
            reduce([g for p, g in zip(params, grads) if id(p) not in lora_ids], "batch")
            if mesh.axis_size("batch") > 1:
                loss = comm.all_reduce(loss.clone(), mesh, "batch")
        return loss, grads

    return grad_fn


def make_train_step(llama_cfg: LlamaConfig, adapter_cfg: AdapterConfig,
                    train_cfg: TrainConfig, optimizer, stream: bool = False,
                    iteration_step: int = 0, mesh=None):
    """train_step(trainable, frozen, base_params, batch, generator) ->
    {"loss", "grad_norm"} (0-d f32 tensors on the device): make_grad_fn's
    loss and gradients, then `optimizer` (train/optimizer.py, built over the
    trainable leaves) updates them in place. With a `mesh` the gradients are
    equal on every rank, so each rank's optimizer (its Adam state
    replicated, not sharded) makes the same update and the trainable trees
    stay equal."""
    grad_fn = make_grad_fn(llama_cfg, adapter_cfg, train_cfg, stream, iteration_step, mesh)

    def train_step(trainable, frozen, base_params, batch, generator):
        loss, grads = grad_fn(trainable, frozen, base_params, batch, generator,
                              optimizer.params)
        gnorm = global_norm(grads)
        with torch.no_grad():
            optimizer.step(grads)
        return {"loss": loss, "grad_norm": gnorm}

    return train_step


def make_sharded_train_step(llama_cfg: LlamaConfig, adapter_cfg: AdapterConfig,
                            train_cfg: TrainConfig, optimizer, mesh, stream: bool = False,
                            iteration_step: int = 0):
    """make_train_step as one rank of `mesh`, under JAX's name
    (trainer.py:221-251, one program over the mesh there)."""
    return make_train_step(llama_cfg, adapter_cfg, train_cfg, optimizer, stream,
                           iteration_step, mesh)
