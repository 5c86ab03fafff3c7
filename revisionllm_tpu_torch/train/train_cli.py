"""Training entry point.

Counterpart of revisionllm_tpu/train/train_cli.py (itself the reference's
train/train.py:207-415): parse model/data/training flags, assemble the base,
the vision adapter and LoRA by the training_stage machine, build the dataset
and collator, and run the train loop with periodic (async) checkpoints,
auto-resume and the reference-format export.

    python -m revisionllm_tpu_torch.train.train_cli --data_path train.json \\
        --feat_folder feats/ --output_dir out/ [--tiny_model] [--device cpu]
    torchrun --nproc_per_node 4 -m revisionllm_tpu_torch.train.train_cli \\
        --dp 2 --tp 2 --data_path train.json --feat_folder feats/ --output_dir out/

Runs on CUDA unless --device says otherwise. The base is an HF checkpoint
(--model_base: its config.json gives the geometry, the preset the compute
dtype) or a random init from --seed; --quant_base quantizes its layers to
int8 in host RAM before the move to the device (the lm_head stays dense).
--pretrain_clip_adapter / --pretrain_mm_mlp_adapter load a projector,
--stage2_path a PEFT LoRA, merged into the base at training_stage 3 and
frozen beside it otherwise (JAX's train_cli.py:121-198). A stream preset
(data_cfg.stream) trains the streaming-memory loss: paired clips, clip 1's
memory pooled by --memory_type (data/stream.py) at clip 2's <memory>
sentinel. --dp/--fsdp/--tp other than 1 train across the ranks torchrun
starts (JAX's train_cli.py:118,225-232): the global batch is
per_device_batch_size * dp * fsdp, built alike on every rank; the base is
sharded (parallel/sharding.py) and the step is
trainer.make_train_step over the mesh; rank 0 alone logs, saves and exports, and
every rank resumes from the same checkpoint.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from revisionllm_tpu_torch.config import (
    AdapterConfig,
    DataConfig,
    LlamaConfig,
    LoraConfig,
    TrainConfig,
    get_preset,
)
from revisionllm_tpu_torch.data.collator import Collator
from revisionllm_tpu_torch.data.dataset import GroundingDataset
from revisionllm_tpu_torch.data.stream import build_prefix_ids, build_visual_memory
from revisionllm_tpu_torch.models import convert, llama, revisionllm
from revisionllm_tpu_torch.models import lora as lora_mod
from revisionllm_tpu_torch.models.weights import params_from_numpy
from revisionllm_tpu_torch.ops.quant import quantize_llama_params_host
from revisionllm_tpu_torch.parallel import launch
from revisionllm_tpu_torch.parallel import mesh as mesh_lib
from revisionllm_tpu_torch.parallel import sharding as shard_lib
from revisionllm_tpu_torch.train import checkpoint as ckpt_lib
from revisionllm_tpu_torch.train import optimizer as opt_lib
from revisionllm_tpu_torch.train import trainer as trainer_lib
from revisionllm_tpu_torch.utils.device import resolve_device
from revisionllm_tpu_torch.utils.logging import MetricLogger
from revisionllm_tpu_torch.utils.testing import FakeTokenizer


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="revisionllm_tpu_torch training")
    p.add_argument("--preset", type=str, default="stage1_dense")
    p.add_argument("--quant_base", action="store_true",
                   help="freeze the backbone as int8 (QLoRA-style), lm_head dense")
    p.add_argument("--model_base", type=str, default=None,
                   help="HF Vicuna dir; random init if omitted")
    p.add_argument("--stage2_path", type=str, default=None)
    p.add_argument("--pretrain_mm_mlp_adapter", type=str, default=None)
    p.add_argument("--pretrain_clip_adapter", type=str, default=None)
    p.add_argument("--data_path", type=str, required=True)
    p.add_argument("--feat_folder", type=str, required=True)
    p.add_argument("--q_feat_dir", type=str, default=None)
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--training_stage", type=int, default=None)
    p.add_argument("--num_epochs", type=int, default=None)
    p.add_argument("--per_device_batch_size", type=int, default=None)
    p.add_argument("--learning_rate", type=float, default=None)
    p.add_argument("--dp", type=int, default=1)
    p.add_argument("--fsdp", type=int, default=1)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--max_steps", type=int, default=0, help="override epoch count")
    p.add_argument("--save_steps", type=int, default=500)
    p.add_argument("--log_steps", type=int, default=10)
    p.add_argument("--tiny_model", action="store_true", help="toy geometry for smoke tests")
    p.add_argument("--lora_r", type=int, default=None)
    p.add_argument("--lora_alpha", type=int, default=None)
    p.add_argument("--memory_type", type=str, default=None,
                   choices=["mean_pool", "gt_mean_pool", "gt_multi", "multi_pool"],
                   help="stream memory pooling override (reference train.py:104)")
    p.add_argument("--model_max_length", type=int, default=None,
                   help="override the preset's padded sequence length")
    p.add_argument("--device", type=str, default=None,
                   help="default cuda (raises without a GPU); cpu for a smoke run")
    return p.parse_args(argv)


def build_configs(args):
    wl = get_preset(args.preset)
    train_cfg = wl.train
    data_cfg = wl.data
    overrides = {}
    for name in ("training_stage", "num_epochs", "per_device_batch_size", "learning_rate",
                 "model_max_length", "memory_type"):
        v = getattr(args, name)
        if v is not None:
            overrides[name] = v
    if args.lora_r is not None and train_cfg.lora is not None:
        overrides["lora"] = LoraConfig(**{
            **train_cfg.lora.__dict__,
            "r": args.lora_r,
            "alpha": args.lora_alpha or 2 * args.lora_r,
        })
    if overrides:
        train_cfg = TrainConfig(**{**train_cfg.__dict__, **overrides})
    data_cfg = DataConfig(**{
        **data_cfg.__dict__,
        "data_path": args.data_path,
        "feat_folder": args.feat_folder,
        "q_feat_dir": args.q_feat_dir,
    })
    if args.tiny_model:
        llama_cfg = LlamaConfig(**{**LlamaConfig.tiny().__dict__, "dtype": "float32"})
        adapter_cfg = AdapterConfig(**{
            **wl.adapter.__dict__, "d_model": 16, "ffn_dim": 32,
            "hidden_size": llama_cfg.hidden_size, "num_heads": 4,
        })
    else:
        llama_cfg = wl.model
        adapter_cfg = wl.adapter
    return llama_cfg, adapter_cfg, data_cfg, train_cfg


PREFIX_LEN = 24            # tokens of the stream memory's text prefix


@dataclass
class Run:
    """What a training run is assembled from: configs, the frozen base, the
    trainable and frozen trees, and the data."""

    llama_cfg: LlamaConfig
    adapter_cfg: AdapterConfig
    data_cfg: DataConfig
    train_cfg: TrainConfig
    device: torch.device
    base: Dict[str, Any]
    trainable: Dict[str, Any]
    frozen: Dict[str, Any]
    dataset: GroundingDataset
    collator: Collator
    rng: np.random.Generator   # the dataset's draws, then the epoch order

    def batch(self, indices) -> Dict[str, torch.Tensor]:
        """The collated items at `indices` (host_batch), on the run's device."""
        return {k: torch.as_tensor(v, device=self.device) for k, v in
                self.host_batch(indices).items()}

    def host_batch(self, indices) -> Dict[str, np.ndarray]:
        """The collated items at `indices` as host arrays. A stream batch
        (JAX's train_cli.py:262-283) flattens clip 2 into 'c2_' keys and adds
        clip 1's `visual_memory` (drawn from the run's rng) and the
        `prefix_ids`."""
        b = self.collator([self.dataset[i] for i in indices])
        b.pop("iteration_step", None)
        if self.data_cfg.stream:
            clip2 = b.pop("clip2")
            neg = b.pop("neg")
            clip2.pop("neg", None)
            sef = b.get("start_end_frame", np.zeros((len(indices), 2), np.int32))
            b["visual_memory"] = build_visual_memory(b["images"], sef, neg,
                                                     self.train_cfg.memory_type, self.rng)
            b["prefix_ids"] = build_prefix_ids(neg, self.dataset.tokenizer, PREFIX_LEN)
            for k, v in clip2.items():
                if k not in ("start_end_frame", "query_feats", "query_valid"):
                    b[f"c2_{k}"] = v
        b.pop("start_end_frame", None)
        return b


def base_from_checkpoint(model_base: str, llama_cfg: LlamaConfig, quant_base: bool, device):
    """(llama_cfg, base) from an HF checkpoint directory: the geometry from
    its config.json with `llama_cfg`'s compute dtype, the weights converted
    to f32 host arrays, quantized there when `quant_base` (int8 layers, f32
    scales, the lm_head dense), then moved to `device` in that dtype."""
    llama_cfg = LlamaConfig(**{**convert.llama_config_from_hf(model_base).__dict__,
                               "dtype": llama_cfg.dtype})
    base = convert.convert_llama(convert.load_hf_llama_state(model_base), llama_cfg)
    if quant_base:
        base = quantize_llama_params_host(base, quantize_lm_head=False)
    return llama_cfg, params_from_numpy(base, device, llama.torch_dtype(llama_cfg.dtype))


def assemble(llama_cfg, adapter_cfg, data_cfg, train_cfg, device, seed: int,
             quant_base: bool, model_base: Optional[str] = None,
             projector: Optional[str] = None, stage2_path: Optional[str] = None,
             tokenizer=None) -> Run:
    """Model assembly (reference train.py:251-318,348-364) and data: the
    base from `model_base` (base_from_checkpoint; the adapter's output
    width follows it) or made from `seed` (int8 layers with a dense lm_head
    when `quant_base`); the vision adapter from the `projector` file
    (mm_projector.bin or a stage's non_lora_trainables.bin) or from seed + 1;
    the LoRA of `stage2_path`, merged into the base at training_stage 3, else
    frozen beside it; the stage machine's trainable and frozen trees (a fresh
    LoRA from seed + 2); the dataset and the collator. The dataset tokenizes
    with `tokenizer`, else the checkpoint's (transformers' AutoTokenizer), or
    the FakeTokenizer without a checkpoint."""
    dtype = llama.torch_dtype(llama_cfg.dtype)
    if model_base is not None:
        llama_cfg, base = base_from_checkpoint(model_base, llama_cfg, quant_base, device)
        adapter_cfg = adapter_cfg.with_hidden(llama_cfg.hidden_size)
        if tokenizer is None:
            from transformers import AutoTokenizer

            tokenizer = AutoTokenizer.from_pretrained(model_base, use_fast=True)
    else:
        base = llama.init_params(llama_cfg, seed=seed, dtype=dtype, device=device,
                                 quantize=quant_base, quantize_lm_head=False)
        tokenizer = tokenizer if tokenizer is not None else FakeTokenizer()
    if projector is not None:
        tree = convert.convert_projector(convert._load_torch_state(projector), adapter_cfg)
        vision = params_from_numpy({"mm_projector": tree}, device, dtype)
    else:
        vision = revisionllm.init_vision_params(
            adapter_cfg, seed=seed + 1, d_in=adapter_cfg.d_model, dtype=dtype, device=device
        )
    prior_lora = None
    if stage2_path is not None:
        tree, prior_cfg = convert.convert_peft_lora(stage2_path, llama_cfg)
        prior_lora = params_from_numpy(tree, device)
        if train_cfg.training_stage == 3:
            base = lora_mod.merge(base, prior_lora, prior_cfg)
            prior_lora = None
    lora_gen = torch.Generator(device=device).manual_seed(seed + 2)
    trainable, frozen = trainer_lib.build_trainable(llama_cfg, train_cfg, vision, lora_gen,
                                                    prior_lora)
    rng = np.random.default_rng(seed)
    dataset = GroundingDataset(
        data_cfg.data_path, tokenizer, data_cfg, rng=rng,
        model_max_length=train_cfg.model_max_length,
    )
    mem_tokens = 5 if train_cfg.memory_type in ("gt_multi", "multi_pool") else 1
    collator = Collator(
        max_len=train_cfg.model_max_length, num_video_tokens=0, max_q_len=data_cfg.max_q_l,
        num_memory_tokens=(PREFIX_LEN + mem_tokens) if data_cfg.stream else 0,
    )
    return Run(llama_cfg, adapter_cfg, data_cfg, train_cfg, device, base, trainable, frozen,
               dataset, collator, rng)


def main(argv=None, on_step: Optional[Callable[[int, Dict, Dict], None]] = None,
         tokenizer=None):
    """Train, save and export as the flags say. `on_step(step, batch,
    metrics)`, if given, runs after each step (steps count from 1).
    `tokenizer`, when given, replaces AutoTokenizer.from_pretrained of
    --model_base. Returns the run and its optimizer."""
    args = parse_args(argv)
    llama_cfg, adapter_cfg, data_cfg, train_cfg = build_configs(args)
    mesh = None
    if (args.dp, args.fsdp, args.tp) != (1, 1, 1):
        launch.initialize_distributed(device=args.device)
        mesh = mesh_lib.create_mesh(args.dp, args.fsdp, args.tp)
    run = assemble(llama_cfg, adapter_cfg, data_cfg, train_cfg, resolve_device(args.device),
                   args.seed, args.quant_base, model_base=args.model_base,
                   projector=args.pretrain_clip_adapter or args.pretrain_mm_mlp_adapter,
                   stage2_path=args.stage2_path, tokenizer=tokenizer)
    if mesh is not None:
        run.base = shard_lib.shard_params(mesh, run.base, shard_lib.llama_param_specs(run.base))
    logger = (MetricLogger(os.path.join(args.output_dir, "train_log.jsonl"))
              if launch.is_main_process() else None)
    global_batch = train_cfg.per_device_batch_size * args.dp * args.fsdp
    steps_per_epoch = max(len(run.dataset) // global_batch, 1)
    total_steps = args.max_steps or steps_per_epoch * train_cfg.num_epochs

    # --- resume (reference train.py:394-397) ---
    start_step = 0
    opt_state = None
    latest = ckpt_lib.latest_checkpoint(args.output_dir)
    if latest is not None:
        restored = ckpt_lib.restore_checkpoint(latest, {"trainable": run.trainable})
        run.trainable = restored["trainable"]
        for t in trainer_lib.tree_leaves(run.trainable):
            t.requires_grad_(True)
        opt_state = restored["opt_state"]
        start_step = int(restored["step"])
        print(f"resumed from {latest} at step {start_step}", file=sys.stderr)
    optimizer = opt_lib.AdamW(trainer_lib.tree_leaves(run.trainable), train_cfg, total_steps)
    if opt_state is not None:
        optimizer.load_state_dict(opt_state)
    step_fn = trainer_lib.make_train_step(run.llama_cfg, run.adapter_cfg, train_cfg, optimizer,
                                          stream=data_cfg.stream, mesh=mesh)

    # --- loop ---
    gen = torch.Generator(device=run.device).manual_seed(args.seed + 3)
    order = run.rng.permutation(len(run.dataset))
    t_last = time.time()
    for step in range(start_step, total_steps):
        batch = run.batch([int(order[(step * global_batch + j) % len(run.dataset)])
                           for j in range(global_batch)])
        metrics = step_fn(run.trainable, run.frozen, run.base, batch, gen)
        if on_step is not None:
            on_step(step + 1, batch, metrics)
        if logger is not None and ((step + 1) % args.log_steps == 0
                                   or step == total_steps - 1):
            dt = time.time() - t_last
            t_last = time.time()
            logger.log(
                step=step + 1,
                loss=float(metrics["loss"]),
                grad_norm=float(metrics["grad_norm"]),
                sec_per_step=dt / args.log_steps,
            )
        if (step + 1) % args.save_steps == 0 or step == total_steps - 1:
            ckpt_lib.save_checkpoint(
                args.output_dir,
                {"trainable": run.trainable, "opt_state": optimizer.state_dict(),
                 "step": step + 1},
                step + 1,
                block=False,
            )
    ckpt_lib.wait_for_checkpoints()

    # --- final reference-format artifacts (train.py:402-412) ---
    vision_tree = run.trainable.get("vision", run.frozen.get("vision"))
    ckpt_lib.export_reference_artifacts(
        args.output_dir,
        run.trainable.get("lora"),
        train_cfg.lora,
        vision={"mm_projector": vision_tree["mm_projector"]} if vision_tree else None,
    )
    launch.barrier()  # the files exist for every rank once main returns
    print("training done", file=sys.stderr)
    return run, optimizer


if __name__ == "__main__":
    main()
