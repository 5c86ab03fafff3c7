#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (revisionllm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Every run goes through every phase, so every number it prints was
measured in that run. Phases:
  1. the card's name and power limit (nvidia-smi);
  2. build the twelve CUDA kernels (rows 4 and 5 share one __global__) from
     the eight sources in csrc/, and the W8A8 prefill's three from a ninth
     (csrc/w8a8_gemm.cu) (one nvcc per source, all in parallel; rows 9
     and 10 share csrc/decode_common.cuh, K2 and rows 4-6
     csrc/attention_common.cuh), and print each kernel's registers, shared
     memory and spill bytes from ptxas (fails if an attention kernel, K1,
     row 7, one of row 8's three kernels or one of the W8A8 prefill's
     spills);
  3. each kernel against its plain PyTorch version on the card, at the
     stage-1 shapes (Vicuna-7B, chunk of 64 windows): max error against the
     stated tolerance, device time of the kernel, of the plain version and of
     one PyTorch library call for the same function, and the least time the
     H100 SXM data sheet allows (3.35 TB/s; 989 TFLOP/s bf16); K1
     (int8_matmul) at the decode step's four shapes by the limits of phase 7
     per (64-row, 128-column) block, with two planted faults that must fail,
     bit-identical over two calls, one kernel launch with no workspace per
     call, and at the edge cases K1_EDGES; K3 (decode_attention) at steps 0
     and 11 by the same limits per (row, head) vector, with two planted
     faults that must fail them (k3_faults), bit-identical over two calls,
     and so again with a bf16 prompt cache, with GQA, at 4096 positions, at
     phase 15's streaming chat step (B 1, its 64-token gen cache) and at
     ChatGLM2-6B's decode step (group 16: 32 query heads over 2 kv heads,
     B 8, 300 prompt and 128 prefix positions, the last of 12 steps; timed,
     with its bound and SDPA over the dequantized cache with grouped heads,
     approximate; and at one kv head, ChatGLM2's rank under tensor
     parallelism 2);
  4. the slice: GroundingEngine.ground_windows on a 1-hour movie (18 000
     frames of 768-d features, 57 windows of 250 frames in one chunk of 64,
     12 greedy tokens) with Vicuna-7B int8 weights made from a seed at full
     depth; windows/s, q/s, chunk latency, peak memory, and each kernel's
     launches in one run (fails if a kernel was never launched);
  5. the kernel path on the card against the plain path on the CPU, at full
     width and 2 layers from the same seed: first-step logits and greedy
     tokens;
  6. where one chunk's time goes, on the slice's engine: for the adapter,
     the prefill and a decode step, the wall time, the host's time to
     enqueue it and the device's busy time (summed kernel time under
     torch.profiler); then one ground_windows under the profiler, its kernel
     time grouped by hand-written kernel, library
     GEMM and the rest, and the device's idle share;
  7. the row-4 kernels (forward with LSE, dq, dk/dv) against their plain
     versions at the training shape (B = 1, H = 32, T = S = 2048, d = 128,
     causal), at full length and at a ragged kv_len of 330 (both recorded:
     the ragged numbers as the record, the full ones under "full"): the
     relative L2 error of each whole output and of each of its (64-row
     tile, head) blocks against stated limits, two planted faults on the
     kernels' 64-row tiles that must fail those limits, device times, the
     data-sheet bound, and SDPA's forward and backward as the yardstick;
     then K2 and row 4 against their plain versions, correctness only, on
     the edge cases EDGE_CASES (kv_len 1, 63, 64, 65, 127, 128, 129; T 2000;
     GQA 32 over 8; not causal);
  8. the training slice through its entry point, train_cli.main: QLoRA at
     Vicuna-7B width and depth (the stage1_dense preset: int8 frozen base
     made from a seed, dense bf16 lm_head, LoRA r 64 on all seven linears,
     the ClipEncoder adapter with T2V, remat, batch 1, sequence 2048) over
     the synthetic corpus, 1 warm-up and 6 timed steps: step time,
     tokens/s, peak memory, loss and grad norm per step, each row-4
     kernel's launches (fails if one is 0, or if K1, K2, K3, the W8A8
     kernels or torch._int_mm ran), the log, the async checkpoint main
     saved against the trained trees, and the export; one step under the
     profiler;
     auto-resume for one more step; the no-silent-detach rule on the card;
  9. one train step with the kernels on the card against the plain path on
     the CPU, from train_cli's assembly at full width, 2 layers and
     sequence 2048: the loss and the gradient of every trainable leaf
     (LoRA and the adapter);
 10. the shared-prefix prefill's kernels, row 6 (prefix + causal
     attention) and row 5 (the LSE forward for any kv length), at the
     stage-1 shape (B 64, the prompt's prefix P, the rest T2, ragged
     rest_lens) and the stage-2 shape (B the row bucket): row 6 against its
     plain version and against the merge of two row-5 launches, row 5
     against its plain version, by the limits of phase 7, with two planted
     faults that must fail (the prefix's last tile dropped, the last causal
     tile x0.9), device times, bounds and SDPA; then the fused recursive
     pipeline at Vicuna-7B width and depth on the 1-hour movie, through
     stage1.run -> stage2.run --grounding_path -> fusion.main for 3 queries
     (both engines on one int8 base tree), with REVISIONLLM_SHARED_PREFIX
     unset and then 1: per-query latency of each stage and of the whole,
     q/s, the stage-2 passes and row bucket, peak memory and each stage's
     launches (fails if K1-K3 never ran, or row 6 never ran in either stage
     with the switch on); then one call of each stage with the shared
     prefix against the full prefill: first-step logits, greedy tokens and
     where the call's time goes;
 11. stage-2 retrieve and its shared-prefix prefill with the kernels on the
     card against the plain path on the CPU, at full width, 2 layers and
     one seed, on a 10-minute movie: first-step logits and answers;
 12. rows 7 (int4_matmul, at the decode step's four shapes), 8
     (w8a8_mlp_fused, at the prefill's M = 64 x T, K 4096, N 11008), 9
     (decode_step_fused, B 64 on the slice's weights) and 10
     (decode_step_serve, B 64 on the slice's weights packed into the serving
     chunks, a unified slab at step 11) against their plain versions by the
     limits of phase 7 (rows 9 and 10 at 2 layers, and their 32-layer gap),
     each with planted faults that must fail, device times, bounds and a
     yardstick (torch.matmul on the dequantized weight; two torch._int_mm
     and the epilogue; the split decode step; row 9 on the standard tree
     and the split step on the packed tree; each split step's time by CUDA
     events, which the host paces, and its device-busy time under
     torch.profiler); rows 9 and 10 bit-identical over two calls at 32
     layers; row 7 also at the edge cases
     Q4_EDGES, bit-identical over two calls, and one kernel launch with no
     workspace per call (read from the profiler and the allocator); row 8
     also at the edge cases MLP_EDGES, bit-identical over two calls, its
     three launches a call (transpose, GEMM, requantization) and the
     scratch its wrapper names, each part's time, and a second yardstick
     (the two torch._int_mm without the epilogue); and the W8A8 prefill's
     kernels (csrc/w8a8_gemm.cu: row quantizer, weight transpose, int8
     GEMM with the scales and the bf16 cast in its epilogue) at the
     benchmark cells' shapes (M = 64 x 304; ChatGLM2-6B's and
     DeepSeek-LLM-7B's seven matrices, the prompt cache's rows of 128) bit
     for bit against the PyTorch route they replace, with a planted fault
     each, the edge cases W8A8_EDGES at both tile widths, launches and
     allocations a call, each kernel's time beside its bound, the plain
     version and torch._int_mm with and without its PyTorch epilogue;
 13. configurations A (int8, REVISIONLLM_FUSED_MLP=1 and
     REVISIONLLM_MEGAKERNEL=1), B (int4 weights) and C (the int8 tree packed
     into the serving chunks, REVISIONLLM_SERVE=1) through ground_windows
     on the 1-hour movie at Vicuna-7B width and depth: chunk latency, q/s,
     peak memory, launches (fails unless A gives 32 row-8 and 11 row-9
     launches and no K3, B 2476 row-7 launches, and C 11 row-10, 12 K1 and
     32 K2 launches and no K3, row 8 or row 9), prefill and decode-step
     wall, enqueue and busy ms; then each against the CPU as in phase 5 (C
     on both sides through the serve path, the CPU's through row 10's plain
     version).

 14. the HF checkpoint loader through its entry point: a random Llama at
     Vicuna-7B width and 4 layers (the rest of the configuration uncut)
     written as an HF directory of two fp16 .safetensors shards and a
     config.json, and a stage directory from the port's exporter (LoRA r 64
     on q/k/v/o, the ClipEncoder T2V adapter); eval.loader.
     build_engine_from_args on stage1.parse_args' flags, then stage1.run over
     the 1-hour movie (3 queries, 57 windows each), with REVISIONLLM_QUANT
     unset (the CUDA default, int8) and then REVISIONLLM_SERVE=1: each
     loader step's seconds, the checkpoint's GB/s, peak memory and launches
     (fails unless K1, K2, K3 and the W8A8 kernels ran in the first, and
     torch._int_mm did not, and row 10, K1 and K2 in the second); every
     loaded leaf torch.equal to the tree
     built in memory without the files (the same LoRA merge, bf16 rounding
     and host quantization), the JSONL records equal to that tree's
     engine's, the first-step logits within relative L2 1e-2; a checkpoint
     with layer 0's q_proj written untransposed must fail the tree check
     and read above the logits limit;
 15. the serving surfaces and training from a checkpoint, through the entry
     points a user calls, at Vicuna-7B width and depth on the slice's int8
     weights: inference.inference on one 100-frame window (B 1, then B 8
     with return_list; 64 greedy tokens): wall ms, launches and peak memory
     (fails unless K1, K2 and K3 ran, and the W8A8 kernels where the prefill
     has more rows than K1 takes); inference_stream on the same window: the
     time to the first token, the wall ms a token, and over the stream's
     first 16 decode steps (under torch.profiler, less its first token)
     the device-busy ms and launches a token (fails
     unless the streamed tokens equal generate's greedy tokens and the last
     string inference's answer; on a difference it prints the first step's
     top-2 logits of both); webdemo.DemoServer on 127.0.0.1 over a demo.ChatSession: a .npy
     uploaded and two turns asked over HTTP must stream the answers
     ChatSession.ask gives on a fresh session; caption_windows over the
     1-hour movie (57 windows, 64 tokens); msrvtt.run over a corpus at
     MSR-VTT 1k-A's geometry written from a seed (1000 clip tracks sampled
     to 100 x 768, 3 queries, the hierarchy cls adapter, batch 100: 10
     passes a query), per-query latency and launches, a full finite ranking
     per query and result_t2v.json, then retrieve_videos' scoring with each
     pass's answer planted as 'In video p' against the CPU's cosines (random
     weights rarely answer with a number); inference and one
     retrieve_videos query on the card against the CPU at 2 layers (every
     step's logits within 5% of the largest, the greedy tokens equal at
     every step but a bf16 tie, after which the steps are not held); then train_cli.main from phase 14's checkpoint directory
     (--model_base, --quant_base, --pretrain_clip_adapter on its stage
     directory, phase 8's corpus and flags), 1 + 3 steps: step ms, tokens/s,
     peak memory, row 4's launches a step (fails unless the losses are
     finite, row 4 ran, and the assembled base equals the loader's tree leaf
     for leaf), and the run's export served by build_engine_from_args and
     stage1.run on one query.
 16. the rest of training and raw video, at Vicuna-7B width and depth
     (weights from a seed): train_cli.main with the stage2_long_100 preset
     (stage-2 hierarchy training at TRAIN_STAGE2.json's geometry: 100
     windows x 250 frames of phase 8's corpus a step, --quant_base, batch
     1, sequence 256) and with the stage1_stream preset (the
     streaming-memory loss: the mlp projector, 250 frames, mean_pool, over
     a stream corpus at 768-d and 5 fps), 1 warm-up and 3 timed steps each:
     step ms, windows/s, frames/s, peak memory, each row-4 kernel's
     launches a step (fails unless the losses are finite, all three row-4
     kernels ran and K1, K2, K3, the W8A8 kernels and torch._int_mm did
     not); one stage-2
     step on a prebuilt batch under torch.profiler (busy against wall);
     DevicePrefetcher over the stage-2 batches (equal, on the card, in
     order; the host's wait, each step's wall and the loop's whole time
     with and without it); one step of stage2_long_33 (33 windows, the
     stage-2 compare's cut) and one stream step ('double', --memory_type
     gt_multi, padded to 512) on the card against the CPU at 2 layers by
     phase 9's limits, on one base (fails unless clip 2's plan holds
     24 + 5 memory rows); a CLIP checkpoint at ViT-L/14's geometry written
     from a seed in HF's layout and a 60 s .y4m (25 fps, 320 x 240):
     extract_video_features at 5 fps and extract_text_features for 3
     queries into RVFS stores (decode s, encode ms a frame, frames/s, peak
     memory), both read back through the native reader (which
     open_store_native must choose) equal to the Python reader, 4 frames
     and the 3 texts on the card against the CPU (relative L2 1e-4); and
     demo.main from the .y4m with --clip_path on phase 14's checkpoint,
     one question on stdin (the 100 features it encoded must equal, within
     1e-4, those of its own decode at 1 fps, linspace sampling and the
     card's encoder, and K1, K2 and K3 must have run), then demo.main on a
     .npy of those features: the two must generate the same token ids.
 17. the chapters adapter and the adapter's other modes: stage-2 retrieve
     at the chapters_stage2_100 preset (the cross_attn ClipEncoder at the
     LLM's width, its query through text_proj, the identity projector) over
     100 windows of 250 frames (500 s at 2 fps) of hidden-wide features
     from a seed, at Vicuna-7B width and depth with int8 weights: ms a query,
     the adapter's ms and memory, launches (fails unless K1, K2 and K3 ran);
     the same at 2 layers against the CPU (8 windows of 32 frames, 100 window
     tokens a pass: first-step logits within 5% of the largest); one
     'alternate' train step at each parity with the linformer and the
     performer self-attention on the T2V layers against the CPU at 2 layers
     by phase 9's limits; its time against a budget of 90 s;
 18. ChatGLM2-6B with P-tuning at full width and depth (28 layers, int8
     weights and q/k/v biases from a seed, a 128-position prefix): 8 prompts
     of about 300 tokens from preprocess_glm over a SentencePiece model
     written here, generate for 12 greedy tokens with the prefix and
     without: ms, prefill ms, a decode step's ms, peak memory, launches
     (fails unless K3 ran 28 x 11 times, row 6 28 times with the prefix and
     K2 28 times without); both on the card against the CPU at 2 layers
     (hold_steps); its time against a budget of 120 s.
 19. the distributed layer (revisionllm_tpu_torch/parallel/) on the one
     card: two ranks spawned over gloo, passed explicitly (NCCL refuses
     two ranks on one device), after a check that gloo all-reduces and
     all-gathers CUDA tensors in bf16 and f32; the slice's chunk
     (ground_windows, 57 windows, int8, W8A8 prefill, KV8) cut to
     P19_LAYERS layers under meshes (1,1,2), (2,1,1) and (1,2,1), each
     after the rank's one untimed chunk without a mesh and one small
     collective on each of the mesh's groups, each rank's greedy decode held against
     the one-rank run of the same tree in this process (hold_sharded: under
     (2,1,1) and (1,2,1) the logits, tokens, answers and entropies equal;
     under (1,1,2), whose ranks sum in another order, every step's logits
     within 5% of the largest, tokens equal but at a tie widened by the
     step's logit difference, a tied row not held after, and the other
     windows' answers equal and entropies within 5%); then one 2-layer
     stage-1 QLoRA step (the preset's adapter dropout, drawn alike by every
     rank) at (2,1,1) and (1,1,2), after an untimed one, against the
     one-rank step by phase 9's limits; first, K1, K2, K3, row 4 and row 8
     against their plain versions at the shapes a rank gives them under
     tensor parallelism 2 and 4 (check_sharded_shapes); each rank's chunk
     and step ms, the collectives' count, bytes and ms (gloo
     stages CUDA tensors through the host: no guide to NVLink) and kernel
     launches (fails unless K1, K2 and K3, and the row-4 kernels, ran on
     every rank); its time against a budget of 150 s.

The kernel checks of phases 3, 7, 10 and 12 run first, after the build
(rows 9 and 10 after phase 4, on the slice's weights); phase 13 runs after
phase 6; the pipeline runs after it, then phase 14 and phase 15's serving
part, before training; phase 15's training part runs after phase 8 (whose
corpus it trains on) and phase 9, then phases 16, 17, 18 and 19.
Prints phase lines, then one JSON line of per-kernel numbers, the
nvidia-smi line, and last {"ok": true, "device": {...}}. Exits non-zero,
with no result line, when CUDA is missing, when run outside a checkout of
the repository, or when any phase fails. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from functools import partial
from pathlib import Path

import numpy as np

ITERS = 20                  # timed calls per kernel and shape
RUNS = 3                    # timed ground_windows runs
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
BF16_OPS_PER_S = 989e12     # H100 SXM data sheet, dense
INT8_OPS_PER_S = 1979e12    # H100 SXM data sheet, dense
REPLACES = {
    "int8_matmul": "revisionllm_tpu/ops/quant.py:46",
    "flash_attention": "revisionllm_tpu/ops/flash_attention.py:40",
    "decode_attention": "revisionllm_tpu/ops/decode_attention.py:40",
    "flash_fwd_lse": "revisionllm_tpu/ops/flash_attention.py:352",
    "flash_dq": "revisionllm_tpu/ops/flash_attention.py:415",
    "flash_dkv": "revisionllm_tpu/ops/flash_attention.py:464",
    "flash_attention_lse": "revisionllm_tpu/ops/flash_attention.py:721",
    "flash_attention_prefixed": "revisionllm_tpu/ops/flash_attention.py:859",
    "int4_matmul": "revisionllm_tpu/ops/quant.py:580",
    "w8a8_mlp_fused": "revisionllm_tpu/ops/quant.py:732",
    "decode_step_fused": "revisionllm_tpu/ops/decode_step.py:135",
    "decode_step_serve": "revisionllm_tpu/ops/decode_serve.py:227",
    "w8a8_gemm": "none: JAX leaves W8A8 to XLA's int8 dot (revisionllm_tpu/ops/quant.py w8a8_matmul)",
    "moe_grouped": "none: the JAX package has no mixture of experts",
}
SOURCES = {
    "int8_matmul": "int8_matmul", "flash_attention": "flash_attention",
    "decode_attention": "decode_attention", "flash_fwd_lse": "flash_attention",
    "flash_dq": "flash_attention_vjp", "flash_dkv": "flash_attention_vjp",
    "flash_attention_lse": "flash_attention", "flash_attention_prefixed": "flash_attention",
    "int4_matmul": "int4_matmul", "w8a8_mlp_fused": "w8a8_mlp_fused",
    "decode_step_fused": "decode_step", "decode_step_serve": "decode_serve",
    "w8a8_gemm": "w8a8_gemm", "moe_grouped": "w8a8_gemm",
}
SERVING = ("int8_matmul", "flash_attention", "decode_attention")
W8A8 = ("quantize_rows", "w8a8_transpose", "w8a8_gemm")   # the W8A8 prefill
TRAINING = ("flash_fwd_lse", "flash_dq", "flash_dkv")
PIPELINE = ("flash_attention_lse", "flash_attention_prefixed")
FUSED = ("w8a8_mlp_fused", "decode_step_fused")   # configuration A
INT4 = ("int4_matmul",)                            # configuration B
SERVE = ("decode_step_serve",)                     # configuration C
SENTENCE = "a man opens the old door"
TRAIN_STEPS = 6             # timed train steps after one warm-up


def say(msg: str) -> None:
    print(f"# {msg}", flush=True)


def bound(nbytes: float, ops: float, ops_per_s: float = BF16_OPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_events(prof):
    """The CUDA kernel events of a torch.profiler run (CUPTI's "Command
    Buffer Full" stall records and the device-side ranges of user
    annotations, such as the optimizer's step, are not kernels)."""
    from torch.autograd import DeviceType

    return [e for e in prof.events()
            if e.device_type == DeviceType.CUDA and not e.name.startswith("Command Buffer")
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("Optimizer.")]


# device kernels by what launched them: the hand-written kernels by their
# __global__ names, then the int8 GEMM of the W8A8 prefill (torch._int_mm),
# then the other library GEMMs (the adapter's bf16 products)
KERNEL_GROUPS = (
    ("K1 int8_matmul (q8_matmul, one launch)", r"q8_matmul_kernel"),
    ("K2 flash_attention", r"flash_fwd_kernel"),
    ("K3 decode_attention", r"decode_attn_kernel"),
    ("row 4 flash_fwd_lse", r"flash_fwd_lse_kernel"),
    ("row 4 flash_dq", r"flash_dq_kernel"),
    ("row 4 flash_dkv", r"flash_dkv_kernel"),
    ("row 7 int4_matmul (q4_matmul, one launch)", r"q4_matmul_kernel"),
    ("row 8 w8a8_mlp_fused (transpose + GEMM + requantize)",
     r"mlp_transpose_kernel|mlp_gemm_kernel|mlp_quant_kernel"),
    ("row 9 decode_step_fused", r"step_kernel<.*GenCacheAttn"),
    ("row 10 decode_step_serve", r"step_kernel<.*SlabAttn"),
    ("W8A8 GEMM (torch._int_mm)", r"gemm_s8|s8gemm|imma"),
    ("other library GEMMs", r"gemm|nvjet|xmma|cutlass"),
)
OTHER = "PyTorch elementwise, reductions and copies"


def group_kernels(events):
    """{group: [ms, calls]} over KERNEL_GROUPS then OTHER, and {name: [ms,
    calls]} of the kernels in OTHER. The groups add up to the summed kernel
    time."""
    groups = {label: [0.0, 0] for label, _ in KERNEL_GROUPS}
    groups[OTHER] = [0.0, 0]
    other = {}
    for e in events:
        label = next((lb for lb, pat in KERNEL_GROUPS if re.search(pat, e.name)), OTHER)
        ms = e.device_time_total / 1e3
        groups[label][0] += ms
        groups[label][1] += 1
        if label == OTHER:
            row = other.setdefault(e.name, [0.0, 0])
            row[0] += ms
            row[1] += 1
    return groups, other


def profiled(fn):
    """(fn(), summed kernel ms, kernel events) of one call under
    torch.profiler, synchronised at the end."""
    import torch

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    events = kernel_events(prof)
    return out, sum(e.device_time_total for e in events) / 1e3, events


# the attention kernels, each with the C function of its library that gives
# its dynamic shared memory: (library, function, arguments)
ATTENTION_KERNELS = {
    "flash_fwd_kernel": ("flash_attention", "flash_fwd_smem_bytes", ()),
    "flash_fwd_lse_kernel": ("flash_attention", "flash_fwd_smem_bytes", ()),
    "flash_prefix_kernel": ("flash_attention", "flash_fwd_smem_bytes", ()),
    "flash_dq_kernel": ("flash_attention_vjp", "flash_vjp_smem_bytes", (0,)),
    "flash_dkv_kernel": ("flash_attention_vjp", "flash_vjp_smem_bytes", (1,)),
}


def ptxas_entries(text):
    """[(kernel, registers, static shared bytes, spill-store bytes,
    spill-load bytes)] of each entry function in one `ptxas -v` log."""
    def last_name(mangled):
        # the innermost of the length-prefixed names of an Itanium-mangled
        # symbol: _ZN<len><namespace><len><kernel>E... -> kernel
        i, name = 2 + mangled.startswith("_ZN"), mangled
        while i < len(mangled) and mangled[i].isdigit():
            j = i
            while mangled[j].isdigit():
                j += 1
            n = int(mangled[i:j])
            name, i = mangled[j:j + n], j + n
        return name

    out = []
    for chunk in text.split("Compiling entry function '")[1:]:
        mangled = chunk.split("'", 1)[0]
        regs = re.search(r"Used (\d+) registers", chunk)
        smem = re.search(r"(\d+) bytes smem", chunk)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", chunk)
        out.append((last_name(mangled), int(regs.group(1)) if regs else 0,
                    int(smem.group(1)) if smem else 0,
                    int(spill.group(1)) if spill else 0, int(spill.group(2)) if spill else 0))
    return out


# the kernels that must not spill: the attention kernels, K1's, row 7's,
# row 8's three, K3's at group 16, the W8A8 prefill's three and the two
# grouped expert kernels
ROW8_KERNELS = ("mlp_transpose_kernel", "mlp_gemm_kernel", "mlp_quant_kernel")
NO_SPILL_KERNELS = {**ATTENTION_KERNELS,
                    "q8_matmul_kernel": ("int8_matmul", "q8_matmul_smem_bytes", ()),
                    "q4_matmul_kernel": ("int4_matmul", "q4_matmul_smem_bytes", ()),
                    "decode_attn_kernel_g16": ("decode_attention", "decode_attn_g16_smem_bytes", ()),
                    "mlp_gemm_kernel": ("w8a8_mlp_fused", "w8a8_mlp_smem_bytes", (0,)),
                    "mlp_transpose_kernel": ("w8a8_mlp_fused", "w8a8_mlp_smem_bytes", (1,)),
                    "mlp_quant_kernel": ("w8a8_mlp_fused", "w8a8_mlp_smem_bytes", (2,)),
                    "s8gemm_kernel": ("w8a8_gemm", "w8a8_gemm_smem_bytes", (2,)),
                    "kmajor_transpose_kernel": ("w8a8_gemm", "w8a8_gemm_smem_bytes", (0,)),
                    "quantize_rows_kernel": ("w8a8_gemm", "w8a8_gemm_smem_bytes", (0,)),
                    "moe_w8a8_kernel": ("w8a8_gemm", "w8a8_gemm_smem_bytes", (2,)),
                    "moe_w8a16_kernel": ("int8_matmul", "q8_matmul_smem_bytes", ())}


def report_ptxas(kernels, libs=None):
    """Print the registers, shared memory and spill bytes of every kernel in
    `libs` (default: all) from the build's ptxas reports (the dynamic shared
    memory of NO_SPILL_KERNELS from their libraries); fail if one of
    NO_SPILL_KERNELS in `libs` spills or has no report."""
    import ctypes

    libs = tuple(libs or kernels.KERNELS)
    spilled, seen = [], set()
    for lib in libs:
        log = kernels.library_path(lib).with_suffix(".log")
        if not log.exists():
            continue
        for name, regs, smem, st, ld in ptxas_entries(log.read_text()):
            extra = ""
            if name in NO_SPILL_KERNELS:
                seen.add(name)
                src, sym, args = NO_SPILL_KERNELS[name]
                fn = kernels.function(src, sym, [ctypes.c_int] * len(args))
                extra = f" + {fn(*args)} B dynamic"
                if st or ld:
                    spilled.append(name)
            say(f"ptxas {lib} {name}: {regs} registers, {smem} B static shared memory{extra}, "
                f"spill stores {st} B, spill loads {ld} B")
    expected = {k for k, (src, _, _) in NO_SPILL_KERNELS.items() if src in libs}
    if spilled or seen != expected:
        raise AssertionError(f"kernels spill to local memory: {spilled}; "
                             f"without a ptxas report: {expected - seen}")


def device_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time per call of `iters` back-to-back calls, by CUDA
    events. A 10 ms device sleep is queued first, so the host has enqueued
    every call before the first one runs and its launch overhead does not
    show in the interval."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def busy_ms(fn, calls: int = 3) -> float:
    """The device's busy time for one call of fn: its kernels' summed time
    under torch.profiler over `calls` calls after a warm-up, per call. Unlike
    device_ms it leaves out the gaps in which the device waits for the
    host."""
    fn()
    _, ms, _ = profiled(lambda: [fn() for _ in range(calls)])
    return ms / calls


def same_bits(label, first, second):
    """Raise unless each tensor of `second` equals the one of `first` bit
    for bit (two calls of a deterministic kernel on the same inputs)."""
    import torch

    if len(first) != len(second) or not all(torch.equal(a, b) for a, b in zip(first, second)):
        raise AssertionError(f"{label}: two calls differ")
    say(f"{label}: two calls bit-identical")


def cycled(items):
    """Callable factory cycling through input copies, so repeated calls find
    the weights cold in the 50 MB L2 as the decode step does."""
    state = {"i": 0}

    def pick():
        item = items[state["i"] % len(items)]
        state["i"] += 1
        return item

    return pick


# ------------------------------------------------------------------ phase 3


# K1's edge cases (M, K, N), correctness only: M 1 (63 padding rows of 64),
# 14 (the stage-2 bucket), 16 and 17, 25, 64, 65, 200 and 256 over several
# 64-row m tiles; K 4104 (a tile of 8 rows, zero-filled past K) and 4224 (33
# tiles, ranks of unequal length); N 1024 (a q8c_apply column chunk), 4112 (a
# 16-column last block) and 32000
K1_EDGES = ((1, 4096, 4096), (1, 4104, 32000), (14, 4096, 1024), (16, 4224, 4112),
            (17, 4104, 4112), (25, 4096, 1024), (37, 4104, 4112), (64, 4224, 1024),
            (65, 4104, 4112), (200, 4096, 4096), (256, 4224, 32000))
DECODE_SHAPES = ((4096, 4096, 4 * 32), (4096, 11008, 2 * 32), (11008, 4096, 32), (4096, 32000, 1))


def k1_rows_swapped(x, q, s):
    """K1's plain version with rows 2i and 2i + 1 of q8 swapped: the k pair
    of each bf16x2 A register reversed (a planted fault)."""
    from revisionllm_tpu_torch.ops import quant as Q

    K, N = q.shape
    return Q.int8_matmul_plain(x, q.reshape(K // 2, 2, N).flip(1).reshape(K, N), s)


def check_int8_matmul(dev, iters):
    """K1 at the decode step's shapes (M 64; q/k/v/o, gate/up, down, the
    lm_head) against its plain version by relative L2 error, whole and per
    (64-row, 128-column) block, with two planted faults that must fail
    (neighbouring k rows 2i and 2i + 1 swapped; the last K rank's partial
    dropped from the cluster sum); two calls on the same inputs must be
    bit-identical, and one call must be one q8_matmul_kernel launch that
    allocates only its output. Then the edge cases K1_EDGES, correctness
    only. The C library's shared memory must be the plan's, and clusters of
    each size must fit (cudaOccupancyMaxActiveClusters). Times one decode
    step's 225 launches: kernel, plain, and torch.matmul on the bf16
    weight."""
    import torch
    from revisionllm_tpu_torch.ops import quant as Q
    from revisionllm_tpu_torch.utils import kernels

    smem = kernels.function("int8_matmul", "q8_matmul_smem_bytes", [])()
    if smem != Q.q8_smem_bytes():
        raise AssertionError(f"int8_matmul: the library's shared memory is {smem} B, the "
                             f"plan's {Q.q8_smem_bytes()} B")
    resident = Q.q8_resident(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    say(f"int8_matmul: {smem} B of shared memory a block; resident clusters of "
        f"{Q.WONLY_SPLITS} blocks: {resident} on {sms} SMs")
    M = 64
    gen = torch.Generator(device=dev).manual_seed(3)
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0.0, "ops": 0.0}
    worst = 0.0
    details = []
    for K, N, per_step in DECODE_SHAPES:
        x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
        copies = max(1, math.ceil(128e6 / (K * N)))
        ws = []
        for _ in range(copies):
            q, s = Q.quantize_int8(torch.randn((K, N), generator=gen, device=dev) * K ** -0.5)
            ws.append((q, s, Q.dequantize_int8(q, s, torch.bfloat16)))
        q, s = ws[0][:2]
        plan = Q.q8_plan(M, K, N, sms, resident)
        got = Q.int8_matmul(x, q, s)
        again = Q.int8_matmul(x, q, s)
        want = Q.int8_matmul_plain(x, q, s)
        faults = {"k rows 2i, 2i + 1 swapped": k1_rows_swapped(x, q, s),
                  "last K rank dropped": dropped_last_rank(x, q, s, plan, Q.Q8_BK,
                                                           Q.int8_matmul_plain)}
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"int8_matmul K={K} N={N}: two calls differ")
        err = hold_cols(f"int8_matmul M={M} K={K} N={N} (S {plan.splitk}, "
                        f"{plan.n_tiles} clusters)", got, want, faults)
        one_kernel(f"int8_matmul K={K} N={N}", lambda: Q.int8_matmul(x, q, s), 1,
                   "q8_matmul_kernel")
        worst = max(worst, err)
        del faults
        pick = cycled(ws)
        ms = device_ms(lambda: Q.int8_matmul(x, *pick()[:2]), iters)
        plain = device_ms(lambda: Q.int8_matmul_plain(x, *pick()[:2]), iters)
        lib = device_ms(lambda: torch.matmul(x, pick()[2]), iters)
        nbytes = M * K * 2 + K * N + N * 4 + M * N * 2
        ops = 2.0 * M * K * N
        b, by = bound(nbytes, ops)
        say(f"int8_matmul M={M} K={K} N={N}: kernel {ms:.4f} ms plain {plain:.4f} ms "
            f"torch.matmul(bf16 W) {lib:.4f} ms bound {b:.4f} ms ({by}) "
            f"[{per_step} launches per decode step]")
        details.append({"K": K, "N": N, "splitk": plan.splitk, "ms": ms, "plain_ms": plain,
                        "library_ms": lib, "bound_ms": b, "per_decode_step": per_step})
        for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib)):
            tot[key] += per_step * val
        tot["bytes"] += per_step * nbytes
        tot["ops"] += per_step * ops
        del ws, pick
    for M2, K2, N2 in K1_EDGES:
        x = torch.randn((M2, K2), generator=gen, device=dev).to(torch.bfloat16)
        q, s = Q.quantize_int8(torch.randn((K2, N2), generator=gen, device=dev) * K2 ** -0.5)
        worst = max(worst, hold_cols(f"int8_matmul M={M2} K={K2} N={N2}", Q.int8_matmul(x, q, s),
                                     Q.int8_matmul_plain(x, q, s)))
    b, by = bound(tot["bytes"], tot["ops"])
    say(f"int8_matmul one decode step: kernel {tot['ms']:.4f} ms, torch.matmul(bf16 W) "
        f"{tot['library_ms']:.4f} ms, bound {b:.4f} ms ({by})")
    return {
        "name": "int8_matmul", "max_abs_err": worst, "ms": tot["ms"],
        "plain_ms": tot["plain_ms"], "bound_ms": b, "bound_by": by,
        "library_ms": tot["library_ms"],
        "unit": "one decode step at B=64 (225 launches: 32 layers x 7 + lm_head); library: "
                "torch.matmul on the bf16 weight",
        "shapes": details,
    }


def check_flash_attention(dev, iters):
    import torch
    import torch.nn.functional as F
    from revisionllm_tpu_torch.ops import flash_attention as FA

    B, H, T, d = 64, 32, 318, 128
    gen = torch.Generator(device=dev).manual_seed(4)
    q, k, v = (torch.randn((B, T, H, d), generator=gen, device=dev).to(torch.bfloat16) for _ in range(3))
    lens = torch.randint(200, T + 1, (B,), generator=gen, device=dev, dtype=torch.int32)
    lens[0] = T
    got = FA.flash_attention(q, k, v, causal=True, kv_lens=lens)
    want = FA.flash_attention_plain(q, k, v, causal=True, kv_lens=lens)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    # P is rounded to bf16 before P V (as in the Pallas body) and the output
    # to bf16; outputs are averages of N(0, 1) values
    tol = 2e-2
    if not err <= tol:
        raise AssertionError(f"flash_attention: max_abs_err {err} > {tol}")
    ms = device_ms(lambda: FA.flash_attention(q, k, v, causal=True, kv_lens=lens), iters)
    plain = device_ms(lambda: FA.flash_attention_plain(q, k, v, causal=True, kv_lens=lens), max(3, iters // 4))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    mask = FA._kv_mask(B, T, T, lens, True, dev)
    lib = device_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask), iters)
    # GQA (32 query heads over 8 kv heads) and a non-causal call, correctness only
    worst = err
    for label, KH2, causal in (("GQA causal", 8, True), ("non-causal", 32, False)):
        q2 = torch.randn((4, 100, H, d), generator=gen, device=dev).to(torch.bfloat16)
        k2, v2 = (torch.randn((4, 100, KH2, d), generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
        l2 = torch.tensor([100, 37, 64, 1], dtype=torch.int32, device=dev)
        e2 = (FA.flash_attention(q2, k2, v2, causal=causal, kv_lens=l2).float()
              - FA.flash_attention_plain(q2, k2, v2, causal=causal, kv_lens=l2).float()).abs().max().item()
        say(f"flash_attention {label} B=4 T=S=100 KH={KH2}: max_abs_err {e2:.3e} (tol {tol:.1e})")
        if not e2 <= tol:
            raise AssertionError(f"flash_attention {label}: max_abs_err {e2} > {tol}")
        worst = max(worst, e2)
    lens_h = lens.cpu().numpy().astype(np.int64)
    t_idx = np.arange(T)
    cols = sum(int(np.minimum(t_idx + 1, n).sum()) for n in lens_h)  # live (row, col) pairs
    ops = 4.0 * H * d * cols
    nbytes = 2 * B * T * H * d * 2 + 2 * int(lens_h.sum()) * H * d * 2 + B * 4
    b, by = bound(nbytes, ops)
    say(f"flash_attention B={B} H={H} T=S={T} d={d} causal ragged: max_abs_err {err:.3e} "
        f"(tol {tol:.1e}) kernel {ms:.4f} ms plain {plain:.4f} ms sdpa {lib:.4f} ms "
        f"bound {b:.4f} ms ({by})")
    return {"name": "flash_attention", "max_abs_err": worst, "ms": ms, "plain_ms": plain,
            "bound_ms": b, "bound_by": by, "library_ms": lib,
            "unit": "one launch = one layer of the chunk-64 prefill"}


def k3_view(t):
    """K3's output [B, KH, group, hd] as `hold`'s [B', N, H, d] with one
    block a (row, kv head, query) vector."""
    return t.float().reshape(-1, 1, 1, t.shape[-1])


def hold_k3(label, got, want, faults=None):
    """`hold` for K3's output, by (row, head, query) blocks."""
    return hold(label, k3_view(got), k3_view(want),
                {k: k3_view(v) for k, v in (faults or {}).items()})


def k3_faults(args, plain):
    """K3's planted faults on `args` (q, prompt k, v and their scales, gen
    k, v, mask_lens, step), by its plain version: the second half of every
    prompt masked, and one V tile (prompt positions 64..127) dropped."""
    q, pk, pv, ks, vs, gk, gv, lens, step = args
    pv_cut = pv.clone()
    pv_cut[:, 64:128] = 0
    return {"the second half of every prompt masked": plain(q, pk, pv, ks, vs, gk, gv, lens // 2, step),
            "one V tile dropped": plain(q, pk, pv_cut, ks, vs, gk, gv, lens, step)}


def k3_inputs(gen, B, KH, S, G, group, low, dev, quant=True):
    """Random K3 inputs: bf16 q [B, KH, group, 128], an int8 prompt cache
    with scales in [0.005, 0.025) (or a bf16 one), a bf16 gen cache, prompt
    lengths in [low, S]."""
    import torch

    hd = 128
    q = torch.randn((B, KH, group, hd), generator=gen, device=dev).to(torch.bfloat16)
    if quant:
        pk, pv = (torch.randint(-127, 128, (B, S, KH, hd), generator=gen, device=dev,
                                dtype=torch.int8) for _ in range(2))
        ks, vs = (torch.rand((B, S, KH), generator=gen, device=dev) * 0.02 + 0.005 for _ in range(2))
    else:
        pk, pv = (torch.randn((B, S, KH, hd), generator=gen, device=dev).to(torch.bfloat16)
                  for _ in range(2))
        ks = vs = None
    gk, gv = (torch.randn((B, G, KH, hd), generator=gen, device=dev).to(torch.bfloat16)
              for _ in range(2))
    lens = torch.randint(low, S + 1, (B,), generator=gen, device=dev, dtype=torch.int32)
    return q, pk, pv, ks, vs, gk, gv, lens


def check_decode_attention(dev, iters):
    """K3 at the stage-1 decode step's shape (B 64, KH 32, S 318, G 12,
    prompt lengths 280-318, group 1, int8 prompt cache) at steps 0 and 11:
    held by the rows 4-6 limits per (row, head) vector against its plain
    version, with two planted faults that must fail them (k3_faults), by a
    max abs error of 1e-2, and two calls bit-identical; timed beside its
    plain version and SDPA over the dequantized cache (approximate). Then
    the bf16 prompt cache (KV8 off), GQA (32 query heads over 8 kv heads),
    4096 positions (B 8, S 4084) and the chat's step (B 1, chat_geometry),
    held the same way (the faults at the last two, both timed)."""
    import torch
    import torch.nn.functional as F
    from revisionllm_tpu_torch.ops import decode_attention as DA

    B, KH, S, G, hd = 64, 32, 318, 12, 128
    gen = torch.Generator(device=dev).manual_seed(5)
    q, pk, pv, ks, vs, gk, gv, lens = k3_inputs(gen, B, KH, S, G, 1, 280, dev)
    out = None
    worst = 0.0
    for step in (0, G - 1):
        args = (q, pk, pv, ks, vs, gk, gv, lens, step)
        got = DA.decode_attention(*args)
        want = DA.decode_attention_plain(*args)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        # same bf16 rounding of the weights on both sides; f32 sums in
        # another order, output rounded to bf16 (values up to ~1)
        tol = 1e-2
        if not err <= tol:
            raise AssertionError(f"decode_attention step {step}: max_abs_err {err} > {tol}")
        hold_k3(f"decode_attention B={B} KH={KH} S={S} G={G} int8 step={step}", got, want,
                k3_faults(args, DA.decode_attention_plain))
        same_bits(f"decode_attention step {step}", (got,), (DA.decode_attention(*args),))
        worst = max(worst, err)
        ms = device_ms(lambda: DA.decode_attention(*args), iters)
        plain = device_ms(lambda: DA.decode_attention_plain(*args), max(3, iters // 4))
        # yardstick: SDPA over the cache dequantized and concatenated
        # beforehand (so it does less work than the kernel: approximate)
        kf = torch.cat([(pk.float() * ks[..., None]).to(torch.bfloat16), gk[:, : step + 1]], dim=1)
        vf = torch.cat([(pv.float() * vs[..., None]).to(torch.bfloat16), gv[:, : step + 1]], dim=1)
        kt, vt = kf.transpose(1, 2).contiguous(), vf.transpose(1, 2).contiguous()
        cols = torch.arange(S + step + 1, device=dev)
        mask = ((cols[None, :] < lens[:, None]) | (cols[None, :] >= S))[:, None, None, :]
        lib = device_ms(lambda: F.scaled_dot_product_attention(q, kt, vt, attn_mask=mask), iters)
        del kf, vf, kt, vt
        plen = int(lens.sum().item())
        nbytes = (B * KH * hd * 2 * 2 + plen * KH * (hd * 2 + 8)
                  + B * (step + 1) * KH * hd * 2 * 2 + B * 4)
        ops = 4.0 * KH * hd * (plen + B * (step + 1))
        b, by = bound(nbytes, ops)
        say(f"decode_attention B={B} KH={KH} S={S} G={G} int8 step={step}: max_abs_err {err:.3e} "
            f"(tol {tol:.1e}) kernel {ms:.4f} ms plain {plain:.4f} ms sdpa(dequantized, approx) "
            f"{lib:.4f} ms bound {b:.4f} ms ({by})")
        out = {"name": "decode_attention", "max_abs_err": err, "ms": ms, "plain_ms": plain,
               "bound_ms": b, "bound_by": by, "library_ms": lib,
               "unit": f"one launch = one layer at step {step} (library: approximate)"}
    # the other variants: a bf16 prompt cache (KV8 off), GQA (32 query heads
    # over 8 kv heads), the longest cache Vicuna-7B supports, and the chat's
    # step (phase 15's inference_stream at B 1: its prompt cache, its live
    # prompt length the least, its gen cache, its last step); the last two
    # with the planted faults, and timed
    rows, live = chat_geometry()
    for label, quant, B2, KH2, S2, G2, group, low, step, faults in (
            ("bf16 prompt", False, B, 32, S, G, 1, 280, 5, False),
            ("GQA int8", True, B, 8, S, G, 4, 280, 5, False),
            ("4096 positions", True, 8, 32, 4096 - G, G, 1, 4096 - G - 64, G - 1, True),
            ("B=1 (the chat)", True, 1, 32, rows, SURF_TOKENS, 1, live, SURF_TOKENS - 2, True)):
        args = (*k3_inputs(gen, B2, KH2, S2, G2, group, low, dev, quant), step)
        got = DA.decode_attention(*args)
        want = DA.decode_attention_plain(*args)
        err = (got.float() - want.float()).abs().max().item()
        say(f"decode_attention {label} B={B2} KH={KH2} S={S2} G={G2} group={group} "
            f"step={step}: max_abs_err {err:.3e} (tol 1.0e-02)")
        if not err <= 1e-2:
            raise AssertionError(f"decode_attention {label}: max_abs_err {err} > 1e-2")
        hold_k3(f"decode_attention {label}", got, want,
                k3_faults(args, DA.decode_attention_plain) if faults else None)
        same_bits(f"decode_attention {label}", (got,), (DA.decode_attention(*args),))
        if faults:
            ms = device_ms(lambda: DA.decode_attention(*args), iters)
            plain = device_ms(lambda: DA.decode_attention_plain(*args), max(3, iters // 4))
            say(f"decode_attention {label}: kernel {ms:.4f} ms plain {plain:.4f} ms")
            if S2 > S:
                out["long_ms"] = ms
        worst = max(worst, err)
        del args, got, want
    out.update(check_k3_group16(dev, gen, iters))
    out["max_abs_err"] = max(out["max_abs_err"], worst, out.pop("g16_err"))
    torch.cuda.empty_cache()
    return out


# ChatGLM2-6B's decode step: 8 prompts of about 300 tokens after a P-tuning
# prefix of 128 positions folded into the int8 prompt cache; 12 greedy tokens
GLM_B, GLM_PROMPT, GLM_PREFIX, GLM_TOKENS = 8, 300, 128, 12


def check_k3_group16(dev, gen, iters):
    """K3 at ChatGLM2-6B's decode shape: group 16 (32 query heads over 2 kv
    heads), B 8, an int8 prompt cache of S = 300 + 128 prefix positions
    (live lengths 408-428), G 12, the last step: held by the rows 4-6 limits
    per (row, head, query) vector against its plain version with K3's
    planted faults, max abs error 1e-2, two calls bit-identical; timed
    beside its plain version and SDPA, with its bound from the bytes it
    reads; its grid, cluster and resident clusters printed (the split
    against ops/decode_attention.py's mirror). Then KH 1 (tensor
    parallelism 2) the same way, untimed, and the kernel's edge cases: a
    bf16 prompt cache, ranks with no live position, ranks of three rounds,
    NaN scales past mask_lens."""
    import ctypes

    import torch
    from revisionllm_tpu_torch.ops import decode_attention as DA
    from revisionllm_tpu_torch.utils import kernels

    B, KH, group, hd = GLM_B, 2, 16, 128
    S, G, step = GLM_PROMPT + GLM_PREFIX, GLM_TOKENS, GLM_TOKENS - 1
    split = kernels.function("decode_attention", "decode_attn_g16_split",
                             [ctypes.c_int, ctypes.c_int])(S, step)
    if split != DA.g16_split(S, step):
        raise AssertionError(f"K3 group 16: the kernel splits an item over {split} ranks, "
                             f"the mirror over {DA.g16_split(S, step)}")
    resident = kernels.function("decode_attention", "decode_attn_g16_max_clusters",
                                [ctypes.c_int, ctypes.c_int])(split, 1)
    if resident < 1:
        raise AssertionError(f"K3 group 16: clusters of {split} blocks do not fit ({resident})")
    smem = kernels.function("decode_attention", "decode_attn_g16_smem_bytes", [])()
    for kh in (KH, 1):
        say(f"decode_attention group 16 KH={kh}: grid ({split}, {B * kh}) = {split * B * kh} "
            f"blocks of {32 * DA.KG16_WARPS} threads, clusters of ({split}, 1, 1), "
            f"{smem} B shared memory a block; {resident} clusters resident at "
            f"once ({B * kh} launched: {'one wave' if B * kh <= resident else 'more than one wave'})")
    args = (*k3_inputs(gen, B, KH, S, G, group, S - 20, dev), step)
    got = DA.decode_attention(*args)
    want = DA.decode_attention_plain(*args)
    err = (got.float() - want.float()).abs().max().item()
    label = f"decode_attention group 16 B={B} KH={KH} S={S} G={G} step={step}"
    if not err <= 1e-2:
        raise AssertionError(f"{label}: max_abs_err {err} > 1e-2")
    hold_k3(label, got, want, k3_faults(args, DA.decode_attention_plain))
    same_bits(label, (got,), (DA.decode_attention(*args),))
    ms = device_ms(lambda: DA.decode_attention(*args), iters)
    plain = device_ms(lambda: DA.decode_attention_plain(*args), max(3, iters // 4))
    lib = k3_gqa_sdpa_ms(args, iters)
    plen = int(args[7].sum().item())
    nbytes = (B * KH * group * hd * 2 * 2 + plen * KH * (hd * 2 + 8)
              + B * (step + 1) * KH * hd * 2 * 2 + B * 4)
    b, by = bound(nbytes, 4.0 * KH * group * hd * (plen + B * (step + 1)))
    say(f"{label}: max_abs_err {err:.3e} (tol 1.0e-02) kernel {ms:.4f} ms plain {plain:.4f} ms "
        f"sdpa(dequantized, GQA, approx) {lib:.4f} ms bound {b:.4f} ms ({by})")
    # ChatGLM2 under tensor parallelism 2: one kv head a rank
    args1 = (*k3_inputs(gen, B, 1, S, G, group, S - 20, dev), step)
    got1 = DA.decode_attention(*args1)
    err1 = (got1.float() - DA.decode_attention_plain(*args1).float()).abs().max().item()
    label1 = f"decode_attention group 16 KH=1 (ChatGLM2 at tp 2) B={B} S={S} step={step}"
    if not err1 <= 1e-2:
        raise AssertionError(f"{label1}: max_abs_err {err1} > 1e-2")
    hold_k3(label1, got1, DA.decode_attention_plain(*args1),
            k3_faults(args1, DA.decode_attention_plain))
    same_bits(label1, (got1,), (DA.decode_attention(*args1),))
    say(f"{label1}: max_abs_err {err1:.3e} (tol 1.0e-02)")
    # the kernel's edge cases, untimed: KV8 off (a bf16 prompt cache), live
    # lengths of 0-3 (ranks with no live position), 1100 positions (each
    # rank three rounds, streamed twice), and NaN scales and K/V past
    # mask_lens (a padded cache: the kernel reads those rows and must not
    # use them; the plain version, whose p1 * v_scale is 0 * NaN there, is
    # held on the same inputs with those scales set to 1)
    for name, quant, S2, low, G2, step2 in (("bf16 prompt", False, S, S - 20, G, step),
                                            ("empty ranks", True, S, 0, G, 0),
                                            ("three rounds a rank", True, 1100, 1000, 8, 5),
                                            ("NaN past the mask", True, S, S - 60, G, step)):
        a2 = list(k3_inputs(gen, B, KH, S2, G2, group, low, dev, quant)) + [step2]
        if name == "empty ranks":
            a2[7] = torch.randint(0, 4, (B,), generator=gen, device=dev, dtype=torch.int32)
        want_args = a2
        if name == "NaN past the mask":
            past = torch.arange(S2, device=dev)[None, :] >= a2[7][:, None]  # [B, S]
            want_args = list(a2)
            want_args[3], want_args[4] = (t.masked_fill(past[..., None], 1.0) for t in a2[3:5])
            a2[3], a2[4] = (t.masked_fill(past[..., None], float("nan")) for t in a2[3:5])
            a2[1], a2[2] = (t.masked_fill(past[..., None, None], -128) for t in a2[1:3])
        got2 = DA.decode_attention(*a2)
        want2 = DA.decode_attention_plain(*want_args)
        e2 = (got2.float() - want2.float()).abs().max().item()
        lab = f"decode_attention group 16 {name} B={B} KH={KH} S={S2} step={step2}"
        if not e2 <= 1e-2:
            raise AssertionError(f"{lab}: max_abs_err {e2} > 1e-2")
        hold_k3(lab, got2, want2)
        same_bits(lab, (got2,), (DA.decode_attention(*a2),))
        say(f"{lab}: max_abs_err {e2:.3e} (tol 1.0e-02)")
        err1 = max(err1, e2)
    return {"g16_err": max(err, err1), "g16_ms": ms, "g16_plain_ms": plain, "g16_bound_ms": b,
            "g16_library_ms": lib}


def k3_gqa_sdpa_ms(args, iters):
    """SDPA over K3's inputs `args` with the prompt cache dequantized and
    the gen cache concatenated beforehand, the query heads grouped over the
    kv heads (enable_gqa): a yardstick that does less work than the kernel
    (approximate)."""
    import torch
    import torch.nn.functional as F

    q, pk, pv, ks, vs, gk, gv, lens, step = args
    B, KH, group, hd = q.shape
    S = pk.shape[1]
    kf = torch.cat([(pk.float() * ks[..., None]).to(torch.bfloat16), gk[:, : step + 1]], dim=1)
    vf = torch.cat([(pv.float() * vs[..., None]).to(torch.bfloat16), gv[:, : step + 1]], dim=1)
    kt, vt = kf.transpose(1, 2).contiguous(), vf.transpose(1, 2).contiguous()
    qh = q.reshape(B, KH * group, 1, hd)
    cols = torch.arange(S + step + 1, device=q.device)
    mask = ((cols[None, :] < lens[:, None]) | (cols[None, :] >= S))[:, None, None, :]
    return device_ms(lambda: F.scaled_dot_product_attention(qh, kt, vt, attn_mask=mask,
                                                            enable_gqa=True), iters)


# ------------------------------------------------------------------ phase 4


def make_engine(cfg, acfg, ecfg, device, dtype, seed=0, quantize="int8"):
    """Random int8 (or int4) Vicuna params (built one layer at a time) and
    adapter."""
    from revisionllm_tpu_torch.eval.engine import GroundingEngine
    from revisionllm_tpu_torch.models import llama, revisionllm

    params = llama.init_params(cfg, seed=seed, dtype=dtype, device=device, quantize=quantize)
    vision = revisionllm.init_vision_params(acfg, seed=seed + 1, d_in=acfg.d_model,
                                            dtype=dtype, device=device)
    return GroundingEngine(cfg, acfg, params, vision, fake_tokenizer(), ecfg, device=device)


def packed_engine(engine, device):
    """`engine` over its int8 layers packed into the serving chunks
    (pack_serving_weights, block 1024): configuration C's engine. The
    standard tree stays as it was."""
    from revisionllm_tpu_torch.eval.engine import GroundingEngine
    from revisionllm_tpu_torch.ops import decode_serve as DSV

    return GroundingEngine(
        engine.llama_cfg, engine.adapter_cfg,
        {**engine.params, "layers": DSV.pack_serving_weights(engine.params["layers"])},
        engine.vision_params, engine.tokenizer, engine.eval_cfg, device=device)


def run_slice(engine, movie, qf, qc, runs):
    """ground_windows once with its kernels counted (DeviceLaunches), then
    `runs` more timed; returns (the last result, the counted run's
    launches, list of latencies in s)."""
    import torch

    with DeviceLaunches() as seen:
        engine.ground_windows(movie, SENTENCE, qf, qc, movie_key="movie0")
    lat = []
    res = None
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = engine.ground_windows(movie, SENTENCE, qf, qc, movie_key="movie0")
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    return res, seen.launches, lat


# the kernels behind the wrappers' launch counters (utils/kernels.py
# COUNTERS) on the serving paths, by their __global__ names. A split decode
# step replays as a CUDA graph on the card (models/generation.py
# DecodeGraphs), launched by no wrapper, so a serving run's kernels are
# counted by the profiler, which sees a replay's. flash_fwd_lse_kernel
# counts as row 5's here (row 4 trains eagerly, counted by its wrappers);
# row 8 counts its GEMM, one of the three kernels of a launch.
DEVICE_KERNELS = {
    "int8_matmul": r"q8_matmul_kernel", "flash_attention": r"flash_fwd_kernel",
    "decode_attention": r"decode_attn_kernel(_g16)?",
    "flash_attention_lse": r"flash_fwd_lse_kernel",
    "flash_attention_prefixed": r"flash_prefix_kernel", "int4_matmul": r"q4_matmul_kernel",
    "w8a8_mlp_fused": r"mlp_gemm_kernel", "decode_step_fused": r"step_kernel<.*GenCacheAttn",
    "decode_step_serve": r"step_kernel<.*SlabAttn", "quantize_rows": r"quantize_rows_kernel",
    "w8a8_transpose": r"kmajor_transpose_kernel", "w8a8_gemm": r"s8gemm_kernel",
    "moe_w8a8": r"moe_w8a8_kernel", "moe_w8a16": r"moe_w8a16_kernel",
}


def device_launches(names):
    """{counter of DEVICE_KERNELS: how many of the kernel names are its}."""
    out = {}
    for counter, pat in DEVICE_KERNELS.items():
        found = re.compile(rf"(?<![A-Za-z0-9_])(?:{pat})(?![A-Za-z0-9_])").search
        out[counter] = sum(found(n) is not None for n in names)
    return out


class DeviceLaunches:
    """While inside, torch.profiler (CUDA activity) records the kernels the
    device runs; on leaving, synchronised, `launches` is {counter of
    DEVICE_KERNELS: its kernels run}. Time measured inside runs under the
    profiler."""

    def __enter__(self):
        import torch

        self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.synchronize()
        self.prof.__exit__(*exc)
        self.launches = device_launches([e.name for e in kernel_events(self.prof)])
        return False


def check_result(res, n_windows):
    if res["num_windows"] != n_windows or len(res["answers"]) != n_windows:
        raise AssertionError(f"expected {n_windows} windows, got {res['num_windows']}")
    ent = np.asarray(res["scores_entropy"], np.float64)
    if ent.shape != (n_windows,) or not np.isfinite(ent).all() or (ent < 0).any():
        raise AssertionError("entropy scores are not finite and non-negative")


def slice_setup(dev, num_layers=None, tag="slice"):
    """The stage-1 serving configuration of bench.py:48-200 at Vicuna-7B full
    width and depth (or cut to `num_layers`): (engine, movie [18000, 768],
    query tokens [25, 768], query CLS [768]), weights and inputs made from
    seed 0."""
    import dataclasses

    import torch
    from revisionllm_tpu_torch.config import AdapterConfig, EvalConfig, LlamaConfig

    cfg = LlamaConfig()
    if num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    acfg = AdapterConfig(clip_adapter_text=True, hierarchy=False, feature_mode="temporal",
                         hidden_size=cfg.hidden_size)
    ecfg = EvalConfig(debug_window=125, num_frames=250, feature_fps=5.0, batch=64,
                      stride=2, max_new_tokens=12)
    t0 = time.perf_counter()
    engine = make_engine(cfg, acfg, ecfg, dev, torch.bfloat16)
    torch.cuda.synchronize()
    say(f"{tag}: Vicuna-7B, {cfg.num_layers} layers, int8 weights built from seed 0 in "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    movie = rng.normal(size=(18000, 768)).astype(np.float32)
    qf = rng.normal(size=(25, 768)).astype(np.float32)
    qc = rng.normal(size=(768,)).astype(np.float32)
    return engine, movie, qf, qc / np.linalg.norm(qc)


def phase_slice(dev, runs):
    """Returns (launches of one ground_windows, the slice's setup)."""
    import torch

    setup = engine, movie, qf, qc = slice_setup(dev)
    t0 = time.perf_counter()
    res = engine.ground_windows(movie, SENTENCE, qf, qc, movie_key="movie0")
    torch.cuda.synchronize()
    say(f"slice: warm-up ground_windows {time.perf_counter() - t0:.3f} s")
    torch.cuda.reset_peak_memory_stats()
    res, launches, lat = run_slice(engine, movie, qf, qc, runs)
    check_result(res, 57)
    chunk_s = float(np.median(lat))
    say(f"slice: ground_windows x{runs}: latencies {[round(x, 4) for x in lat]} s; "
        f"chunk latency (median) {chunk_s * 1e3:.1f} ms; windows/s {57 / chunk_s:.2f}; "
        f"q/s {1 / chunk_s:.4f}; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    say(f"slice: launches in one ground_windows: {launches}")
    missing = [k for k in SERVING if not launches[k]]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    return launches, setup


def step_breakdown(eng, movie, qf_np, step_kind="split"):
    """Where a chunk's time goes, on the engine's 64 windows of the movie, in
    the current switches: for the adapter + splice, the prefill and a decode
    step (the median of 11; `step_kind` "split" the split step as generate
    runs it on the card, replayed from its CUDA graph (the engine's graph
    set of this shape, models/generation.py DecodeGraphs; the first pass
    runs each step eagerly and captures it), "mega" the
    megakernel's step decode_step_mega, "serve" the serving layout's
    decode_step_serve after a prefill into the unified slab), the wall time
    by CUDA events from an idle
    device, the host's time to enqueue the part, and the device's busy time
    (its kernels summed under torch.profiler; the step's at step 5). A part
    whose wall time matches its enqueue time and exceeds its busy time is
    paced by the host."""
    import torch
    from revisionllm_tpu_torch.constants import QUESTIONS
    from revisionllm_tpu_torch.models import generation, llama, revisionllm
    from revisionllm_tpu_torch.models.multimodal import build_splice_plan, stack_plans
    from revisionllm_tpu_torch.ops import decode_step as DS

    dev = eng.device
    cfg, acfg = eng.llama_cfg, eng.adapter_cfg
    ids = eng._prompt_ids(SENTENCE, QUESTIONS["mad_grounding"])
    plan = {k: torch.as_tensor(v, device=dev) for k, v in stack_plans(
        [build_splice_plan(ids, 250, len(ids) - 1 + 250 + 12)] * 64).items()}
    idx = torch.as_tensor(eng._stage1_plan_idx(18000)[:64].tolist() + [[0] * 250] * 7, device=dev)
    feats = torch.as_tensor(movie, device=dev)
    qf = torch.as_tensor(qf_np, device=dev).to(torch.bfloat16).expand(64, 25, 768)

    def timed(fn):
        """(fn(), wall ms, host enqueue ms) of one call from an idle device."""
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        t0 = time.perf_counter()
        out = fn()
        host = (time.perf_counter() - t0) * 1e3
        b.record()
        b.synchronize()
        return out, a.elapsed_time(b), host

    def adapter():
        video = revisionllm.encode_video(acfg, eng.vision_params, feats[idx].to(torch.bfloat16), qf)
        return revisionllm.assemble_inputs(eng.params, plan, video, dtype=torch.bfloat16)

    out = {}
    for _ in range(2):  # the first pass warms up
        (embeds, pos, lens), out["adapter_wall"], out["adapter_host"] = timed(adapter)
        lens = lens.to(torch.int32)
        graphs = None
        if step_kind == "split":  # the prefill writes into the set's buffers, as in generate
            graphs = generation._decode_graphs(cfg, eng.params, 64, embeds.shape[1], True, False,
                                               12, torch.bfloat16, dev)
        prefill = partial(llama.prefill_kv, cfg, eng.params, embeds, pos, kv_lens=lens,
                          kv_quant=True, kv_slab_slots=12 if step_kind == "serve" else None,
                          kv_out=graphs.prompt if graphs else None)
        (logits, pkv), out["prefill_wall"], out["prefill_host"] = timed(prefill)
        tok = llama.embed_tokens(eng.params, logits.argmax(-1)[:, None])
        if step_kind == "serve":
            gen = None
            step = partial(generation.decode_step_serve, cfg, eng.params, pkv, embeds.shape[1],
                           lens)
        elif step_kind == "mega":
            pkv = DS.pack_prompt_kv(pkv)
            gen = DS.init_gen_cache(cfg.num_layers, 64, cfg.num_kv_heads, cfg.head_dim, 12,
                                    torch.bfloat16, dev)
            step = partial(generation.decode_step_mega, cfg, eng.params, pkv, lens, gen)
        else:
            graphs.load(lens)
            gen = None
            step = partial(graphs.step, cfg, eng.params)
        steps = [timed(partial(step, g, tok))[1:] for g in range(11)]
    _, out["adapter_busy"], _ = profiled(adapter)
    _, out["prefill_busy"], _ = profiled(prefill)
    _, out["step_busy"], events = profiled(partial(step, 5, tok))
    out["step_wall"] = float(np.median([w for w, _ in steps]))
    out["step_host"] = float(np.median([h for _, h in steps]))
    out["steps_wall"] = sum(w for w, _ in steps)
    groups, _ = group_kernels(events)
    out["step_kernels"] = "; ".join(f"{label} {ms:.3f} ms x{n}"
                                    for label, (ms, n) in groups.items() if n)
    del pkv, gen, step, graphs
    torch.cuda.empty_cache()
    return out


def say_breakdown(tag, parts):
    say(f"{tag}: adapter+splice wall {parts['adapter_wall']:.2f} ms, host enqueue "
        f"{parts['adapter_host']:.2f} ms, device busy {parts['adapter_busy']:.2f} ms")
    say(f"{tag}: prefill wall {parts['prefill_wall']:.2f} ms, host enqueue "
        f"{parts['prefill_host']:.2f} ms, device busy {parts['prefill_busy']:.2f} ms")
    say(f"{tag}: decode step (median of 11) wall {parts['step_wall']:.2f} ms, host enqueue "
        f"{parts['step_host']:.2f} ms; device busy {parts['step_busy']:.2f} ms at step 5 (idle "
        f"share {max(0.0, 1 - parts['step_busy'] / parts['step_wall']) * 100:.1f}%); 11 steps "
        f"wall {parts['steps_wall']:.1f} ms")
    say(f"{tag}: decode step 5 kernels: {parts['step_kernels']}")


def phase_profile(dev, setup):
    """Where one chunk's time goes, on the slice's engine and inputs
    (step_breakdown), then one ground_windows under the profiler, its
    kernel time by group."""
    import torch

    eng, movie, qf_np, _ = setup
    say_breakdown("profile", step_breakdown(eng, movie, qf_np))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.ground_windows(movie, SENTENCE, qf_np, None, movie_key="movie0")
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    groups, other = group_kernels(kernel_events(prof))
    busy = sum(ms for ms, _ in groups.values())
    say(f"profile: one ground_windows under the profiler: wall {wall:.1f} ms, summed kernel "
        f"time {busy:.1f} ms (device idle share {max(0.0, 1 - busy / wall) * 100:.1f}%)")
    for label, (ms, n) in groups.items():
        say(f"profile:   {ms:9.2f} ms  x{n:<6d} {label}")
    top = sorted(other.items(), key=lambda kv: -kv[1][0])
    for name, (ms, n) in top[:8]:
        say(f"profile:     of which {ms:9.2f} ms  x{n:<6d} {name[:90]}")
    rest = [sum(ms for _, (ms, _) in top[8:]), sum(n for _, (_, n) in top[8:])]
    say(f"profile:     of which {rest[0]:9.2f} ms  x{rest[1]:<6d} the {len(top[8:])} other kernel names")


# ------------------------------------------------------------------ phase 5


def _to(tree, device, grad=False):
    """A copy of the tree's tensors on `device` (fresh leaves that require
    grad with grad=True)."""
    if isinstance(tree, dict):
        return {k: _to(v, device, grad) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device, grad) for v in tree]
    if grad:
        return tree.detach().to(device, copy=True).requires_grad_()
    return tree.to(device)


def compare_paths(dev, cfg, acfg, batch, num_frames, new_tokens, seed=0, quantize="int8",
                  pack=False):
    """Kernel path on `dev` against the plain path on the CPU, from the same
    seed, serving numerics on both (W8A8, KV8, f32 attention scores on the
    CPU as in K2), in the current switches, on int8 or int4 weights, the
    int8 layers packed into the serving chunks with `pack`. Returns (max
    |logit diff|, max |logit|, token agreement, max entropy diff, calls of
    row 10's plain version on the CPU side)."""
    import torch
    from revisionllm_tpu_torch.constants import IMAGE_TOKEN_INDEX
    from revisionllm_tpu_torch.models import generation, llama, revisionllm
    from revisionllm_tpu_torch.models.multimodal import build_splice_plan, stack_plans
    from revisionllm_tpu_torch.ops import decode_serve, flash_attention, quant

    cpu = torch.device("cpu")
    params = llama.init_params(cfg, seed=seed, dtype=torch.bfloat16, device=cpu,
                               quantize=quantize)
    if pack:
        params["layers"] = decode_serve.pack_serving_weights(params["layers"])
    plain_serve = decode_serve.decode_step_serve_plain
    calls = []
    vision = revisionllm.init_vision_params(acfg, seed=seed + 1, d_in=acfg.d_model,
                                            dtype=torch.bfloat16, device=cpu)
    rng = np.random.default_rng(seed)
    images = torch.from_numpy(rng.normal(size=(batch, num_frames, acfg.d_model)).astype(np.float32))
    qf = torch.from_numpy(rng.normal(size=(batch, 25, acfg.d_model)).astype(np.float32))
    ids = [1] + list(range(100, 140)) + [IMAGE_TOKEN_INDEX] + list(range(200, 220))
    plan_np = stack_plans([build_splice_plan(ids, num_frames, len(ids) - 1 + num_frames + new_tokens)] * batch)
    quant.set_w8a8(True)
    generation.set_kv8(True)
    flash_attention.set_attn_bf16(False)
    decode_serve.decode_step_serve_plain = lambda *a, **k: calls.append(1) or plain_serve(*a, **k)
    try:
        outs = {}
        for device in (dev, cpu):
            p, vp = _to(params, device), _to(vision, device)
            plan = {k: torch.as_tensor(v, device=device) for k, v in plan_np.items()}
            im = images.to(device, torch.bfloat16)
            q = qf.to(device, torch.bfloat16)
            video = revisionllm.encode_video(acfg, vp, im, q)
            embeds, pos, lens = revisionllm.assemble_inputs(p, plan, video, dtype=torch.bfloat16)
            logits, _ = llama.prefill_kv(cfg, p, embeds, pos, kv_lens=lens, kv_quant=True)
            gen = revisionllm.generate_grounding(cfg, acfg, p, vp, plan, im, q, eos_id=2,
                                                 max_new_tokens=new_tokens)
            outs[device.type] = (logits.float().cpu(), gen["tokens"].cpu(),
                                 gen["entropy"].float().cpu())
    finally:
        quant.set_w8a8(None)
        generation.set_kv8(None)
        flash_attention.set_attn_bf16(None)
        decode_serve.decode_step_serve_plain = plain_serve
    (lk, tk, ek), (lp, tp, ep) = outs[dev.type], outs["cpu"]
    diff = (lk - lp).abs().max().item()
    agree = (tk == tp).float().mean().item()
    return diff, lp.abs().max().item(), agree, (ek - ep).abs().max().item(), len(calls)


def phase_compare(dev, label="int8 serving", quantize="int8", env=None, launched=(),
                  pack=False):
    """One compare_paths run in the configuration's switches; fails unless
    the first-step logits agree within 5% of the largest, unless the card's
    run launched each kernel of `launched`, and, where that is row 10,
    unless the CPU side ran row 10's plain version (so a compare of two
    split paths cannot pass)."""
    from revisionllm_tpu_torch.config import AdapterConfig, LlamaConfig
    from revisionllm_tpu_torch.utils import kernels

    cfg = LlamaConfig(num_layers=2)
    acfg = AdapterConfig(clip_adapter_text=True, hierarchy=False, feature_mode="temporal",
                         hidden_size=cfg.hidden_size)
    t0 = time.perf_counter()
    kernels.reset_launches()
    with switched(env or {}):
        diff, scale, agree, ent, plain_calls = compare_paths(
            dev, cfg, acfg, batch=2, num_frames=250, new_tokens=12, quantize=quantize, pack=pack)
    missing = [k for k in launched if kernels.LAUNCHES[k] == 0]
    if "decode_step_serve" in launched and plain_calls == 0:
        missing.append("decode_step_serve_plain on the CPU")
    # bf16 activations, and int8 activation or KV quantization can round a
    # value across a boundary on one side only: 5% of the largest logit
    tol = 5e-2 * max(1.0, scale)
    say(f"compare ({label}): Vicuna-7B width, 2 layers, kernels on the card vs plain on the "
        f"CPU: first-step logits max_abs_diff {diff:.4e} (tol {tol:.3e}, max |logit| "
        f"{scale:.3f}); greedy tokens agree {agree * 100:.1f}%; entropy max_abs_diff "
        f"{ent:.3e} ({time.perf_counter() - t0:.1f} s)")
    if missing:
        raise AssertionError(f"compare ({label}): never launched: {missing}")
    if not diff <= tol:
        raise AssertionError(f"logits differ by {diff} > {tol}")


# ------------------------------------------------------------------ phase 7


def _pairs(T, lens, causal=True):
    """Live (row, column) pairs of attention over T rows with kv_len per
    batch row (causal: row >= column)."""
    seen = np.arange(T) + 1 if causal else np.full(T, T)  # columns row t may see
    return sum(int(np.minimum(seen, n).sum()) for n in lens)


TILE = 64                   # rows of a q or kv tile of the attention kernels (attention_common.cuh)
VJP_TOL = 1e-2              # relative L2 error of a whole o, dq, dk or dv
VJP_TILE_TOL = 2e-2         # ... and of each of its (64-row tile, head) blocks
# the correctness-only cases of the row-4 kernels and K2 on the card:
# (label, B, T, H, KH, causal, kv_lens), each kv_len on its own batch row
EDGE_LENS = (1, 63, 64, 65, 127, 128, 129)
EDGE_CASES = (
    ("kv_len at the tile edges, causal", len(EDGE_LENS), 256, 4, 4, True, EDGE_LENS),
    ("kv_len at the tile edges, not causal", len(EDGE_LENS), 256, 4, 4, False, EDGE_LENS),
    ("T 2000 (not a multiple of the tile)", 2, 2000, 32, 32, True, (2000, 1999)),
    ("GQA 32 query heads over 8 kv heads", 2, 512, 32, 8, True, (512, 300)),
    ("not causal", 2, 300, 8, 8, False, (300, 129)),
)


def row4_bounds(B, H, T, d, lens, causal=True):
    """{kernel: (bound ms, "bytes" or "operations")} of row 4's three
    kernels on q/k/v/dO [B, T, H, d] with kv_len lens[b] per batch row:
    each input read once (k and v only to kv_len), each output written once,
    and 2 d flops a product for each live (row, column) pair: 2 products in
    the forward, 3 in dq (S, dP, dQ), 4 in dk/dv (S, dP, dV, dK)."""
    pairs = _pairs(T, lens, causal)
    rows_b = B * T * H * d * 2          # one bf16 [B, T, H, d] tensor, all rows
    kv_b = int(sum(lens)) * H * d * 2   # one bf16 k or v, live rows only
    stat_b = B * H * T * 4              # one f32 lse or delta
    return {
        "flash_fwd_lse": bound(2 * rows_b + 2 * kv_b + stat_b + B * 4, 4.0 * H * d * pairs),
        "flash_dq": bound(3 * rows_b + 2 * kv_b + 2 * stat_b + B * 4, 6.0 * H * d * pairs),
        # dk and dv are written for all T rows (zeros past kv_len)
        "flash_dkv": bound(4 * rows_b + 2 * kv_b + 2 * stat_b + B * 4, 8.0 * H * d * pairs),
    }


def rel_errs(got, want):
    """(relative L2 error of the whole [B, N, H, d] tensor, the worst
    relative L2 error of one of its (64-row tile, head) blocks). A block
    whose reference is all zeros counts inf unless it is zeros too."""
    import torch
    import torch.nn.functional as F

    g, w = got.float(), want.float()
    B, N, H, d = w.shape

    def blocks(x):
        return F.pad(x, (0, 0, 0, 0, 0, -N % TILE)).reshape(B, -1, TILE, H, d).sum(dim=(2, 4))

    e, r = blocks((g - w).square()), blocks(w.square())
    per = torch.where(r > 0, (e / r.clamp_min(1e-30)).sqrt(),
                      torch.where(e > 0, torch.full_like(e, math.inf), torch.zeros_like(e)))
    return (e.sum() / r.sum()).sqrt().item(), per.max().item()


def hold(label, got, want, faults=None):
    """Hold `got` against `want` by relative L2 error, whole (VJP_TOL) and
    per (64-row tile, head) block (VJP_TILE_TOL); each planted fault must
    fail those limits. Returns the max abs error."""
    rel, worst = rel_errs(got, want)
    err = (got.float() - want.float()).abs().max().item()
    found = {f: rel_errs(bad, want) for f, bad in (faults or {}).items()}
    say(f"{label}: relative L2 {rel:.2e} (tol {VJP_TOL:.0e}), worst tile {worst:.2e} "
        f"(tol {VJP_TILE_TOL:.0e}), max_abs_err {err:.3e}"
        + ("; planted faults, worst tile (whole tensor): "
           + ", ".join(f"{f} {w:.2e} ({r:.2e})" for f, (r, w) in found.items()) if found else ""))
    if not (rel <= VJP_TOL and worst <= VJP_TILE_TOL):
        raise AssertionError(f"{label}: relative L2 {rel}, worst tile {worst}")
    passed = [f for f, (r, w) in found.items() if r <= VJP_TOL and w <= VJP_TILE_TOL]
    if passed:
        raise AssertionError(f"{label}: the limits accept planted faults {passed}")
    return err


def check_flash_edges(dev, cases=EDGE_CASES):
    """Correctness only: K2's forward, row 4's forward with the LSE, dq and
    dk/dv against their plain versions on each of `cases` (kv_len on both
    sides of a tile edge, T not a multiple of the tile, GQA, not causal), by
    the limits of `hold` and 1e-3 on the LSE. Returns the worst max abs
    error of each kernel."""
    import torch
    from revisionllm_tpu_torch.ops import flash_attention as FA

    gen = torch.Generator(device=dev).manual_seed(11)
    worst = {name: 0.0 for name in ("flash_attention",) + TRAINING}
    for label, B, T, H, KH, causal, lens in cases:
        q, do = (torch.randn((B, T, H, 128), generator=gen, device=dev).to(torch.bfloat16)
                 for _ in range(2))
        k, v = (torch.randn((B, T, KH, 128), generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(2))
        kw = dict(causal=causal, kv_lens=torch.tensor(lens, dtype=torch.int32, device=dev))
        o, lse = FA.flash_fwd_lse(q, k, v, **kw)
        o2, lse2 = FA.flash_fwd_lse_plain(q, k, v, **kw)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        args = (q, k, v, do, lse, delta)
        dq, (dk, dv) = FA.flash_dq(*args, **kw), FA.flash_dkv(*args, **kw)
        dq2, (dk2, dv2) = FA.flash_dq_plain(*args, **kw), FA.flash_dkv_plain(*args, **kw)
        k2 = FA.flash_attention(q, k, v, **kw)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        lse_err = (lse - lse2).abs().max().item()
        tag = f"{label} (B={B} T={T} H={H} KH={KH} kv_lens {list(lens)})"
        say(f"flash_fwd_lse {tag}: lse max_abs_err {lse_err:.3e} (tol 1e-3)")
        if not lse_err <= 1e-3:
            raise AssertionError(f"flash_fwd_lse {tag}: lse max_abs_err {lse_err} > 1e-3")
        # Where kv_len is 1 every row sees one key: p = 1 and dp = delta, so
        # dq and dk are 0 in exact arithmetic, and kernel and plain version
        # both hold only f32 rounding residue, which a relative error cannot
        # judge. There they are held to stay below 1e-3 of the largest
        # element of the other batch rows; every other row by `hold`.
        one = torch.tensor([n == 1 for n in lens], device=dev)
        for name, tname, got, want in (
                ("flash_attention", "o", k2, o2), ("flash_fwd_lse", "o", o, o2),
                ("flash_dq", "dq", dq, dq2), ("flash_dkv", "dk", dk, dk2),
                ("flash_dkv", "dv", dv, dv2)):
            if tname in ("dq", "dk") and bool(one.any()):
                scale = want[~one].float().abs().max().item()
                resid = max(got[one].float().abs().max().item(), want[one].float().abs().max().item())
                say(f"{name} {tname} {tag}, kv_len 1 rows (0 in exact arithmetic): largest "
                    f"{resid:.3e} against {scale:.3e} elsewhere (limit 1e-3 of it)")
                if not resid <= 1e-3 * scale:
                    raise AssertionError(f"{name} {tname} {tag}: kv_len 1 rows reach {resid}")
                got, want = got[~one], want[~one]
            worst[name] = max(worst[name], hold(f"{name} {tname} {tag}", got, want))
    return worst


def check_flash_vjp(dev, iters):
    """Row 4 at the training shape, at full length and at the training
    batch's ragged kv_len. Returns the three kernel records: the ragged
    case, which is what a training batch gives them, with the full-length
    numbers under "full"."""
    import torch
    import torch.nn.functional as F
    from revisionllm_tpu_torch.ops import flash_attention as FA

    B, H, T, d = 1, 32, 2048, 128
    gen = torch.Generator(device=dev).manual_seed(7)
    q, k, v, do = (torch.randn((B, T, H, d), generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(4))
    kw = dict(causal=True)
    # Tolerances. In causal attention the magnitudes span four decades: row
    # 0 of o is v[0] itself, key column 0 of dk/dv sums over every row,
    # the last columns over a few. So no fraction of the largest element
    # and no single per-element atol fits every row. Each of o, dq, dk and
    # dv is held by relative L2 error, of the whole tensor (1e-2) and of
    # every (64-row tile, head) block (2e-2): bf16 rounding of P, dS and
    # the output is about 2^-9 relative, and a kernel that mis-scales,
    # skips or misplaces one tile of rows or keys moves its blocks by far
    # more. Two planted faults, on the kernels' own 64-row tiles, must fail
    # these limits: the last live tile scaled by 0.9, and the last live kv
    # tile dropped (the plain version at kv_len cut to that tile's start).
    # lse is f32: 1e-3 absolute.
    records = {name: {"name": name, "max_abs_err": 0.0} for name in TRAINING}
    for label, n in (("full", T), ("ragged", 330)):
        lens = torch.full((B,), n, dtype=torch.int32, device=dev)
        o, lse = FA.flash_fwd_lse(q, k, v, kv_lens=lens, **kw)
        o2, lse2 = FA.flash_fwd_lse_plain(q, k, v, kv_lens=lens, **kw)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        args = (q, k, v, do, lse, delta)
        dq = FA.flash_dq(*args, kv_lens=lens, **kw)
        dq2 = FA.flash_dq_plain(*args, kv_lens=lens, **kw)
        dk, dv = FA.flash_dkv(*args, kv_lens=lens, **kw)
        dk2, dv2 = FA.flash_dkv_plain(*args, kv_lens=lens, **kw)
        last_q = slice(TILE * ((T - 1) // TILE), T)
        last_kv = slice(TILE * ((n - 1) // TILE), n)
        short = torch.full_like(lens, last_kv.start)
        o3, _ = FA.flash_fwd_lse_plain(q, k, v, kv_lens=short, **kw)
        dq3 = FA.flash_dq_plain(*args, kv_lens=short, **kw)
        dk3, dv3 = FA.flash_dkv_plain(*args, kv_lens=short, **kw)
        torch.cuda.synchronize()
        lse_err = (lse - lse2).abs().max().item()
        if not lse_err <= 1e-3:
            raise AssertionError(f"flash_fwd_lse {label}: lse max_abs_err {lse_err} > 1e-3")
        errs = {"flash_fwd_lse": 0.0, "flash_dq": 0.0, "flash_dkv": 0.0}
        for name, tname, got, want, dropped, tile in (
                ("flash_fwd_lse", "o", o, o2, o3, last_q), ("flash_dq", "dq", dq, dq2, dq3, last_q),
                ("flash_dkv", "dk", dk, dk2, dk3, last_kv), ("flash_dkv", "dv", dv, dv2, dv3, last_kv)):
            scaled = got.clone()
            scaled[:, tile] *= 0.9
            err = hold(f"{name} {tname} ({label}, kv_len {n})", got, want, {
                "last live tile x0.9": scaled, "last live kv tile dropped": dropped})
            errs[name] = max(errs[name], err)
            records[name]["max_abs_err"] = max(records[name]["max_abs_err"], err)
        plain_iters = max(3, iters // 4)
        t_fwd = device_ms(lambda: FA.flash_fwd_lse(q, k, v, kv_lens=lens, **kw), iters)
        t_dq = device_ms(lambda: FA.flash_dq(*args, kv_lens=lens, **kw), iters)
        t_dkv = device_ms(lambda: FA.flash_dkv(*args, kv_lens=lens, **kw), iters)
        p_fwd = device_ms(lambda: FA.flash_fwd_lse_plain(q, k, v, kv_lens=lens, **kw), plain_iters)
        p_dq = device_ms(lambda: FA.flash_dq_plain(*args, kv_lens=lens, **kw), plain_iters)
        p_dkv = device_ms(lambda: FA.flash_dkv_plain(*args, kv_lens=lens, **kw), plain_iters)
        # one SDPA call for the same function: is_causal at full length, an
        # explicit causal + kv_lens mask when ragged; its backward computes
        # dq, dk and dv together
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
        dot = do.transpose(1, 2).contiguous()
        mask = None if label == "full" else FA._kv_mask(B, T, T, lens, True, dev)
        sdpa = partial(F.scaled_dot_product_attention, is_causal=mask is None, attn_mask=mask)
        with torch.no_grad():
            l_fwd = device_ms(lambda: sdpa(qt, kt, vt), iters)
        out = sdpa(qt, kt, vt)
        l_bwd = device_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True), iters)
        del out
        bounds = row4_bounds(B, H, T, d, [n] * B)
        times = {"flash_fwd_lse": (t_fwd, p_fwd, l_fwd), "flash_dq": (t_dq, p_dq, l_bwd),
                 "flash_dkv": (t_dkv, p_dkv, l_bwd)}
        say(f"row 4 backward (dq + dk/dv) kv_len={n} ({label}): {t_dq + t_dkv:.4f} ms")
        for name in TRAINING:
            ms, plain, lib = times[name]
            b, by = bounds[name]
            lib_label = "sdpa fwd" if name == "flash_fwd_lse" else "sdpa bwd (dq+dk+dv)"
            say(f"{name} B={B} H={H} T=S={T} d={d} causal kv_len={n} ({label}): "
                f"max_abs_err {errs[name]:.3e} kernel {ms:.4f} ms plain {plain:.4f} ms "
                f"{lib_label}{' is_causal' if mask is None else ' masked'} {lib:.4f} ms "
                f"bound {b:.4f} ms ({by})")
            rec = dict(ms=ms, plain_ms=plain, bound_ms=b, bound_by=by, library_ms=lib)
            if label == "ragged":
                records[name].update(rec, unit=f"one launch = one layer, T=2048, kv_len {n} "
                                               f"(library: {lib_label}, masked)")
            else:
                records[name]["full"] = dict(rec, kv_len=n, library=f"{lib_label}, is_causal")
    return [records[name] for name in TRAINING]


# ------------------------------------------------------------------ phase 8


def _corpus(tmp):
    from revisionllm_tpu_torch.data.synthetic import make_synthetic_corpus

    return make_synthetic_corpus(os.path.join(tmp, "corpus"), n_train_movies=8, n_val_movies=1,
                                 d=768, duration=540.0, fps=5.0, seed=11)


def train_argv(paths, out, steps):
    """train_cli flags for the QLoRA configuration of
    scripts/train_7b_sustained.py:147-163 (the stage1_dense preset with an
    int8 base, batch 1, sequence 2048), `steps` steps, one save at the end."""
    return ["--preset", "stage1_dense", "--quant_base", "--seed", "0",
            "--data_path", paths["train_json"], "--feat_folder", paths["features"],
            "--q_feat_dir", paths["queries"], "--output_dir", out,
            "--per_device_batch_size", "1", "--max_steps", str(steps),
            "--save_steps", str(steps), "--log_steps", "1"]


class _CountIntMM:
    """Counts torch._int_mm calls (the W8A8 GEMM) while installed."""

    def __init__(self):
        import torch

        self.n = 0
        self.orig = torch._int_mm

    def __call__(self, *a, **k):
        self.n += 1
        return self.orig(*a, **k)

    def __enter__(self):
        import torch

        torch._int_mm = self
        return self

    def __exit__(self, *exc):
        import torch

        torch._int_mm = self.orig


def check_no_silent_detach(dev):
    """q8_apply on a grad-requiring bf16 CUDA tensor at M = 64 raises outside
    the exact trace (K1 has no backward), and inside it gives the dequant
    route's gradient."""
    import torch
    from revisionllm_tpu_torch.ops import quant as Q
    from revisionllm_tpu_torch.train.trainer import _dequant_trace

    gen = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn((64, 4096), generator=gen, device=dev).to(torch.bfloat16).requires_grad_()
    q, s = Q.quantize_int8(torch.randn((4096, 1024), generator=gen, device=dev) * 4096 ** -0.5)
    w = {"q8": q, "scale": s}
    try:
        Q.q8_apply(x, w)
    except RuntimeError as e:
        say(f"no silent detach: q8_apply(grad-requiring bf16 x, M=64) outside the exact trace "
            f"raises: {str(e)[:80]}...")
    else:
        raise AssertionError("K1 accepted a grad-requiring input outside the exact trace")
    with _dequant_trace():
        Q.q8_apply(x, w).float().sum().backward()
    ones = torch.ones((64, 1024), device=dev, dtype=torch.bfloat16)
    want = (ones @ Q.dequantize_int8(q, s, torch.bfloat16).T).float()
    err = (x.grad.float() - want).abs().max().item()
    tol = 2.0 ** -8 * want.abs().max().item()  # one bf16 step: the same product
    say(f"no silent detach: inside the exact trace the gradient is g dequant(W)^T "
        f"(max_abs_err {err:.3e}, tol {tol:.3e})")
    if not err <= tol:
        raise AssertionError(f"exact-trace gradient differs by {err} > {tol}")


def phase_train(dev, tmp, paths):
    """The training slice through the training entry point, train_cli.main:
    1 warm-up and TRAIN_STEPS timed steps, an async save at the last step,
    the export; then the checkpoint against the trained trees, one step
    under the profiler, and auto-resume for one more step. Returns the
    launches of main's steps."""
    import torch
    from revisionllm_tpu_torch.train import checkpoint, optimizer, train_cli, trainer
    from revisionllm_tpu_torch.utils import kernels

    out = os.path.join(tmp, "run")
    marks, losses, gnorms, live, peak = [], [], [], [], []

    def on_step(step, batch, metrics):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
        live.append(int(batch["lengths"].sum()))
        if step == 1:
            torch.cuda.reset_peak_memory_stats()
        peak.append(torch.cuda.max_memory_allocated() / 2 ** 30)

    kernels.reset_launches()
    t0 = time.perf_counter()
    with _CountIntMM() as int_mm:
        run, opt = train_cli.main(train_argv(paths, out, TRAIN_STEPS + 1), on_step=on_step)
    t_end = time.perf_counter()
    launches = dict(kernels.LAUNCHES)
    cfg = run.llama_cfg
    n_lora = sum(t.numel() for t in trainer.tree_leaves(run.trainable["lora"]))
    n_vis = sum(t.numel() for t in trainer.tree_leaves(run.trainable["vision"]))
    say(f"train: train_cli.main, Vicuna-7B QLoRA, {cfg.num_layers} layers, int8 base + dense "
        f"bf16 lm_head, LoRA r={run.train_cfg.lora.r} ({n_lora / 1e6:.1f} M params f32) + "
        f"ClipEncoder/T2V adapter ({n_vis / 1e6:.1f} M params bf16), seq "
        f"{run.train_cfg.model_max_length}, batch 1, remat; {len(run.dataset)} training items; "
        f"set-up and warm-up step {marks[0] - t0:.2f} s; async save at step {TRAIN_STEPS + 1}, "
        f"wait and export {t_end - marks[-1]:.2f} s")
    steps = np.diff(marks)
    med = float(np.median(steps))
    say(f"train: {TRAIN_STEPS} loop steps after the warm-up (batch build, step, log line): ms "
        f"{[round(float(x) * 1e3, 1) for x in steps]}; median {med * 1e3:.1f} ms, spread (max - min) "
        f"{(steps.max() - steps.min()) * 1e3:.1f} ms, std {float(np.std(steps)) * 1e3:.1f} ms")
    build = []
    for i in range(TRAIN_STEPS):
        h0 = time.perf_counter()
        run.batch([i])
        build.append(time.perf_counter() - h0)
    say(f"train: batch build on the host, timed apart: median {float(np.median(build)) * 1e3:.1f} ms")
    say(f"train: tokens/s padded {run.train_cfg.model_max_length / med:.1f}, live "
        f"{float(np.mean(live[1:])) / med:.1f} (live tokens per step {live}); peak memory over "
        f"the timed steps {peak[-1]:.2f} GiB")
    say(f"train: loss per step {[round(x, 4) for x in losses]}; grad norm "
        f"{[round(x, 4) for x in gnorms]}")
    per_step = {k: launches[k] / (TRAIN_STEPS + 1) for k in kernels.COUNTERS}
    say(f"train: launches in main's {TRAIN_STEPS + 1} steps {launches}; per step {per_step}; "
        f"torch._int_mm calls {int_mm.n}")
    if not all(np.isfinite(losses)) or not all(np.isfinite(gnorms)):
        raise AssertionError("non-finite loss or grad norm")
    missing = [k for k in TRAINING if launches[k] == 0]
    if missing:
        raise AssertionError(f"row-4 kernels never launched in training: {missing}")
    stray = {k: launches[k] for k in SERVING + W8A8 if launches[k]}
    if stray or int_mm.n:
        raise AssertionError(f"kernels without a backward ran in the loss: {stray}, "
                             f"torch._int_mm x{int_mm.n}")
    with open(os.path.join(out, "train_log.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    if [e["step"] for e in logged] != list(range(1, TRAIN_STEPS + 2)) or \
            [e["loss"] for e in logged] != losses:
        raise AssertionError(f"train_log.jsonl differs from the steps: {logged}")

    # the checkpoint main saved asynchronously, restored into fresh trees
    latest = checkpoint.latest_checkpoint(out)
    t0 = time.perf_counter()
    restored = checkpoint.restore_checkpoint(latest, {"trainable": run.trainable})
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    got, want = trainer.tree_leaves(restored["trainable"]), trainer.tree_leaves(run.trainable)
    if not (len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want))
            and restored["step"] == TRAIN_STEPS + 1):
        raise AssertionError("restored checkpoint differs from the trained state")
    opt2 = optimizer.AdamW(got, run.train_cfg, total_steps=TRAIN_STEPS + 1)
    opt2.load_state_dict(restored["opt_state"])
    if opt2.count != opt.count:
        raise AssertionError("restored optimizer state differs")
    del restored, got, opt2
    size = sum(os.path.getsize(os.path.join(latest, f)) for f in os.listdir(latest)) / 2 ** 20
    files = {f: round(os.path.getsize(os.path.join(out, f)) / 2 ** 20, 1) for f in
             ("adapter_config.json", "adapter_model.bin", "non_lora_trainables.bin")}
    say(f"train: checkpoint {latest.rsplit('/', 1)[-1]} ({size:.0f} MiB) restored into fresh "
        f"trees in {t_restore:.1f} s, equal; export {files} MiB")

    # one more step under the profiler: where its time goes
    step_fn = trainer.make_train_step(cfg, run.adapter_cfg, run.train_cfg, opt)
    batch = run.batch([0])
    gen = torch.Generator(device=dev).manual_seed(5)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(run.trainable, run.frozen, run.base, batch, gen)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    groups, other = group_kernels(kernel_events(prof))
    busy = sum(ms for ms, _ in groups.values())
    say(f"train profile: one step under the profiler: wall {wall:.1f} ms, summed kernel time "
        f"{busy:.1f} ms (device idle share {max(0.0, 1 - busy / wall) * 100:.1f}% under the "
        f"profiler, {max(0.0, 1 - busy / (med * 1e3)) * 100:.1f}% of the median loop step)")
    for label, (ms, n) in groups.items():
        if n:
            say(f"train profile:   {ms:9.2f} ms  x{n:<6d} {label}")
    top = sorted(other.items(), key=lambda kv: -kv[1][0])
    for name, (ms, n) in top[:10]:
        say(f"train profile:     of which {ms:9.2f} ms  x{n:<6d} {name[:100]}")
    rest = [sum(ms for _, (ms, _) in top[10:]), sum(n for _, (_, n) in top[10:])]
    say(f"train profile:     of which {rest[0]:9.2f} ms  x{rest[1]:<6d} the {len(top[10:])} "
        f"other kernel names")
    dequant_ms = time_dequant_passes(dev, run.base, cfg)
    say(f"train profile: dequant passes timed apart: one layer's 7 matrices {dequant_ms:.3f} ms; "
        f"x {cfg.num_layers} layers x 2 (forward, remat recompute) = "
        f"{dequant_ms * cfg.num_layers * 2:.1f} ms per step (inside the elementwise group)")
    del run, opt, step_fn, batch, prof
    torch.cuda.empty_cache()

    # auto-resume: main again with one more step picks up checkpoint-7
    t0 = time.perf_counter()
    resumed = []
    run, _ = train_cli.main(train_argv(paths, out, TRAIN_STEPS + 2),
                            on_step=lambda step, b, m: resumed.append((step, float(m["loss"]))))
    with open(os.path.join(out, "train_log.jsonl")) as f:
        steps_logged = [json.loads(line)["step"] for line in f]
    say(f"train: resumed main ran steps {resumed} in {time.perf_counter() - t0:.1f} s; the log "
        f"holds steps {steps_logged}; latest {checkpoint.latest_checkpoint(out).rsplit('/', 1)[-1]}")
    if [s for s, _ in resumed] != [TRAIN_STEPS + 2] or not np.isfinite(resumed[0][1]) or \
            steps_logged != list(range(1, TRAIN_STEPS + 3)):
        raise AssertionError("auto-resume did not continue from the last checkpoint")
    del run
    torch.cuda.empty_cache()
    check_no_silent_detach(dev)
    return launches


def time_dequant_passes(dev, base, cfg):
    """Device ms of one layer's seven dequantize_int8 calls (int8 -> bf16),
    as the exact trace runs them before each matmul."""
    import torch
    from revisionllm_tpu_torch.models.llama import LAYER_MATRICES, layer_params
    from revisionllm_tpu_torch.ops import quant as Q

    lp = layer_params(base, 0)

    def run():
        for name in LAYER_MATRICES:
            Q.dequantize_int8(lp[name]["q8"], lp[name]["scale"], torch.bfloat16)

    return device_ms(run, 10)


# ------------------------------------------------------------------ phase 9


def _named_leaves(tree, prefix=""):
    """(path, tensor) of a nested dict / list tree, in trainer.tree_leaves
    order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _named_leaves(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _named_leaves(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def phase_train_compare(dev, paths):
    """One train step's loss and gradients of every trainable leaf (LoRA
    and the ClipEncoder/T2V adapter): kernels on the card against the plain
    path on the CPU, from train_cli's assembly at full width, 2 layers and
    the main path's sequence of 2048, adapter dropout 0 (the two devices'
    generators draw different masks)."""
    hold_train_step(dev, train_argv(paths, "unused", 1), "train compare")


def grad_rel_errors(got, want):
    """{leaf: relative L2 error of got[leaf] against want[leaf]}. The key
    projection's bias has no gradient in exact arithmetic (it adds the same
    q.b to every score of a row, which the softmax ignores), so both sides
    return rounding noise there, about 1e-8 in norm: its error is measured
    against the gradient of the same layer's query bias."""
    rel = {}
    for n, w in want.items():
        ref = want[n[:-len("wk/b")] + "wq/b"] if n.endswith("/wk/b") else w
        e, r = (got[n] - w).norm().item(), ref.norm().item()
        rel[n] = e / r if r > 0 else (math.inf if e > 0 else 0.0)
    return rel


def hold_train_step(dev, argv, tag, adapter=None, data=None, iteration_step=0,
                    **train_overrides):
    """One train step of train_cli's assembly of `argv` (its preset at full
    width, cut to 2 layers, adapter dropout 0, the AdapterConfig fields of
    `adapter`, the DataConfig fields of `data` and the TrainConfig fields of
    `train_overrides` replaced; the stream loss for a stream preset) on its
    first batch (drawn at `iteration_step`, which the loss also gets: the
    'alternate' adapter's parity): the loss and the gradient of every
    trainable leaf with the kernels on the card against the plain path on
    the CPU, by phase 9's limits. Prints under `tag`; returns the batch (on
    the CPU)."""
    import dataclasses

    import torch
    from revisionllm_tpu_torch.train import train_cli, trainer

    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    secs = {}
    args = train_cli.parse_args(argv)
    llama_cfg, adapter_cfg, data_cfg, train_cfg = train_cli.build_configs(args)
    run = train_cli.assemble(dataclasses.replace(llama_cfg, num_layers=2),
                             dataclasses.replace(adapter_cfg, dropout=0.0, **(adapter or {})),
                             dataclasses.replace(data_cfg, **(data or {})),
                             dataclasses.replace(train_cfg, **train_overrides), cpu, seed=0,
                             quant_base=args.quant_base)
    run.dataset.iteration_step = iteration_step
    batch = run.batch([0])
    if data_cfg.stream:
        loss_fn = trainer.make_stream_loss_fn(run.llama_cfg, run.adapter_cfg, run.train_cfg)
    else:
        loss_fn = trainer.make_loss_fn(run.llama_cfg, run.adapter_cfg, run.train_cfg,
                                       iteration_step)
    out = {}
    secs["assembly"] = time.perf_counter() - t0
    for device in (dev, cpu):
        t1 = time.perf_counter()
        b, bs = _to(run.base, device), _to(batch, device)
        tr = _to(run.trainable, device, grad=True)
        named = _named_leaves(tr)
        gen = torch.Generator(device=device).manual_seed(0)
        with trainer._dequant_trace():
            loss = loss_fn(tr, {}, b, bs, gen)
            # a leaf the loss does not reach (the performer's detached
            # features) gets a zero gradient, as in the train step
            grads = torch.autograd.grad(loss, [t for _, t in named], allow_unused=True)
        out[device.type] = (loss.item(), {n: (torch.zeros_like(t) if g is None else g).float().cpu()
                                          for (n, t), g in zip(named, grads)})
        secs[device.type] = time.perf_counter() - t1
    (lk, gk), (lp, gp) = out[dev.type], out["cpu"]
    rel = grad_rel_errors(gk, gp)
    groups = {"LoRA-B": [n for n in rel if n.startswith("lora/") and n.endswith("/b")],
              "LoRA-A (zero: B starts at 0)": [n for n in rel if n.startswith("lora/") and n.endswith("/a")],
              "vision": [n for n in rel if n.startswith("vision/")]}
    if sorted(sum(groups.values(), [])) != sorted(rel):
        raise AssertionError(f"unexpected trainable leaves: {sorted(rel)}")
    worst = {g: max(names, key=rel.get) for g, names in groups.items()}
    # bf16 activations on both sides, f32 sums in another order, two layers
    # of backward, bf16 adapter gradients: the loss within 2e-3 relative
    # (4.5x the 4.4e-4 gap read on the H100), each gradient within 5e-2
    # relative L2 (2.3x the worst leaf read there, 2.2e-2)
    loss_tol, grad_tol = 2e-3, 5e-2
    say(f"{tag}: Vicuna-7B width, 2 layers, seq {run.train_cfg.model_max_length}, "
        f"kernels on the card vs plain on the CPU: loss {lk:.5f} vs {lp:.5f} (rel diff "
        f"{abs(lk - lp) / abs(lp):.2e}, tol {loss_tol:.0e}); gradient relative L2, worst leaf "
        f"of each group: " + "; ".join(f"{g} ({len(groups[g])} leaves) {rel[n]:.2e} at {n}"
                                      for g, n in worst.items())
        + f" (tol {grad_tol:.0e}) ({time.perf_counter() - t0:.1f} s: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items()) + ")")
    top = sorted(groups["vision"], key=rel.get, reverse=True)[:5]
    say(f"{tag}: the 5 worst vision leaves "
        + str({n: float(f"{rel[n]:.2e}") for n in top}) + "; key-bias gradient norms "
        + str({n: (float(f"{gk[n].norm().item():.2e}"), float(f"{gp[n].norm().item():.2e}"))
               for n in groups["vision"] if n.endswith("/wk/b")}) + " (card, CPU)")
    if not abs(lk - lp) <= loss_tol * abs(lp):
        raise AssertionError(f"{tag}: train loss differs: {lk} vs {lp}")
    bad = {n: r for n, r in rel.items() if not r <= grad_tol}
    if bad:
        raise AssertionError(f"{tag}: gradients differ: {bad}")
    return batch


# ------------------------------------------------------------------ phase 10


def fake_tokenizer():
    """The word-level FakeTokenizer with the numbers 0-299 registered, so
    generated ids decode to digits."""
    from revisionllm_tpu_torch.utils.testing import FakeTokenizer

    tok = FakeTokenizer()
    for i in range(300):
        tok._id(str(i))
    return tok


def prompt_geometry(question_key, num_videos, new_tokens):
    """(P, T, live length) of the engine's splice plan for SENTENCE: the
    first video slot (the shared prefix), the padded length and the live
    length."""
    from revisionllm_tpu_torch.constants import QUESTIONS
    from revisionllm_tpu_torch.conversation import CONV_VICUNA_V1
    from revisionllm_tpu_torch.models.multimodal import KIND_VIDEO, build_splice_plan
    from revisionllm_tpu_torch.tokenization import tokenizer_image_token

    prompt = CONV_VICUNA_V1.user_turn_prompt("<video>\n" + QUESTIONS[question_key].format(SENTENCE))
    ids = tokenizer_image_token(prompt, fake_tokenizer())
    plan = build_splice_plan(ids, num_videos, len(ids) - 1 + num_videos + new_tokens)
    return int(np.argmax(plan.kind == KIND_VIDEO)), len(plan.kind), plan.length


def stage2_passes_1h():
    """Stage-2 passes of the 1-hour movie when the prefilter keeps every
    strided window (random weights answer every stage-1 window): 143
    windows at zooms 4, 2, 1 over batch 100."""
    from revisionllm_tpu_torch.ops.windows import num_windows_strided

    nw = num_windows_strided(18000, 625, 5)
    return sum(math.ceil(nw / (100 // z)) for z in (4, 2, 1))


def dropped_prefix_tile(q, k, v, pk, pv, lens):
    """Row 6's plain version with the prefix's last 64-row tile dropped (the
    causal block alone when the prefix is one tile)."""
    from revisionllm_tpu_torch.ops import flash_attention as FA

    cut = TILE * ((pk.shape[1] - 1) // TILE)
    if cut == 0:
        return FA.flash_attention_plain(q, k, v, causal=True, kv_lens=lens)
    return FA.flash_attention_prefixed_plain(q, k, v, pk[:, :cut], pv[:, :cut], kv_lens=lens)


def check_prefix_attention(dev, iters):
    """Rows 6 (flash_attention_prefixed) and 5 (flash_attention_lse) at the
    shared-prefix prefill's shapes: stage 1 (B 64, the real prompt's prefix
    P, T2 the rest of the 1-hour query's plan, ragged rest_lens) and stage 2
    (B the row bucket, T2 about 130). Row 6 against its plain version and
    against the merge of two row-5 launches; row 5 against its plain
    version; two planted faults that must fail (the prefix's last tile
    dropped, the last causal tile x0.9); device times, bounds and SDPA on
    the concatenated kv with an explicit mask. Returns the records of rows
    5 and 6 (timed at the stage-1 shape)."""
    import torch
    import torch.nn.functional as F
    from revisionllm_tpu_torch.eval.engine import GroundingEngine
    from revisionllm_tpu_torch.ops import flash_attention as FA

    H, d = 32, 128
    P1, T1, live1 = prompt_geometry("mad_grounding", 250, 12)
    P2, T2b, live2 = prompt_geometry("retrieval", 100, 8)
    shapes = (("stage 1", 64, P1, T1 - P1, live1 - P1),
              ("stage 2", GroundingEngine._stage2_row_bucket(stage2_passes_1h()), P2, T2b - P2,
               live2 - P2))
    gen = torch.Generator(device=dev).manual_seed(8)
    records = {}
    for label, B, P, T2, rest in shapes:
        q, k, v = (torch.randn((B, T2, H, d), generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        pk, pv = (torch.randn((1, P, H, d), generator=gen, device=dev).to(torch.bfloat16)
                  for _ in range(2))
        # the real row's live rest first, the others ragged below it
        lens = torch.randint(rest // 2, rest + 1, (B,), generator=gen, device=dev,
                             dtype=torch.int32)
        lens[0] = rest
        pkb, pvb = (t.expand(B, -1, -1, -1).contiguous() for t in (pk, pv))
        o6 = FA.flash_attention_prefixed(q, k, v, pk, pv, kv_lens=lens)
        p6 = FA.flash_attention_prefixed_plain(q, k, v, pk, pv, kv_lens=lens)
        o1, l1 = FA.flash_attention_lse(q, pkb, pvb, causal=False)
        o2, l2 = FA.flash_attention_lse(q, k, v, causal=True, kv_lens=lens)
        merged = FA.merge_attention_pieces(o1, l1, o2, l2)
        r1, rl1 = FA.flash_attention_lse_plain(q, pkb, pvb, causal=False)
        r2, rl2 = FA.flash_attention_lse_plain(q, k, v, causal=True, kv_lens=lens)
        last = slice(TILE * ((rest - 1) // TILE), min(T2, TILE * ((rest - 1) // TILE) + TILE))
        scaled = o6.clone()
        scaled[:, last] *= 0.9
        torch.cuda.synchronize()
        tag = f"B={B} H={H} P={P} T2={T2} rest_lens {int(lens.min())}-{rest}"
        e6 = hold(f"flash_attention_prefixed {label} {tag} vs its plain version", o6, p6, {
            "last prefix tile dropped": dropped_prefix_tile(q, k, v, pk, pv, lens),
            "last causal tile x0.9": scaled})
        hold(f"flash_attention_prefixed {label} vs merge of two flash_attention_lse launches",
             o6, merged)
        e5 = max(hold(f"flash_attention_lse {label} prefix piece (not causal, S={P})", o1, r1),
                 hold(f"flash_attention_lse {label} causal piece (S=T2, ragged)", o2, r2))
        lse_err = max((l1 - rl1).abs().max().item(), (l2 - rl2).abs().max().item())
        say(f"flash_attention_lse {label}: lse max_abs_err {lse_err:.3e} (tol 1e-3)")
        if not lse_err <= 1e-3:
            raise AssertionError(f"flash_attention_lse {label}: lse max_abs_err {lse_err}")

        plain_iters = max(3, iters // 4)
        t6 = device_ms(lambda: FA.flash_attention_prefixed(q, k, v, pk, pv, kv_lens=lens), iters)
        pt6 = device_ms(lambda: FA.flash_attention_prefixed_plain(q, k, v, pk, pv, kv_lens=lens),
                        plain_iters)
        t5 = device_ms(lambda: FA.flash_attention_lse(q, k, v, causal=True, kv_lens=lens), iters)
        pt5 = device_ms(lambda: FA.flash_attention_lse_plain(q, k, v, causal=True, kv_lens=lens),
                        plain_iters)
        two = device_ms(lambda: FA.merge_attention_pieces(
            *FA.flash_attention_lse(q, pkb, pvb, causal=False),
            *FA.flash_attention_lse(q, k, v, causal=True, kv_lens=lens)), iters)
        qt = q.transpose(1, 2).contiguous()
        kt, vt = (torch.cat([a, b], dim=1).transpose(1, 2).contiguous()
                  for a, b in ((pkb, k), (pvb, v)))
        col = torch.arange(P + T2, device=dev)
        mask = ((col[None, None, :] < P) | (((col - P)[None, None, :] <= torch.arange(
            T2, device=dev)[None, :, None]) & ((col - P)[None, None, :] < lens[:, None, None])))
        mask = mask[:, None]
        l6 = device_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask), iters)
        ct, cvt = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
        cmask = FA._kv_mask(B, T2, T2, lens, True, dev)
        l5 = device_ms(lambda: F.scaled_dot_product_attention(qt, ct, cvt, attn_mask=cmask), iters)
        lh = lens.cpu().numpy().astype(np.int64)
        pairs = _pairs(T2, lh)
        rows_b = B * T2 * H * d * 2
        b6, by6 = bound(2 * rows_b + 2 * int(lh.sum()) * H * d * 2 + 2 * P * H * d * 2 + B * 4,
                        4.0 * H * d * (B * T2 * P + pairs))
        b5, by5 = bound(2 * rows_b + 2 * int(lh.sum()) * H * d * 2 + B * H * T2 * 4 + B * 4,
                        4.0 * H * d * pairs)
        say(f"flash_attention_prefixed {label} {tag}: kernel {t6:.4f} ms plain {pt6:.4f} ms "
            f"two flash_attention_lse launches + merge {two:.4f} ms sdpa (concatenated kv, "
            f"explicit mask) {l6:.4f} ms bound {b6:.4f} ms ({by6})")
        say(f"flash_attention_lse {label} causal piece B={B} T=S={T2}: kernel {t5:.4f} ms plain "
            f"{pt5:.4f} ms sdpa fwd (masked, no lse: approximate) {l5:.4f} ms bound {b5:.4f} ms "
            f"({by5})")
        if label == "stage 1":
            unit = f"one launch = one layer of the chunk-64 stage-1 prefill, P={P}, T2={T2}"
            records["flash_attention_prefixed"] = {
                "name": "flash_attention_prefixed", "max_abs_err": e6, "ms": t6, "plain_ms": pt6,
                "bound_ms": b6, "bound_by": by6, "library_ms": l6,
                "unit": unit + " (library: SDPA over the concatenated kv, explicit mask)"}
            records["flash_attention_lse"] = {
                "name": "flash_attention_lse", "max_abs_err": e5, "ms": t5, "plain_ms": pt5,
                "bound_ms": b5, "bound_by": by5, "library_ms": l5,
                "unit": f"one launch on the causal piece of that layer, T=S={T2} (library: "
                        f"SDPA forward, which returns no lse: approximate)"}
        else:
            for name in records:
                records[name]["max_abs_err"] = max(records[name]["max_abs_err"],
                                                   e6 if name == "flash_attention_prefixed" else e5)
        del q, k, v, pk, pv, pkb, pvb, qt, kt, vt, mask
        torch.cuda.empty_cache()
    return [records["flash_attention_lse"], records["flash_attention_prefixed"]]


PIPE_QUERIES = 3
S1_FLAGS = ["--batch", "64", "--max_new_tokens", "12", "--clip_adapter", "True",
            "--clip_adapter_text", "True"]
S2_FLAGS = ["--batch", "100", "--stride", "5", "--zooms", "4,2,1", "--max_new_tokens", "8",
            "--distributed_retrieval", "1"]


def pipeline_files(tmp, movie, seed=0):
    """The pipeline's inputs under tmp: a feature store with the 1-hour movie
    (movie0.npy), a data JSON of PIPE_QUERIES queries on it and a query
    feature store (25 token features and a CLS feature per query, from
    `seed`). Returns the stage CLIs' common flags."""
    feats, qdir = os.path.join(tmp, "feats"), os.path.join(tmp, "queries")
    os.makedirs(feats)
    os.makedirs(qdir)
    np.save(os.path.join(feats, "movie0.npy"), movie)
    rng = np.random.default_rng(seed)
    data = {}
    for i in range(PIPE_QUERIES):
        qid = f"q{i}"
        data[qid] = {"movie": "movie0", "movie_duration": 3600.0,
                     "timestamps": [1000.0 + 400 * i, 1100.0 + 400 * i],
                     "query": f"{SENTENCE} {i}"}
        np.savez(os.path.join(qdir, f"{qid}.npz"),
                 token_features=rng.normal(size=(25, 768)).astype(np.float32),
                 cls_features=rng.normal(size=(768,)).astype(np.float32))
    path = os.path.join(tmp, "val.json")
    with open(path, "w") as f:
        json.dump(data, f)
    return ["--data_path", path, "--feat_folder", feats, "--q_feat_dir", qdir, "--debug", "True"]


def pipeline_engines(dev, params, vision1, common):
    """Stage-1 and stage-2 engines on ONE int8 base tree, as bench.py's
    bench_e2e builds them, with the configurations the CLIs' flags give
    (eval/loader.py): the temporal T2V adapter (the slice's weights) and a
    hierarchy cls T2V adapter from seed 2."""
    import torch
    from revisionllm_tpu_torch.config import LlamaConfig
    from revisionllm_tpu_torch.eval import loader, stage1, stage2
    from revisionllm_tpu_torch.eval.engine import GroundingEngine
    from revisionllm_tpu_torch.models import revisionllm

    cfg = LlamaConfig()
    engines = []
    for stage, flags, vision in ((stage1, S1_FLAGS, vision1), (stage2, S2_FLAGS, None)):
        args = stage.parse_args(common + ["--log_path", "unused"] + flags)
        acfg = loader.adapter_cfg_from_args(args).with_hidden(cfg.hidden_size)
        if vision is None:
            vision = revisionllm.init_vision_params(acfg, seed=2, d_in=acfg.d_model,
                                                    dtype=torch.bfloat16, device=dev)
        engines.append(GroundingEngine(cfg, acfg, params, vision, fake_tokenizer(),
                                       loader.eval_cfg_from_args(args), device=dev))
    return engines


def run_pipeline(eng1, eng2, common, out):
    """stage1.run -> stage2.run --grounding_path -> fusion.main, each timed
    from an idle device, with each stage's kernel launches. Returns the
    numbers and the two logs."""
    import contextlib
    import io

    import torch
    from revisionllm_tpu_torch.eval import fusion, stage1, stage2
    from revisionllm_tpu_torch.eval import metrics as M

    s1, s2 = os.path.join(out, "s1"), os.path.join(out, "s2")
    a1 = stage1.parse_args(common + ["--log_path", s1] + S1_FLAGS)
    a2 = stage2.parse_args(common + ["--log_path", s2, "--grounding_path", s1] + S2_FLAGS)
    res = {"launches": {}}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stages_s = 0.0
    for name, stage, args, eng in (("stage1", stage1, a1, eng1), ("stage2", stage2, a2, eng2)):
        with DeviceLaunches() as seen:
            t0 = time.perf_counter()
            stats = stage.run(args, eng)
            torch.cuda.synchronize()
            stages_s += time.perf_counter() - t0
        res["launches"][name] = seen.launches
        res[name] = stats
        if stats["done"] != PIPE_QUERIES or stats["errors"]:
            raise AssertionError(f"{name}.run: {stats}")
    t2 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        metrics = fusion.main(["--grounding_path", s1, "--retrieval_path", s2,
                               "--distributed_grounding", "1", "--distributed_retrieval", "1"])
    res["fusion_s"] = time.perf_counter() - t2
    res["wall"] = stages_s + res["fusion_s"]
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    res["metrics"] = metrics
    res["logs"] = (M.load_prediction_logs(s1, 1), M.load_prediction_logs(s2, 1))
    return res


def check_pipeline_logs(logs1, logs2, metrics):
    """The repo's own checks of the logs: one stage-1 record per query with
    57 window answers, one stage-2 record per query whose passes carry
    finite positive inverse entropies and one window hit, and fused
    metrics with an mIoU."""
    if len(logs1) != PIPE_QUERIES or any(len(r["answer"]) != 57 for r in logs1):
        raise AssertionError("stage-1 log: expected 57 window answers per query")
    for r in logs2:
        n = len(r["answer"])
        ent = np.asarray(r["info"]["mean_entropy"] + r["info"]["max_entropy"], np.float64)
        if not n or len(ent) != 2 * n or not np.isfinite(ent).all() or (ent <= 0).any() \
                or r["info"]["iou"] not in ([0], [1]):
            raise AssertionError(f"stage-2 record malformed: {r['query_id']}")
    if len(logs2) != PIPE_QUERIES or "mIoU" not in metrics:
        raise AssertionError("stage-2 log or fused metrics missing")


def timed_ms(fn):
    """(fn(), ms) from an idle device to the end of fn's device work."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def shared_vs_unshared(eng, plan_np, rows, feats_dev, qf, qv):
    """One call of the engine's (rows of identical plans): the adapter and
    splice, then the prefill and the whole generate with and without the
    shared prefix, each run twice and timed the second time from an idle
    device. Under the serving numerics the prefix's rows take K1 (bf16
    activations) in the shared prefill and W8A8 (int8 activations) in the
    full one; with W8A8 off on both sides (the dequant route above 256
    rows) the two prefills do the same matmul maths. Returns (first-step
    logits {name: [B, V]}, greedy token agreement under the serving
    numerics, P, times in ms, the adapter's peak memory in GiB above what
    was allocated before it)."""
    import torch
    from revisionllm_tpu_torch.models import generation, llama, revisionllm
    from revisionllm_tpu_torch.models.multimodal import KIND_VIDEO
    from revisionllm_tpu_torch.ops import quant
    from revisionllm_tpu_torch.ops import windows as W

    cfg = eng.llama_cfg
    P = int(np.argmax(plan_np["kind"][0] == KIND_VIDEO))
    plan = {k: torch.as_tensor(v, device=eng.device) for k, v in plan_np.items()}

    def twice(fn):
        timed_ms(fn)
        return timed_ms(fn)

    def encode():
        images = W.gather_windows(feats_dev, rows).to(torch.bfloat16)
        video = revisionllm.encode_video(eng.adapter_cfg, eng.vision_params, images, qf, qv)
        return revisionllm.assemble_inputs(eng.params, plan, video, dtype=torch.bfloat16)

    timed_ms(encode)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    (embeds, pos, lens), t_enc = timed_ms(encode)
    times = {"adapter": t_enc}
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    full_fn = partial(llama.prefill_kv, cfg, eng.params, embeds, pos, kv_lens=lens, kv_quant=True)
    shared_fn = partial(llama.prefill_shared_prefix, cfg, eng.params, embeds, pos, P,
                        kv_lens=lens, kv_quant=True)
    logits = {}
    (logits["full"], _), times["prefill"] = twice(full_fn)
    (logits["shared"], _), times["prefill shared"] = twice(shared_fn)
    kw = dict(eos_id=eng.eos_id, max_new_tokens=eng.eval_cfg.max_new_tokens)
    full, times["generate"] = twice(lambda: generation.generate(
        cfg, eng.params, embeds, pos, lens, **kw))
    sp, times["generate shared"] = twice(lambda: generation.generate(
        cfg, eng.params, embeds, pos, lens, shared_prefix_len=P, **kw))
    quant.set_w8a8(False)
    try:
        logits["full, W8A8 off"] = full_fn()[0]
        logits["shared, W8A8 off"] = shared_fn()[0]
    finally:
        quant.set_w8a8(None)
    agree = (full["tokens"] == sp["tokens"]).float().mean().item()
    return logits, agree, P, times, peak


def phase_pipeline(dev, setup, tmp):
    """The fused recursive pipeline at Vicuna-7B width and depth on one
    1-hour movie through its entry points (stage1.run, stage2.run
    --grounding_path, fusion.main), with REVISIONLLM_SHARED_PREFIX unset and
    then 1. Fails if K1-K3 are never launched, or row 6 is not launched in
    either stage with the switch on. Then, on one call of each stage, the
    shared-prefix prefill against the full one. Returns the launches of the
    run with the switch on."""
    import torch
    from revisionllm_tpu_torch.models.multimodal import build_splice_plan, stack_plans
    from revisionllm_tpu_torch.constants import QUESTIONS

    slice_engine, movie, _, _ = setup
    common = pipeline_files(tmp, movie)
    eng1, eng2 = pipeline_engines(dev, slice_engine.params, slice_engine.vision_params, common)
    runs = {}
    old = os.environ.pop("REVISIONLLM_SHARED_PREFIX", None)
    try:
        for switch in ("unset", "1"):
            if switch == "1":
                os.environ["REVISIONLLM_SHARED_PREFIX"] = "1"
            r = runs[switch] = run_pipeline(eng1, eng2, common, os.path.join(tmp, f"pipe_{switch}"))
            check_pipeline_logs(*r["logs"], r["metrics"])
            n_pass = len(r["logs"][1][0]["answer"])
            s1, s2 = r["stage1"], r["stage2"]
            say(f"pipeline (REVISIONLLM_SHARED_PREFIX {switch}): {PIPE_QUERIES} queries on the "
                f"1-hour movie, per query (p50): stage 1 {s1['p50_latency_s'] * 1e3:.1f} ms, "
                f"stage 2 {s2['p50_latency_s'] * 1e3:.1f} ms; whole run {r['wall']:.3f} s = "
                f"{r['wall'] / PIPE_QUERIES * 1e3:.1f} ms per query, {PIPE_QUERIES / r['wall']:.4f} "
                f"q/s (fusion.main {r['fusion_s'] * 1e3:.1f} ms); stage-2 passes {n_pass} in a "
                f"{eng2._stage2_row_bucket(n_pass)}-row bucket; peak memory {r['peak_gib']:.2f} GiB; "
                f"fused mIoU {r['metrics']['mIoU']:.2f}")
            for stage, launches in r["launches"].items():
                say(f"pipeline ({switch}): launches in {stage}.run: "
                    + str({k: n for k, n in launches.items() if n}))
                missing = [k for k in SERVING if launches[k] == 0]
                if switch == "1" and launches["flash_attention_prefixed"] == 0:
                    missing.append("flash_attention_prefixed")
                if missing:
                    raise AssertionError(f"{stage}: kernels never launched: {missing}")

        # answers of the two runs, and one call of each stage done both ways
        same = [sum(a == b for a, b in zip(ra["answer"], rb["answer"])) / len(ra["answer"])
                for i in (0, 1) for ra, rb in zip(runs["unset"]["logs"][i], runs["1"]["logs"][i])]
        say(f"pipeline: answers equal with and without the shared prefix, per stage-1 then "
            f"stage-2 record: {[round(x, 4) for x in same]}")
        feats = eng1._features_to_device(movie, movie_key="shared_vs_unshared")
        qf_np = np.load(os.path.join(tmp, "queries", "q0.npz"))["token_features"]
        checks = []
        ids = eng1._prompt_ids(f"{SENTENCE} 0", QUESTIONS["mad_grounding"])
        plan_idx = eng1._stage1_plan_idx(len(movie))
        rows = np.concatenate([plan_idx, np.repeat(plan_idx[-1:], 64 - len(plan_idx), 0)])
        plan = stack_plans([build_splice_plan(ids, 250, len(ids) - 1 + 250 + 12)] * 64)
        checks.append(("stage 1", eng1, plan, rows, *eng1._broadcast_query_feats(qf_np, 64)))
        ids = eng2._prompt_ids(f"{SENTENCE} 0", QUESTIONS["retrieval"])
        row_idx = eng2._stage2_passes(eng2._stage2_win_idx(len(movie)), np.random.default_rng(0))[4]
        R = eng2._stage2_row_bucket(len(row_idx))
        rows = np.stack(row_idx + [row_idx[-1]] * (R - len(row_idx)))
        plan = stack_plans([build_splice_plan(ids, 100, len(ids) - 1 + 100 + 8)] * R)
        checks.append(("stage 2", eng2, plan, rows, *eng2._broadcast_query_feats(qf_np, R)))
        for label, eng, plan, rows, qf, qv in checks:
            logits, agree, P, times, peak = shared_vs_unshared(eng, plan, rows, feats, qf, qv)

            def gap(a, b):
                return (logits[a] - logits[b]).abs().max().item()

            exact = "full, W8A8 off"
            scale = logits[exact].abs().max().item()
            tol = 5e-2 * max(1.0, scale)
            held = gap("shared, W8A8 off", exact)
            say(f"pipeline: {label} call (B={len(rows)}, P={P}, T={plan['kind'].shape[1]}), "
                f"shared-prefix vs full prefill, first-step logits max_abs_diff (max |logit| "
                f"{scale:.3f}): same matmul numerics (W8A8 off both) {held:.4e} (tol {tol:.3e}); "
                f"serving numerics {gap('shared', 'full'):.4e}, of which the full W8A8 prefill "
                f"is {gap('full', exact):.4e} and the shared one {gap('shared', exact):.4e} from "
                f"the W8A8-off full prefill; greedy tokens agree {agree * 100:.1f}% (serving)")
            say(f"pipeline: {label} call, ms (second of two runs, from an idle device): "
                + ", ".join(f"{k} {v:.2f}" for k, v in times.items())
                + f"; so decode {times['generate'] - times['prefill']:.2f} (full) / "
                f"{times['generate shared'] - times['prefill shared']:.2f} (shared); the adapter's "
                f"peak memory above its inputs {peak:.3f} GiB")
            if not held <= tol:
                raise AssertionError(f"{label}: shared-prefix logits differ by {held} > {tol}")
    finally:
        os.environ.pop("REVISIONLLM_SHARED_PREFIX", None)
        if old is not None:
            os.environ["REVISIONLLM_SHARED_PREFIX"] = old
    del eng1, eng2, feats
    torch.cuda.empty_cache()
    on = runs["1"]["launches"]
    return {k: on["stage1"][k] + on["stage2"][k] for k in on["stage1"]}


# ------------------------------------------------------------------ phase 11


def phase_pipeline_compare(dev):
    """Stage-2 retrieval with the kernels on the card against the plain path
    on the CPU, at full width, 2 layers and one seed, on a 10-minute movie
    (23 windows, 3 passes, in a 3-row bucket). The card runs `retrieve`;
    the same call's rows (the same rng) then run on both devices through
    encode_video, prefill_shared_prefix and generate, so the CPU's adapter
    runs 300 windows once. Checks the first-step logits; reports the answers
    and greedy tokens that agree and the inverse entropies; and holds the
    card's retrieve to its own rows' decode."""
    import torch
    from revisionllm_tpu_torch.config import LlamaConfig
    from revisionllm_tpu_torch.constants import QUESTIONS
    from revisionllm_tpu_torch.eval import loader, stage2
    from revisionllm_tpu_torch.eval.engine import GroundingEngine
    from revisionllm_tpu_torch.models import generation, llama, revisionllm
    from revisionllm_tpu_torch.models.multimodal import build_splice_plan, stack_plans
    from revisionllm_tpu_torch.ops import flash_attention, quant
    from revisionllm_tpu_torch.ops import windows as W
    from revisionllm_tpu_torch.utils import kernels

    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    cfg = LlamaConfig(num_layers=2)
    args = stage2.parse_args(["--data_path", "-", "--feat_folder", "-", "--log_path", "-"]
                             + S2_FLAGS)
    acfg = loader.adapter_cfg_from_args(args).with_hidden(cfg.hidden_size)
    ecfg = loader.eval_cfg_from_args(args)
    params = llama.init_params(cfg, seed=0, dtype=torch.bfloat16, device=cpu, quantize=True)
    vision = revisionllm.init_vision_params(acfg, seed=2, d_in=acfg.d_model,
                                            dtype=torch.bfloat16, device=cpu)
    rng = np.random.default_rng(5)
    movie = rng.normal(size=(3000, 768)).astype(np.float32)
    qf = rng.normal(size=(25, 768)).astype(np.float32)
    qc = rng.normal(size=(768,)).astype(np.float32)
    qc /= np.linalg.norm(qc)
    env = {"REVISIONLLM_SHARED_PREFIX": "1", "REVISIONLLM_S2_ROW_BUCKETS": "3"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    quant.set_w8a8(True)
    generation.set_kv8(True)
    flash_attention.set_attn_bf16(False)
    out = {}
    try:
        for device in (dev, cpu):
            eng = GroundingEngine(cfg, acfg, _to(params, device), _to(vision, device),
                                  fake_tokenizer(), ecfg, device=device)
            if device == dev:
                kernels.reset_launches()
                res = eng.retrieve(movie, SENTENCE, qf, qc, rng=np.random.default_rng(0))
                launches = dict(kernels.LAUNCHES)
            row_idx = eng._stage2_passes(eng._stage2_win_idx(len(movie)),
                                         np.random.default_rng(0))[4]
            ids = eng._prompt_ids(SENTENCE, QUESTIONS["retrieval"])
            plan_np = stack_plans([build_splice_plan(ids, 100, len(ids) - 1 + 100 + 8)]
                                  * len(row_idx))
            plan = {k: torch.as_tensor(v, device=device) for k, v in plan_np.items()}
            images = W.gather_windows(eng._features_to_device(movie),
                                      np.stack(row_idx)).to(torch.bfloat16)
            video = revisionllm.encode_video(acfg, eng.vision_params, images,
                                             *eng._broadcast_query_feats(qf, len(row_idx)))
            embeds, pos, lens = revisionllm.assemble_inputs(eng.params, plan, video,
                                                            dtype=torch.bfloat16)
            P = GroundingEngine._shared_prefix_len(plan_np)
            logits, _ = llama.prefill_shared_prefix(cfg, eng.params, embeds, pos, P,
                                                    kv_lens=lens, kv_quant=True)
            gen = generation.generate(cfg, eng.params, embeds, pos, lens, eos_id=eng.eos_id,
                                      max_new_tokens=ecfg.max_new_tokens, shared_prefix_len=P)
            stats = generation.entropy_stats_from_steps(gen["entropy"], gen["valid"])
            out[device.type] = {
                "logits": logits.float().cpu(), "tokens": gen["tokens"].cpu(),
                "answers": eng._decode_answers(gen["tokens"].cpu().numpy(),
                                               gen["valid"].cpu().numpy()),
                "inv_mean_entropy": 1.0 / stats[:, 2].cpu().clamp(min=1e-9)}
            del eng
    finally:
        quant.set_w8a8(None)
        generation.set_kv8(None)
        flash_attention.set_attn_bf16(None)
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    card, host = out[dev.type], out["cpu"]
    diff = (card["logits"] - host["logits"]).abs().max().item()
    scale = host["logits"].abs().max().item()
    tol = 5e-2 * max(1.0, scale)
    agree = np.mean([a == b for a, b in zip(card["answers"], host["answers"])])
    tokens = (card["tokens"] == host["tokens"]).float().mean().item()
    ent = ((card["inv_mean_entropy"] - host["inv_mean_entropy"]).abs()
           / host["inv_mean_entropy"]).max().item()
    say(f"pipeline compare: stage-2 retrieve, Vicuna-7B width, 2 layers, 10-minute movie "
        f"({res['num_windows']} windows, {len(res['answers'])} passes, P={P}), kernels on the card "
        f"vs plain on the CPU: shared-prefix prefill first-step logits max_abs_diff {diff:.4e} "
        f"(tol {tol:.3e}, max |logit| {scale:.3f}); greedy tokens agree {tokens * 100:.1f}%, "
        f"answers {agree * 100:.1f}%; inverse mean entropies max relative diff {ent:.3e}; card "
        f"launches in retrieve {({k: n for k, n in launches.items() if n})} "
        f"({time.perf_counter() - t0:.1f} s)")
    if res["answers"] != card["answers"] or not np.allclose(
            res["mean_entropy"], card["inv_mean_entropy"].numpy(), rtol=1e-5):
        raise AssertionError("the card's retrieve differs from its own rows' decode")
    if launches["flash_attention_prefixed"] == 0:
        raise AssertionError("the card's retrieve did not launch flash_attention_prefixed")
    if not diff <= tol:
        raise AssertionError(f"stage-2 logits differ by {diff} > {tol}")


# ------------------------------------------------------------------ phase 12


def hold_cols(label, got, want, faults=None, cols=128):
    """`hold` for a [M, N] output, by blocks of 64 rows x `cols` columns."""
    import torch.nn.functional as F

    def view(t):
        t = t.float()
        return F.pad(t, (0, -t.shape[1] % cols)).reshape(1, t.shape[0], -1, cols)

    return hold(label, view(got), view(want), {k: view(v) for k, v in (faults or {}).items()})


# row 7's edge cases (M, K, N), correctness only: M 1 (15 padding rows of
# 16), 16 and 17 on both sides of the 16-row tile, 65, 200 and 256 over
# several 64-row m tiles (one launch), 300 (two launches); K 4224 (33 groups,
# ranks of unequal length); N 4112 (a 16-column last block) and 32000
Q4_EDGES = ((1, 4096, 4096), (1, 4224, 32000), (16, 4224, 4112), (17, 4096, 32000),
            (64, 4224, 4112), (65, 4224, 4112), (200, 4096, 4096), (256, 4096, 11008),
            (300, 4224, 4112))


def dropped_last_rank(x, q, s, plan, tile, plain):
    """`plain` (row 7's or K1's plain version) with the last K rank of
    `plan` (its tiles of `tile` rows) left out of the sum: the result of a
    cluster sum that drops one partial (a planted fault). x has at most 256
    rows (one launch)."""
    from revisionllm_tpu_torch.ops import quant as Q

    t0, nk = Q.rank_tiles(plan.k_tiles, plan.splitk)[-1]
    xd = x.clone()
    xd[:, t0 * tile:(t0 + nk) * tile] = 0
    return plain(xd, q, s)


def call_kernels(label, fn, kernels, allocs=1):
    """One call of `fn` under torch.profiler must run exactly `kernels` (one
    launch each, in that order, each found by a part of its name) and make
    `allocs` allocations."""
    import torch

    for _ in range(3):  # a trace that recorded no kernel at all is taken again
        torch.cuda.synchronize()
        before = torch.cuda.memory_stats()["allocation.all.allocated"]
        _, _, events = profiled(fn)
        got = torch.cuda.memory_stats()["allocation.all.allocated"] - before
        names = [e.name for e in events]
        if names:
            break
    if len(names) != len(kernels) or not all(k in n for k, n in zip(kernels, names)) \
            or got != allocs:
        raise AssertionError(f"{label}: expected the launches {list(kernels)} and {allocs} "
                             f"allocations, got kernels {names}, {got} allocations")


def one_kernel(label, fn, launches, kernel):
    """One call of `fn` must run `launches` kernels, each `kernel` (no
    finalize kernel), and allocate only the output (no f32 workspace)."""
    call_kernels(label, fn, [kernel] * launches)


def check_int4_matmul(dev, iters):
    """Row 7 at the decode step's shapes (M 64; q/k/v/o, gate/up, down, the
    lm_head) against its plain version by relative L2 error, whole and per
    (64-row, 128-column) block, with two planted faults that must fail (the
    two nibbles of each byte swapped; the last K rank's partial dropped
    from the cluster sum); two calls on the same inputs must be
    bit-identical, and one call must be one q4_matmul_kernel launch that
    allocates only its output. Then the edge cases Q4_EDGES, correctness
    only. The C library's shared memory must be the plan's, and clusters of
    each size must fit (cudaOccupancyMaxActiveClusters). Times one
    decode step's 225 launches: kernel, plain, and torch.matmul on the
    dequantized bf16 weight."""
    import torch
    from revisionllm_tpu_torch.ops import quant as Q
    from revisionllm_tpu_torch.utils import kernels

    smem = kernels.function("int4_matmul", "q4_matmul_smem_bytes", [])()
    if smem != Q.q4_smem_bytes():
        raise AssertionError(f"int4_matmul: the library's shared memory is {smem} B, the "
                             f"plan's {Q.q4_smem_bytes()} B")
    resident = Q.q4_resident(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    say(f"int4_matmul: {smem} B of shared memory a block; resident clusters of "
        f"{Q.WONLY_SPLITS} blocks: {resident} on {sms} SMs")
    M = 64
    gen = torch.Generator(device=dev).manual_seed(13)
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0.0, "ops": 0.0}
    worst = 0.0
    details = []
    for K, N, per_step in DECODE_SHAPES:
        x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
        copies = max(1, math.ceil(128e6 / (K * N // 2)))
        ws = []
        for _ in range(copies):
            q, s = Q.quantize_int4(torch.randn((K, N), generator=gen, device=dev) * K ** -0.5)
            ws.append((q, s, Q.dequantize_int4(q, s, torch.bfloat16)))
        q, s = ws[0][:2]
        plan = Q.q4_plan(M, K, N, sms, resident)
        got = Q.int4_matmul(x, q, s)
        again = Q.int4_matmul(x, q, s)
        want = Q.int4_matmul_plain(x, q, s)
        swapped = Q.int4_matmul_plain(x, ((q & 0xF) << 4) | (q >> 4), s)
        dropped = dropped_last_rank(x, q, s, plan, Q.Q4_BK, Q.int4_matmul_plain)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"int4_matmul K={K} N={N}: two calls differ")
        err = hold_cols(f"int4_matmul M={M} K={K} N={N} (S {plan.splitk}, "
                        f"{plan.n_tiles} clusters)", got, want,
                        {"nibbles swapped": swapped, "last K rank dropped": dropped})
        one_kernel(f"int4_matmul K={K} N={N}", lambda: Q.int4_matmul(x, q, s), 1,
                   "q4_matmul_kernel")
        worst = max(worst, err)
        pick = cycled(ws)
        ms = device_ms(lambda: Q.int4_matmul(x, *pick()[:2]), iters)
        plain = device_ms(lambda: Q.int4_matmul_plain(x, *pick()[:2]), max(3, iters // 4))
        lib = device_ms(lambda: torch.matmul(x, pick()[2]), iters)
        nbytes = M * K * 2 + K * N // 2 + (K // 128) * N * 4 + M * N * 2
        ops = 2.0 * M * K * N
        b, by = bound(nbytes, ops)
        say(f"int4_matmul M={M} K={K} N={N}: kernel {ms:.4f} ms plain {plain:.4f} ms "
            f"torch.matmul(bf16 W) {lib:.4f} ms bound {b:.4f} ms ({by}) "
            f"[{per_step} launches per decode step]")
        details.append({"K": K, "N": N, "splitk": plan.splitk, "ms": ms, "plain_ms": plain,
                        "library_ms": lib, "bound_ms": b, "per_decode_step": per_step})
        for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib)):
            tot[key] += per_step * val
        tot["bytes"] += per_step * nbytes
        tot["ops"] += per_step * ops
        del ws, pick
    for M2, K2, N2 in Q4_EDGES:
        x = torch.randn((M2, K2), generator=gen, device=dev).to(torch.bfloat16)
        q, s = Q.quantize_int4(torch.randn((K2, N2), generator=gen, device=dev) * K2 ** -0.5)
        worst = max(worst, hold_cols(f"int4_matmul M={M2} K={K2} N={N2}", Q.int4_matmul(x, q, s),
                                     Q.int4_matmul_plain(x, q, s)))
    one_kernel(f"int4_matmul M={M2}", lambda: Q.int4_matmul(x, q, s),
               -(-M2 // Q.KERNEL_MAX_M), "q4_matmul_kernel")
    b, by = bound(tot["bytes"], tot["ops"])
    say(f"int4_matmul one decode step: kernel {tot['ms']:.4f} ms, torch.matmul(bf16 W) "
        f"{tot['library_ms']:.4f} ms, bound {b:.4f} ms ({by})")
    return {
        "name": "int4_matmul", "max_abs_err": worst, "ms": tot["ms"],
        "plain_ms": tot["plain_ms"], "bound_ms": b, "bound_by": by,
        "library_ms": tot["library_ms"],
        "unit": "one decode step at B=64 (225 launches: 32 layers x 7 + lm_head); library: "
                "torch.matmul on the dequantized bf16 weight",
        "shapes": details,
    }


def _quantize_per_row(h):
    absmax = h.abs().amax(dim=-1, keepdim=True)
    hs = absmax.clamp_min(1e-30) / 127.0
    return h.div(hs).round_().clamp_(-127, 127).mul_(hs)


# row 8's edge cases (M, K, N), held by the limits of the prefill shape: M 1
# (127 zero rows in its tile), 64 (a split decode step's rows) and 130 (a
# second row tile of 2 rows); K 80 (one stage, zeros past K) and 4112 (a
# 16-byte last stage); N 160 (a 32-column last tile) and 11024 (16 columns)
MLP_EDGES = ((1, 4096, 11008), (64, 4096, 11008), (130, 4112, 11024), (1, 80, 160),
             (130, 80, 160), (64, 4112, 160))


def mlp_inputs(gen, M, K, N, dev):
    """Row 8's operands: bf16 activations quantized per row, gate and up
    quantized per column."""
    import torch
    from revisionllm_tpu_torch.ops import quant as Q

    x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
    xq, xs = Q.quantize_activation_rows(x)
    gq, gs = Q.quantize_int8(torch.randn((K, N), generator=gen, device=dev) * K ** -0.5)
    uq, us = Q.quantize_int8(torch.randn((K, N), generator=gen, device=dev) * K ** -0.5)
    return xq, xs, gq, gs, uq, us


def hold_mlp(label, got, want, faults=None):
    """Row 8's (hq, hs) against its plain version's: hs to 1e-6 relative, hq
    within +-1 and at least 99.9% equal (tests/test_quant.py:392-410's
    measure), and the dequantized output by `hold_cols` (each planted fault
    must fail it). Returns the max abs error of the dequantized output."""
    (hq, hs), (pq, ps) = got, want
    hs_rel = ((hs - ps).abs() / ps).max().item()
    dq = (hq.int() - pq.int()).abs()
    worst, equal = dq.max().item(), (dq == 0).float().mean().item()
    say(f"{label}: hs max relative diff {hs_rel:.2e} (tol 1e-6); hq max |diff| {worst} "
        f"(tol 1), equal {equal * 100:.4f}% (tol 99.9%)")
    if not (hs_rel <= 1e-6 and worst <= 1 and equal >= 0.999):
        raise AssertionError(f"{label} differs from its plain version")
    del dq
    return hold_cols(f"{label} dequantized output", hq.float() * hs, pq.float() * ps, faults)


def kernel_ms(fn, iters, names):
    """{name: mean device ms a call} of the kernels whose names hold each
    of `names`, over `iters` calls of fn under torch.profiler."""
    _, _, events = profiled(lambda: [fn() for _ in range(iters)])
    return {k: sum(e.device_time_total for e in events if k in e.name) / 1e3 / iters
            for k in names}


def mlp_yardsticks(args, iters):
    """Row 8's two yardsticks, ms a call on args (x_q8, x_scale, g_q8,
    g_scale, u_q8, u_scale): two torch._int_mm on column-major weights with
    the epilogue in PyTorch, and the two torch._int_mm alone."""
    import torch

    xq, xs, gq, gs, uq, us = args
    g_cm, u_cm = gq.t().contiguous().t(), uq.t().contiguous().t()

    def library():
        g = torch._int_mm(xq, g_cm).float() * xs * gs
        u = torch._int_mm(xq, u_cm).float() * xs * us
        h = (g / (1.0 + torch.exp(-g))) * u
        absmax = h.abs().amax(dim=-1, keepdim=True)
        hs = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
        return torch.clamp(torch.round(h / hs), -127, 127).to(torch.int8), hs

    return (device_ms(library, iters),
            device_ms(lambda: (torch._int_mm(xq, g_cm), torch._int_mm(xq, u_cm)), iters))


def check_fused_mlp(dev, iters):
    """Row 8 at the stage-1 prefill's shape (M = 64 rows x the prompt's T,
    K 4096, N 11008) against its plain version by `hold_mlp`, with two
    planted faults that must fail: the absmax taken over the first 64
    columns only (a GEMM epilogue that quantizes its own tile) and silu left
    out. Two calls must be bit-identical, and one call must be its three
    launches (transpose, GEMM, requantization) and allocate its outputs and
    the three scratch tensors the wrapper names. Then the edge cases
    MLP_EDGES by the same limits. Times the call and each of its kernels,
    the plain version and the two yardsticks (`mlp_yardsticks`), and the
    call and its kernels at M 64 (a split decode step's MLP)."""
    import torch
    from revisionllm_tpu_torch.ops import quant as Q

    T = prompt_geometry("mad_grounding", 250, 12)[1]
    M, K, N = 64 * T, 4096, 11008
    gen = torch.Generator(device=dev).manual_seed(15)
    args = mlp_inputs(gen, M, K, N, dev)
    xq, xs, gq, gs, uq, us = args
    got = Q.w8a8_mlp_fused(*args)
    again = Q.w8a8_mlp_fused(*args)
    want = Q.w8a8_mlp_fused_plain(*args)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])):
        raise AssertionError("w8a8_mlp_fused: two calls differ")
    del again
    g_cm, u_cm = gq.t().contiguous().t(), uq.t().contiguous().t()
    g = torch._int_mm(xq, g_cm).float() * xs * gs
    u = torch._int_mm(xq, u_cm).float() * xs * us
    del g_cm, u_cm
    h = (g / (1.0 + torch.exp(-g))) * u
    hs_tile = h[:, :64].abs().amax(dim=-1, keepdim=True).clamp_min(1e-30) / 127.0
    faults = {"absmax over the first 64 columns": h.div(hs_tile).round_().clamp_(-127, 127)
              .mul_(hs_tile),
              "silu left out": _quantize_per_row(g * u)}
    del g, u, h
    err = hold_mlp(f"w8a8_mlp_fused M={M} K={K} N={N}", got, want, faults)
    del faults, got, want
    call_kernels("w8a8_mlp_fused", lambda: Q.w8a8_mlp_fused(*args), ROW8_KERNELS, allocs=5)
    for M2, K2, N2 in MLP_EDGES:
        a2 = mlp_inputs(gen, M2, K2, N2, dev)
        err = max(err, hold_mlp(f"w8a8_mlp_fused M={M2} K={K2} N={N2}",
                                Q.w8a8_mlp_fused(*a2), Q.w8a8_mlp_fused_plain(*a2)))
    del a2

    ms = device_ms(lambda: Q.w8a8_mlp_fused(*args), iters)
    parts = kernel_ms(lambda: Q.w8a8_mlp_fused(*args), iters, ROW8_KERNELS)
    plain = device_ms(lambda: Q.w8a8_mlp_fused_plain(*args), max(3, iters // 4))
    lib, lib_gemm = mlp_yardsticks(args, max(3, iters // 4))
    nbytes = M * K + 2 * K * N + 2 * N * 4 + M * 4 + M * N + M * 4
    scratch = 2 * 2 * K * N + 2 * 4 * M * N + 2 * 4 * M
    b, by = bound(nbytes, 4.0 * M * K * N, INT8_OPS_PER_S)
    b_scratch = (nbytes + scratch) / HBM_BYTES_PER_S * 1e3
    say(f"w8a8_mlp_fused M={M} K={K} N={N}: kernel {ms:.4f} ms (transpose "
        f"{parts['mlp_transpose_kernel']:.4f}, GEMM {parts['mlp_gemm_kernel']:.4f}, "
        f"requantize {parts['mlp_quant_kernel']:.4f} ms under the profiler) plain {plain:.4f} ms "
        f"two torch._int_mm + epilogue {lib:.4f} ms, two torch._int_mm alone {lib_gemm:.4f} ms; "
        f"bound {b:.4f} ms ({by}, 1979 TOPS int8), bytes with the scratch {b_scratch:.4f} ms")
    a64 = mlp_inputs(gen, 64, K, N, dev)
    ms64 = device_ms(lambda: Q.w8a8_mlp_fused(*a64), iters)
    parts64 = kernel_ms(lambda: Q.w8a8_mlp_fused(*a64), iters, ROW8_KERNELS)
    lib64, gemm64 = mlp_yardsticks(a64, iters)
    say(f"w8a8_mlp_fused M=64 K={K} N={N} (a split decode step's MLP): kernel {ms64:.4f} ms "
        f"(transpose {parts64['mlp_transpose_kernel']:.4f}, GEMM {parts64['mlp_gemm_kernel']:.4f}, "
        f"requantize {parts64['mlp_quant_kernel']:.4f} ms under the profiler), two "
        f"torch._int_mm + epilogue {lib64:.4f} ms, alone {gemm64:.4f} ms")
    return {"name": "w8a8_mlp_fused", "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": b, "bound_by": by, "library_ms": lib, "library_gemm_ms": lib_gemm,
            "parts_ms": {"transpose": parts["mlp_transpose_kernel"],
                         "gemm": parts["mlp_gemm_kernel"],
                         "requantize": parts["mlp_quant_kernel"]},
            "unit": f"one call = one layer of the chunk-64 prefill (M={M}); library: two "
                    f"torch._int_mm on column-major weights and the epilogue in PyTorch "
                    f"(library_gemm_ms: the two torch._int_mm alone)"}


# the W8A8 prefill (csrc/w8a8_gemm.cu) at the benchmark cells' shapes: M = 64
# rows x W8A8_T positions (their chunk holds 302-314), each layer's matrices
# (name, K, N); its edge cases (M, K, N), each at both tile widths: M 1 and
# 130 (a second row tile of 2 rows), K 80 (one stage, zeros past K) and 4112
# (a 16-byte last stage), N 160, 272 and 4112 (a 32- or 16-column last box)
W8A8_T = 304
W8A8_LAYERS = {
    "glm2-6b": (("q", 4096, 4096), ("k", 4096, 256), ("v", 4096, 256), ("o", 4096, 4096),
                ("gate", 4096, 13696), ("up", 4096, 13696), ("down", 13696, 4096)),
    "deepseek-7b": (("q", 4096, 4096), ("k", 4096, 4096), ("v", 4096, 4096), ("o", 4096, 4096),
                    ("gate", 4096, 11008), ("up", 4096, 11008), ("down", 11008, 4096)),
}
W8A8_KV_HEADS = {"glm2-6b": 2, "deepseek-7b": 32}
W8A8_EDGES = ((1, 4096, 256), (130, 80, 160), (257, 4112, 4112), (300, 13696, 272),
              (2000, 11008, 4112))
W8A8_KERNELS = ("quantize_rows_kernel", "kmajor_transpose_kernel", "s8gemm_kernel")


def w8a8_rows(gen, M, K, dev):
    """bf16 [M, K] normals with a zero row and a row of absmax 127 whose
    quotients x.5 test the rounding half to even."""
    import torch

    x = torch.randn((M, K), generator=gen, device=dev)
    x[0] = 0.0
    if M > 1:
        x[1] = torch.arange(K, device=dev) % 8 - 3.5
        x[1, 0] = 127.0
    return x.to(torch.bfloat16)


def hold_bits(label, got, want, faults):
    """`got` must equal `want` bit for bit, and differ from each planted
    fault."""
    import torch

    caught = {k: not torch.equal(got, f) for k, f in faults.items()}
    say(f"{label}: bit-equal to the PyTorch route {torch.equal(got, want)}; planted faults "
        f"caught {caught}")
    if not torch.equal(got, want) or not all(caught.values()):
        raise AssertionError(f"{label}: differs from the PyTorch route, or a fault was not caught")


def check_w8a8_gemm(dev, iters):
    """The W8A8 prefill's three kernels against the PyTorch route they
    replace (quantize_activation_rows' maths, torch._int_mm, the f32 scales
    and the cast) at the benchmark cells' shapes, bit for bit, each with a
    planted fault the check must catch: the scale by an IEEE division, the
    CPU's rounding (quantizer; PyTorch's CUDA absmax / 127.0 multiplies by
    the reciprocal), the weight's last 16 K rows dropped (transpose), the two
    scales multiplied first (GEMM epilogue). Two calls bit-identical; a
    quantization one launch and two allocations, a product two launches
    (transpose, GEMM) and two allocations (the K-major scratch, the output);
    the edge cases W8A8_EDGES at both tile widths. Times each kernel beside
    its bound, the plain version and the library yardstick (torch._int_mm
    on a held column-major weight with its PyTorch epilogue, and alone),
    and sums one layer of each cell."""
    import torch
    from revisionllm_tpu_torch.ops import quant as Q

    gen = torch.Generator(device=dev).manual_seed(22)
    M = 64 * W8A8_T
    few = max(3, iters // 4)
    quant_ms, gemm_ms = {}, {}
    for K in sorted({k for layer in W8A8_LAYERS.values() for _, k, _ in layer} | {128}):
        rows = M * (32 if K == 128 else 1)  # DeepSeek's k or v rows of head_dim
        x = w8a8_rows(gen, rows, K, dev)
        q, s = Q.quantize_rows(x)
        q2, s2 = Q.quantize_rows(x)
        pq, ps = Q.quantize_rows_plain(x)
        absmax = x.abs().amax(dim=-1, keepdim=True).float()
        fault = torch.where(absmax > 0, absmax / torch.full_like(absmax, 127.0),
                            torch.ones_like(absmax))
        hold_bits(f"quantize_rows [{rows}, {K}] scales", s, ps, {"IEEE-divided scale": fault})
        if not (torch.equal(q, pq) and torch.equal(q, q2) and torch.equal(s, s2)):
            raise AssertionError(f"quantize_rows [{rows}, {K}]: values differ")
        call_kernels(f"quantize_rows [{rows}, {K}]", lambda: Q.quantize_rows(x),
                     W8A8_KERNELS[:1], allocs=2)
        ms = device_ms(lambda: Q.quantize_rows(x), iters)
        plain = device_ms(lambda: Q.quantize_rows_plain(x), few)
        b, by = bound(3 * rows * K + 4 * rows, 0)
        say(f"quantize_rows [{rows}, {K}]: kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
            f"{b:.4f} ms ({by})")
        quant_ms[K] = (ms, plain, b, rows)
        del x, q, q2, pq, absmax, fault

    for K, N in sorted({(k, n) for layer in W8A8_LAYERS.values() for _, k, n in layer}):
        x = w8a8_rows(gen, M, K, dev)
        xq, xs = Q.quantize_rows(x)
        wq, ws = Q.quantize_int8(torch.randn((K, N), generator=gen, device=dev) * K ** -0.5)
        got = Q.w8a8_gemm(xq, xs, wq, ws)
        again = Q.w8a8_gemm(xq, xs, wq, ws)
        acc = Q._int8_dot(xq, wq)
        cut = wq.clone()
        cut[-16:] = 0
        faults = {"scales multiplied first": (acc.float() * (xs * ws)).to(torch.bfloat16),
                  "last 16 K rows dropped": Q._w8a8_scale(Q._int8_dot(xq, cut), x, xs, ws)}
        nb = Q.w8a8_tile_columns(M, N, torch.cuda.get_device_properties(dev).multi_processor_count)
        hold_bits(f"w8a8_gemm M={M} K={K} N={N} (tile {128 * nb} columns)", got,
                  Q._w8a8_scale(acc, x, xs, ws), faults)
        if not torch.equal(got, again):
            raise AssertionError(f"w8a8_gemm M={M} K={K} N={N}: two calls differ")
        del again, acc, cut, faults, got
        call_kernels(f"w8a8_gemm M={M} K={K} N={N}", lambda: Q.w8a8_gemm(xq, xs, wq, ws),
                     W8A8_KERNELS[1:], allocs=2)
        ms = device_ms(lambda: Q.w8a8_gemm(xq, xs, wq, ws), iters)
        parts = kernel_ms(lambda: Q.w8a8_gemm(xq, xs, wq, ws), iters, W8A8_KERNELS[1:])
        plain = device_ms(lambda: Q.w8a8_gemm_plain(xq, xs, wq, ws), few)
        w_cm = wq.t().contiguous().t()
        lib = device_ms(lambda: torch.mul(torch._int_mm(xq, w_cm), xs).mul_(ws).to(torch.bfloat16),
                        few)
        lib_gemm = device_ms(lambda: torch._int_mm(xq, w_cm), few)
        b, by = bound(M * K + K * N + 2 * M * N + 4 * M + 4 * N, 2.0 * M * K * N, INT8_OPS_PER_S)
        bt = 2 * K * N / HBM_BYTES_PER_S * 1e3
        say(f"w8a8_gemm M={M} K={K} N={N}: kernel {ms:.4f} ms (transpose "
            f"{parts['kmajor_transpose_kernel']:.4f}, bound {bt:.4f} ms (bytes); GEMM "
            f"{parts['s8gemm_kernel']:.4f}, bound {b:.4f} ms ({by}), "
            f"{100 * b / parts['s8gemm_kernel']:.1f}% of it, under the profiler); plain "
            f"{plain:.4f} ms; torch._int_mm + PyTorch epilogue {lib:.4f} ms, torch._int_mm alone "
            f"{lib_gemm:.4f} ms")
        gemm_ms[(K, N)] = (ms, parts["kmajor_transpose_kernel"], parts["s8gemm_kernel"], plain,
                           lib, lib_gemm, b, bt)
        del x, xq, xs, wq, ws, w_cm

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = Q.w8a8_tile_columns
    try:
        for nb in (1, 2):
            Q.w8a8_tile_columns = lambda *a, nb=nb: nb
            for M2, K2, N2 in W8A8_EDGES:
                x = w8a8_rows(gen, M2, K2, dev)
                xq, xs = Q.quantize_rows(x)
                pq, ps = Q.quantize_rows_plain(x)
                wq, ws = Q.quantize_int8(torch.randn((K2, N2), generator=gen, device=dev))
                got = Q.w8a8_gemm(xq, xs, wq, ws)
                want = Q._w8a8_scale(Q._int8_dot(xq, wq), x, xs, ws)
                wide = torch.zeros((M2, N2 + 48), dtype=torch.float32, device=dev)
                Q.w8a8_gemm(xq, xs, wq, ws, out=wide[:, 16:16 + N2])
                ok = (torch.equal(xq, pq) and torch.equal(xs, ps) and torch.equal(got, want)
                      and torch.equal(wide[:, 16:16 + N2], Q._int8_dot(xq, wq).float() * xs * ws)
                      and not wide[:, :16].any() and not wide[:, 16 + N2:].any())
                say(f"w8a8 edge M={M2} K={K2} N={N2}, tile {128 * nb} columns: bit-equal "
                    f"(bf16, and f32 into a column slice) {ok}")
                if not ok:
                    raise AssertionError(f"w8a8 edge M={M2} K={K2} N={N2} at tile {128 * nb}")
    finally:
        Q.w8a8_tile_columns = plan

    cells = {}
    for cell, layer in W8A8_LAYERS.items():
        kv_rows = W8A8_KV_HEADS[cell] * 64 * W8A8_T
        ffn = layer[-1][1]
        q_k = [4096, 4096, 4096, ffn]   # q|k|v, o, gate|up, down
        kern = sum(quant_ms[k][0] for k in q_k) + 2 * quant_ms[128][0] * kv_rows / quant_ms[128][3]
        old = sum(quant_ms[k][1] for k in q_k) + 2 * quant_ms[128][1] * kv_rows / quant_ms[128][3]
        lib = old
        for _, k, n in layer:
            kern += gemm_ms[(k, n)][0]
            old += gemm_ms[(k, n)][3]
            lib += gemm_ms[(k, n)][4]
        gemm = sum(gemm_ms[(k, n)][2] for _, k, n in layer)
        gbound = sum(gemm_ms[(k, n)][6] for _, k, n in layer)
        cells[cell] = {"kernels_ms": kern, "plain_ms": old, "library_ms": lib,
                       "gemm_ms": gemm, "gemm_bound_ms": gbound}
        say(f"w8a8 one {cell} layer at M={M} (4 activation quantizations, 2 of the prompt "
            f"cache's k and v at {kv_rows} rows, 7 products): kernels {kern:.4f} ms; the PyTorch "
            f"route (plain quantization, torch._int_mm with its per-call transpose, the f32 "
            f"scales) {old:.4f} ms; with a held column-major weight {lib:.4f} ms; the 7 GEMMs "
            f"{gemm:.4f} ms against a bound of {gbound:.4f} ms ({100 * gbound / gemm:.1f}%); "
            f"{sms} SMs")
    glm = cells["glm2-6b"]
    return {"name": "w8a8_gemm", "max_abs_err": 0.0, "ms": glm["kernels_ms"],
            "plain_ms": glm["plain_ms"], "library_ms": glm["library_ms"],
            "bound_ms": glm["gemm_bound_ms"], "bound_by": "operations", "cells": cells,
            "unit": f"one ChatGLM2-6B layer of the chunk-64 prefill (M={M}): 6 quantizations, "
                    f"7 transposes and 7 GEMMs; library: torch._int_mm on held column-major "
                    f"weights with the f32 scales and the cast in PyTorch, quantization plain"}


MOE_E, MOE_K, MOE_D, MOE_F = 64, 6, 2048, 1408   # DeepSeek-V2-Lite's routed experts
MOE_PREFILL_TOKENS = 64 * 314                     # the cell's chunk: 64 rows of its longest prompt
MOE_DECODE_TOKENS = 64                            # one decode step of the chunk
MOE_KERNELS = ("moe_w8a8_kernel", "moe_w8a16_kernel")


def moe_routing(gen, T, k, E, dev, case):
    """Router choices idx [T, k] of distinct experts per token: "ragged"
    (experts drawn with skewed odds, experts 5 and 9 never), or "one" (k =
    1, every token to expert 7)."""
    import torch

    if case == "one":
        return torch.full((T, 1), 7, dtype=torch.long, device=dev)
    odds = torch.rand(E, generator=gen, device=dev) ** 3 + 0.02
    odds[[5, 9]] = 0
    return torch.multinomial(odds.expand(T, E), k, replacement=False, generator=gen)


def moe_shifted(d, e):
    """The dispatch `d` with expert e's rows read one row late (a planted
    fault of the offsets)."""
    starts = d.starts.clone()
    starts[e] += 1
    return d._replace(starts=starts)


def moe_used_rows(d):
    """The buffer rows that hold routed rows (bool [capacity])."""
    import torch

    used = torch.zeros(d.capacity, dtype=torch.bool, device=d.dest.device)
    used[d.dest] = True
    return used


def check_moe_kernels(dev, iters):
    """DeepSeekMoE's two grouped expert kernels against their plain versions
    (ops/moe.py) at the DeepSeek-V2-Lite cell's shapes, with routings that
    leave experts empty, skew the rest, or send every row to one expert; in
    the ragged routing a planted fault each must be caught (the busiest
    expert's offset shifted by one row). The grouped W8A8 GEMM (prefill: 64 x 314 tokens, 6 experts each)
    is bit-equal on the rows in use; the grouped W8A16 (decode: 64 tokens)
    is held by relative L2 as K1 is. Records each kernel's worst absolute
    error against its plain version, measured. Times each beside its
    bound, its plain version, and the per-expert loop of the dense kernels
    it replaces (w8a8_gemm with its transpose, K1), one launch an
    expert."""
    import torch
    from revisionllm_tpu_torch.ops import moe as MOE
    from revisionllm_tpu_torch.ops import quant as Q
    from revisionllm_tpu_torch.utils import kernels as KN

    gen = torch.Generator(device=dev).manual_seed(23)
    E, k, D, Fm = MOE_E, MOE_K, MOE_D, MOE_F
    few = max(3, iters // 4)
    out = {}
    worst = {"moe_w8a8": 0.0, "moe_w8a16": 0.0}
    mats = {"gate/up": (D, 2 * Fm), "down": (Fm, D)}
    weights = {}
    for name, (K, N) in mats.items():
        wq, ws = Q.quantize_int8(torch.randn((E, K, N), generator=gen, device=dev) * K ** -0.5)
        weights[name] = (wq, ws, wq.transpose(-1, -2).contiguous())

    for case in ("ragged", "one"):
        T = MOE_PREFILL_TOKENS
        idx = moe_routing(gen, T, k, E, dev, case)
        d = MOE.dispatch(idx, E, MOE.W8A8_PAD)
        used = moe_used_rows(d)
        busiest = int(d.counts.argmax())
        for name, (K, N) in mats.items():
            wq, ws, wt = weights[name]
            xq, xs = Q.quantize_rows(w8a8_rows(gen, d.capacity, K, dev))
            before = KN.LAUNCHES["moe_w8a8"]
            got = MOE.grouped_w8a8(xq, xs, wt, ws, d)
            again = MOE.grouped_w8a8(xq, xs, wt, ws, d)
            want = MOE.grouped_w8a8_plain(xq, xs, wt, ws, d)
            bad = MOE.grouped_w8a8_plain(xq, xs, wt, ws, moe_shifted(d, busiest))
            label = f"moe_w8a8 {case} {name} R={idx.numel()} K={K} N={N}"
            # with one expert a shifted start moves no row to another expert
            hold_bits(label, got[used], want[used],
                      {"offset shifted by one": bad[used]} if case == "ragged" else {})
            worst["moe_w8a8"] = max(worst["moe_w8a8"],
                                    (got[used].float() - want[used].float()).abs().max().item())
            if not torch.equal(got[used], again[used]) or KN.LAUNCHES["moe_w8a8"] != before + 2:
                raise AssertionError(f"{label}: two calls differ, or not one launch a call")
            del got, again, want, bad
            if case != "ragged":
                continue
            R = idx.numel()
            ms = kernel_ms(lambda: MOE.grouped_w8a8(xq, xs, wt, ws, d), iters,
                           MOE_KERNELS[:1])[MOE_KERNELS[0]]
            rows = MOE._expert_rows(d)
            loop = device_ms(lambda: [Q.w8a8_gemm(xq[s:s + c], xs[s:s + c], wq[e], ws[e])
                                      for e, s, c in rows], few)
            plain = device_ms(lambda: MOE.grouped_w8a8_plain(xq, xs, wt, ws, d), few)
            b, by = bound(R * K + E * K * N + 2 * R * N + 4 * R + 4 * E * N, 2.0 * R * K * N,
                          INT8_OPS_PER_S)
            say(f"{label}: kernel {ms:.4f} ms (under the profiler), bound {b:.4f} ms ({by}), "
                f"{100 * b / ms:.1f}% of it; plain version {plain:.4f} ms; per-expert loop of "
                f"w8a8_gemm (transpose + GEMM, {len(rows)} experts with rows) {loop:.4f} ms; "
                f"{d.capacity - R} padding rows")
            out[f"w8a8 {name}"] = {"ms": ms, "bound_ms": b, "plain_ms": plain, "loop_ms": loop}
            del xq, xs

        T = MOE_DECODE_TOKENS
        idx = moe_routing(gen, T, k, E, dev, case)
        d = MOE.dispatch(idx, E, 1)
        busiest = int(d.counts.argmax())
        for name, (K, N) in mats.items():
            wq, ws, _ = weights[name]
            x = torch.randn((idx.numel(), K), generator=gen, device=dev).to(torch.bfloat16)
            before = KN.LAUNCHES["moe_w8a16"]
            got = MOE.grouped_w8a16(x, wq, ws, d, T)
            again = MOE.grouped_w8a16(x, wq, ws, d, T)
            want = MOE.grouped_w8a16_plain(x, wq, ws, d)
            bad = MOE.grouped_w8a16_plain(x, wq, ws, moe_shifted(d, busiest))
            label = f"moe_w8a16 {case} {name} R={idx.numel()} K={K} N={N}"
            rel, rel_bad = rel_l2(got.float(), want.float()), rel_l2(bad.float(), want.float())
            err = (got.float() - want.float()).abs().max().item()
            worst["moe_w8a16"] = max(worst["moe_w8a16"], err)
            say(f"{label}: relative L2 {rel:.2e} (tol 1e-2), worst absolute {err:.3e}; offset "
                f"shifted by one "
                f"{rel_bad:.2e}; {int((d.counts == 0).sum())} empty experts, the busiest "
                f"{int(d.counts.max())} rows")
            if not (rel <= 1e-2 and (case != "ragged" or rel_bad > 1e-2)) \
                    or not torch.equal(got, again) \
                    or KN.LAUNCHES["moe_w8a16"] != before + 2:
                raise AssertionError(f"{label}: outside the tolerance, a fault passed, two calls "
                                     f"differ, or not one launch a call")
            if case != "ragged":
                continue
            R = idx.numel()
            ms = device_ms(lambda: MOE.grouped_w8a16(x, wq, ws, d, T), iters)
            rows = MOE._expert_rows(d)
            loop = device_ms(lambda: [Q.int8_matmul(x[s:s + c], wq[e], ws[e])
                                      for e, s, c in rows], few)
            plain = device_ms(lambda: MOE.grouped_w8a16_plain(x, wq, ws, d), few)
            hit = len(rows)
            b, by = bound(hit * K * N + 4 * hit * N + 2 * R * K + 2 * R * N, 2.0 * R * K * N)
            say(f"{label}: kernel {ms:.4f} ms, bound {b:.4f} ms ({by}, the {hit} experts hit), "
                f"{100 * b / ms:.1f}% of it; plain version {plain:.4f} ms; per-expert loop of "
                f"K1 {loop:.4f} ms")
            out[f"w8a16 {name}"] = {"ms": ms, "bound_ms": b, "plain_ms": plain, "loop_ms": loop}
    say(f"moe_grouped: worst absolute error against the plain versions {worst}")
    return {"name": "moe_grouped", "max_abs_err": max(worst.values()), "max_abs_errs": worst,
            "ms": out["w8a8 gate/up"]["ms"],
            "bound_ms": out["w8a8 gate/up"]["bound_ms"], "bound_by": "operations",
            "parts": out,
            "unit": f"DeepSeek-V2-Lite's gate/up of one MoE layer in the chunk-64 prefill "
                    f"({MOE_PREFILL_TOKENS} tokens x {k} experts)"}


def first_layers(tree, n):
    """The tree with its stacked layers cut to the first n (views)."""
    return {**tree, "layers": {k: ({kk: vv[:n] for kk, vv in v.items()}
                                   if isinstance(v, dict) else v[:n])
                               for k, v in tree["layers"].items()}}


def check_decode_step(dev, iters, params):
    """Row 9 at the stage-1 decode step's shape on the slice's Vicuna-7B
    int8 weights: B 64, the prompt's T, ragged prompt lengths, a bf16 gen
    cache at the last step (11 live slots). Both sides round the same
    values to bf16, but a value one f32 ulp from a rounding boundary rounds
    the other way on one side now and then, and over random layers those
    flips compound (relative L2 2.0e-3 after one layer, 4.8e-3 after two,
    3.7e-2 after 32, on the H100). So the hidden state and every layer's
    new k/v are held by the rows 4-6 limits at 2 layers of the full width,
    with two planted faults that must fail them (one K slice of the last
    layer's down product dropped; the second half of every prompt
    masked), and at all 32 layers by relative L2 within 1e-1. Times the
    32-layer kernel, its plain version and the split step
    (llama.decode_step_split, K1 + K3 and glue, lm_head included) at the
    same inputs (the yardstick)."""
    import torch
    from revisionllm_tpu_torch.config import LlamaConfig
    from revisionllm_tpu_torch.models import llama
    from revisionllm_tpu_torch.ops import decode_step as DS
    from revisionllm_tpu_torch.ops.rope import rope_angles

    cfg = LlamaConfig()
    L, H, hd, D = cfg.num_layers, cfg.num_heads, cfg.head_dim, cfg.hidden_size
    _, T, live = prompt_geometry("mad_grounding", 250, 12)
    B, G = 64, 12
    step = G - 1
    gen = torch.Generator(device=dev).manual_seed(16)
    lens = torch.randint(live - 20, live + 1, (B,), generator=gen, device=dev, dtype=torch.int32)
    lens[0] = live
    kv = torch.randint(-127, 128, (L, B, 2, H, T, hd), generator=gen, device=dev,
                       dtype=torch.int8)
    kvsc = torch.rand((L, B, 2, H, T), generator=gen, device=dev) * 0.02 + 0.005
    pkv = {"kv": kv, "kvsc": kvsc}
    genkv = (torch.randn((L, 2, B, H, 16, hd), generator=gen, device=dev) * 0.5).to(torch.bfloat16)
    ids = torch.randint(3, cfg.vocab_size, (B,), generator=gen, device=dev)
    x = params["embed"][ids]
    cos, sin = (t[:, 0] for t in rope_angles((lens + step)[:, None], hd, cfg.rope_theta))
    args = (lens, step, x, cos, sin)
    eps = cfg.rms_norm_eps

    p2, kv2 = first_layers(params, 2), {"kv": kv[:2], "kvsc": kvsc[:2]}
    gk, gp = genkv[:2].clone(), genkv[:2].clone()
    got, _ = DS.decode_step_fused(p2, kv2, gk, *args, eps=eps)
    want, _ = DS.decode_step_fused_plain(p2, kv2, gp, *args, eps=eps)
    down = p2["layers"]["down_proj"]
    cut = {"q8": down["q8"].clone(), "scale": down["scale"]}
    cut["q8"][1, :1024] = 0
    f_slice, _ = DS.decode_step_fused_plain(
        {**p2, "layers": {**p2["layers"], "down_proj": cut}}, kv2, genkv[:2].clone(), *args,
        eps=eps)
    f_half, _ = DS.decode_step_fused_plain(p2, kv2, genkv[:2].clone(), lens // 2, *args[1:],
                                           eps=eps)
    torch.cuda.synchronize()
    err = hold_cols(f"decode_step_fused 2 layers B={B} S={T} step={step} hidden", got, want, {
        "a K slice of the last down product dropped": f_slice,
        "the second half of every prompt masked": f_half})
    new = [t[:, :, :, :, step].reshape(2 * 2 * B, H * hd) for t in (gk, gp)]
    err = max(err, hold_cols("decode_step_fused 2 layers new k/v (slot step)", *new))
    del f_slice, f_half, new, cut

    gk, gp = genkv.clone(), genkv.clone()
    got, _ = DS.decode_step_fused(params, pkv, gk, *args, eps=eps)
    want, _ = DS.decode_step_fused_plain(params, pkv, gp, *args, eps=eps)
    rel = ((got.float() - want.float()).norm() / want.float().norm()).item()
    kv_rel = ((gk[:, :, :, :, step].float() - gp[:, :, :, :, step].float()).norm()
              / gp[:, :, :, :, step].float().norm()).item()
    say(f"decode_step_fused 32 layers: hidden relative L2 {rel:.3e}, new k/v {kv_rel:.3e} "
        f"(tol 1e-1: the flips compound over the layers), finite {bool(got.isfinite().all())}")
    if not (rel <= 1e-1 and kv_rel <= 1e-1 and bool(got.isfinite().all())):
        raise AssertionError(f"decode_step_fused at 32 layers: relative L2 {rel}, {kv_rel}")
    # slot `step` is written, never read, by the step: a second call sees the same inputs
    first = (got, gk[:, :, :, :, step].clone())
    again, _ = DS.decode_step_fused(params, pkv, gk, *args, eps=eps)
    same_bits("decode_step_fused 32 layers (hidden, new k/v)", first,
              (again, gk[:, :, :, :, step]))
    del first, again

    plain_iters = max(2, iters // 10)
    ms = device_ms(lambda: DS.decode_step_fused(params, pkv, gk, *args, eps=cfg.rms_norm_eps),
                   iters)
    plain = device_ms(lambda: DS.decode_step_fused_plain(params, pkv, gp, *args,
                                                         eps=cfg.rms_norm_eps), plain_iters)
    del gp
    split = {"k": kv[:, :, 0].permute(0, 1, 3, 2, 4).contiguous(),
             "v": kv[:, :, 1].permute(0, 1, 3, 2, 4).contiguous(),
             "k_scale": kvsc[:, :, 0].permute(0, 1, 3, 2).contiguous(),
             "v_scale": kvsc[:, :, 1].permute(0, 1, 3, 2).contiguous()}
    gsplit = {"k": genkv[:, 0, :, :, :G].permute(0, 1, 3, 2, 4).contiguous(),
              "v": genkv[:, 1, :, :, :G].permute(0, 1, 3, 2, 4).contiguous()}
    split_step = partial(llama.decode_step_split, cfg, params, split, lens, gsplit, step,
                         x[:, None])
    lib = device_ms(split_step, plain_iters)
    lib_busy = busy_ms(split_step)
    del split, gsplit, split_step
    mats = sum(w["q8"].numel() + w["scale"].numel() * 4 for n, w in params["layers"].items()
               if isinstance(w, dict))
    nlive = int(lens.sum())
    nbytes = (mats + 2 * L * D * 2 + L * nlive * H * (2 * hd + 8)
              + L * 2 * B * H * (step + 1) * hd * 2 + 2 * B * D * 2 + 2 * B * hd * 4 + B * 4)
    ops = 2.0 * B * sum(w["q8"].numel() for w in params["layers"].values()
                        if isinstance(w, dict)) + 4.0 * L * H * hd * (nlive + B * (step + 1))
    b, by = bound(nbytes, ops)
    say(f"decode_step_fused B={B} S={T} step={step} (32 layers): kernel {ms:.4f} ms plain "
        f"{plain:.4f} ms decode_step_split (K1 + K3 + glue, lm_head included) {lib:.4f} ms "
        f"by events (host-paced), {lib_busy:.4f} ms device-busy under the profiler; "
        f"bound {b:.4f} ms ({by})")
    del pkv, kv, kvsc, genkv, gk
    torch.cuda.empty_cache()
    return {"name": "decode_step_fused", "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": b, "bound_by": by, "library_ms": lib, "library_busy_ms": lib_busy,
            "unit": "one launch = one whole decode step of the chunk-64 stage-1 decode; "
                    "library: the split step (decode_step_split) at the same inputs, by CUDA "
                    "events (library_busy_ms: its device-busy time under the profiler)"}


def serve_inputs(cfg, params, B, T, live, G, dev, seed=17):
    """Row 10's inputs at the stage-1 decode step: the packed layers
    (pack_serving_weights, block 1024), B ragged prompt lengths in [live -
    20, live] (row 0 the longest), a random unified slab with s0 = T and Sp =
    round_up(T + G, 128) -- random in the dead range and past s0 + step too,
    which the step must not read --, the embeddings of random tokens and
    the rope angles at the last step, G - 1. Returns (packed, slab, args),
    args = (prompt_lens, step, x, cos, sin, s0)."""
    import torch
    from revisionllm_tpu_torch.ops import decode_serve as DSV
    from revisionllm_tpu_torch.ops.rope import rope_angles

    layers = params["layers"]
    L, H, hd = layers["q_proj"]["q8"].shape[0], cfg.num_heads, cfg.head_dim
    gen = torch.Generator(device=dev).manual_seed(seed)
    lens = torch.randint(live - 20, live + 1, (B,), generator=gen, device=dev, dtype=torch.int32)
    lens[0] = live
    Sp = -(-(T + G) // 128) * 128
    slab = {"kv": torch.randint(-127, 128, (L, B, 2, H, Sp, hd), generator=gen, device=dev,
                                dtype=torch.int8),
            "kvsc": torch.rand((L, B, 2, H, Sp), generator=gen, device=dev) * 0.02 + 0.005}
    step = G - 1
    ids = torch.randint(3, cfg.vocab_size, (B,), generator=gen, device=dev)
    x = params["embed"][ids]
    cos, sin = (t[:, 0] for t in rope_angles((lens + step)[:, None], hd, cfg.rope_theta))
    return DSV.pack_serving_weights(layers), slab, (lens, step, x, cos, sin, T)


def serve_faults(packed, slab, args, eps):
    """Row 10's planted faults, on its plain version: the dead range [plen,
    s0) read as if it held prompt keys (prompt lengths set to s0), and the
    last column chunk of every layer's gate product dropped. Each returns
    the faulty hidden state."""
    import torch
    from revisionllm_tpu_torch.ops import decode_serve as DSV

    lens, step, x, cos, sin, s0 = args
    gate = packed["gate_proj"]
    cut = {"q8c": gate["q8c"].clone(), "scale": gate["scale"]}
    cut["q8c"][:, -1] = 0
    scratch = {k: v.clone() for k, v in slab.items()}
    return {
        "the dead range [plen, s0) unmasked": DSV.decode_step_serve_plain(
            packed, scratch, torch.full_like(lens, s0), *args[1:], eps=eps)[0],
        "the last gate chunk dropped": DSV.decode_step_serve_plain(
            {**packed, "gate_proj": cut}, scratch, *args, eps=eps)[0],
    }


def serve_matrix_work(cfg, packed):
    """(bytes, multiply-adds per row) of row 10's layer matrices up to their
    logical extents: each int8 matrix and its f32 column scales, counting
    gate/up's first F columns and down's first F rows only. The Fp padding
    (zero columns with zero scale, zero rows) adds exact zeros that the
    function does not need, so the bound leaves it out, as row 9's does."""
    hq, hkv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    F = cfg.intermediate_size
    nbytes = macs = 0
    for name, N in (("q_proj", hq), ("k_proj", hkv), ("v_proj", hkv),
                    ("o_proj", cfg.hidden_size), ("gate_proj", F), ("up_proj", F)):
        L, _, K, _ = packed[name]["q8c"].shape
        nbytes += L * N * (K + 4)
        macs += L * K * N
    L, _, _, D = packed["down_proj"]["q8r"].shape
    return nbytes + L * D * (F + 4), macs + L * F * D


def landed(slab, s0, step):
    """The k/v a step landed at s0 + step, dequantized: [L * B * 2, H * hd]."""
    kv = slab["kv"][:, :, :, :, s0 + step].float() * slab["kvsc"][:, :, :, :, s0 + step, None]
    return kv.reshape(-1, kv.shape[-2] * kv.shape[-1])


def check_decode_serve(dev, iters, params, row9_ms):
    """Row 10 at the stage-1 decode step's shape on the slice's Vicuna-7B
    int8 weights packed into the serving chunks (serve_inputs): B 64, s0 =
    the prompt's T, step 11. As for row 9, bf16 rounding flips compound over
    random layers, so the hidden state and every layer's landed new k/v
    (dequantized) are held by the rows 4-6 limits at 2 layers of the full
    width, with two planted faults that must fail them (serve_faults), and
    at all 32 layers by relative L2 within 1e-1. Times the 32-layer kernel
    with its landing (the wrapper's call), its plain version and, as
    yardsticks (no single PyTorch call computes the step), row 9 on the
    standard tree at the same shape (`row9_ms`, check_decode_step's time in
    this run) and decode_step_split on the packed tree (K1 per column chunk
    + K3 + glue, lm_head included)."""
    import torch
    from revisionllm_tpu_torch.config import LlamaConfig
    from revisionllm_tpu_torch.models import llama
    from revisionllm_tpu_torch.ops import decode_serve as DSV

    cfg = LlamaConfig()
    L, H, hd = cfg.num_layers, cfg.num_heads, cfg.head_dim
    _, T, live = prompt_geometry("mad_grounding", 250, 12)
    B, G = 64, 12
    eps = cfg.rms_norm_eps
    packed, slab, args = serve_inputs(cfg, params, B, T, live, G, dev)
    lens, step, x, cos, sin, s0 = args

    p2 = first_layers({"layers": packed}, 2)["layers"]
    slab2 = {"kv": slab["kv"][:2], "kvsc": slab["kvsc"][:2]}
    got, _ = DSV.decode_step_serve(p2, slab2, *args, eps=eps)
    got_kv = landed(slab2, s0, step)
    want, _ = DSV.decode_step_serve_plain(p2, slab2, *args, eps=eps)
    want_kv = landed(slab2, s0, step)
    faults = serve_faults(p2, slab2, args, eps)
    torch.cuda.synchronize()
    err = hold_cols(f"decode_step_serve 2 layers B={B} s0={s0} step={step} hidden", got, want,
                    faults)
    err = max(err, hold_cols("decode_step_serve 2 layers new k/v (landed at s0 + step, "
                             "dequantized)", got_kv, want_kv))
    del faults, got_kv, want_kv

    got, _ = DSV.decode_step_serve(packed, slab, *args, eps=eps)
    got_kv = landed(slab, s0, step)
    want, _ = DSV.decode_step_serve_plain(packed, slab, *args, eps=eps)
    want_kv = landed(slab, s0, step)
    rel = ((got.float() - want.float()).norm() / want.float().norm()).item()
    kv_rel = ((got_kv - want_kv).norm() / want_kv.norm()).item()
    say(f"decode_step_serve 32 layers: hidden relative L2 {rel:.3e}, new k/v {kv_rel:.3e} "
        f"(tol 1e-1: the flips compound over the layers), finite {bool(got.isfinite().all())}")
    if not (rel <= 1e-1 and kv_rel <= 1e-1 and bool(got.isfinite().all())):
        raise AssertionError(f"decode_step_serve at 32 layers: relative L2 {rel}, {kv_rel}")
    # the step reads the slab at [0, plen) and [s0, s0 + step) and lands at s0 +
    # step: a second call sees the same inputs
    again, _ = DSV.decode_step_serve(packed, slab, *args, eps=eps)
    same_bits("decode_step_serve 32 layers (hidden, landed k/v)", (got, got_kv),
              (again, landed(slab, s0, step)))
    del got_kv, want_kv, again

    plain_iters = max(2, iters // 10)
    ms = device_ms(lambda: DSV.decode_step_serve(packed, slab, *args, eps=eps), iters)
    plain = device_ms(lambda: DSV.decode_step_serve_plain(packed, slab, *args, eps=eps),
                      plain_iters)
    kv = slab["kv"]
    split = {"k": kv[:, :, 0, :, :T].permute(0, 1, 3, 2, 4).contiguous(),
             "v": kv[:, :, 1, :, :T].permute(0, 1, 3, 2, 4).contiguous(),
             "k_scale": slab["kvsc"][:, :, 0, :, :T].permute(0, 1, 3, 2).contiguous(),
             "v_scale": slab["kvsc"][:, :, 1, :, :T].permute(0, 1, 3, 2).contiguous()}
    gsplit = llama.init_gen_cache(cfg, B, G, torch.bfloat16, dev)
    tree = {**params, "layers": packed}
    split_step = partial(llama.decode_step_split, cfg, tree, split, lens, gsplit, step,
                         x[:, None])
    split_ms = device_ms(split_step, plain_iters)
    split_busy = busy_ms(split_step)
    del split, gsplit, split_step
    mats, macs = serve_matrix_work(cfg, packed)
    keys = int(lens.sum()) + B * step
    nbytes = (mats + 2 * L * cfg.hidden_size * 2 + L * keys * H * (2 * hd + 8)
              + L * 2 * B * H * hd * 4 + L * 2 * B * H * (hd + 4)
              + 2 * B * cfg.hidden_size * 2 + 2 * B * hd * 4 + B * 4)
    ops = 2.0 * B * macs + 4.0 * L * H * hd * (keys + B)
    b, by = bound(nbytes, ops)
    say(f"decode_step_serve B={B} s0={s0} step={step} (32 layers, packed block 1024, Fp "
        f"{packed['gate_proj']['scale'].shape[1]}): kernel + landing {ms:.4f} ms plain "
        f"{plain:.4f} ms; yardsticks: row 9 on the standard tree {row9_ms:.4f} ms, "
        f"decode_step_split on the packed tree (K1 per chunk + K3 + glue, lm_head included) "
        f"{split_ms:.4f} ms by events (host-paced), {split_busy:.4f} ms device-busy under the "
        f"profiler; bound {b:.4f} ms ({by})")
    del packed, slab, kv
    torch.cuda.empty_cache()
    return {"name": "decode_step_serve", "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": b, "bound_by": by, "library_ms": None,
            "row9_standard_ms": row9_ms, "split_packed_ms": split_ms,
            "split_packed_busy_ms": split_busy,
            "unit": "one launch and its landing = one whole decode step of the chunk-64 "
                    "stage-1 decode over the packed tree; no single PyTorch call computes it "
                    "(library_ms null): yardsticks row 9 on the standard tree and "
                    "decode_step_split on the packed tree"}


def check_long_caches(dev, params):
    """Rows 9 and 10 at the longest cache Vicuna-7B supports
    (max_position_embeddings, 4096 positions: row 9's Sp + Gp, row 10's s0 +
    step + 1), where the attention phase's scores take 16 KB a team of the
    activation region, so it runs fewer, larger teams of the consumer warps
    (decode_step.attn_layout). 2 layers of the full width, B 8, prompts within 64 of their
    longest, held by the rows 4-6 limits against the plain versions, with
    the second half of every prompt masked as the planted fault. Returns
    {row's name: its largest error}, and prints each 2-layer launch's time."""
    import torch
    from revisionllm_tpu_torch.config import LlamaConfig
    from revisionllm_tpu_torch.ops import decode_serve as DSV
    from revisionllm_tpu_torch.ops import decode_step as DS
    from revisionllm_tpu_torch.ops.rope import rope_angles

    cfg = LlamaConfig()
    H, hd, n = cfg.num_heads, cfg.head_dim, cfg.max_position_embeddings
    B, G, eps = 8, 16, cfg.rms_norm_eps
    step = G - 1
    p2 = first_layers(params, 2)
    gen = torch.Generator(device=dev).manual_seed(18)
    Sp = n - G
    lens = torch.randint(Sp - 64, Sp + 1, (B,), generator=gen, device=dev, dtype=torch.int32)
    lens[0] = Sp
    kv = {"kv": torch.randint(-127, 128, (2, B, 2, H, Sp, hd), generator=gen, device=dev,
                              dtype=torch.int8),
          "kvsc": torch.rand((2, B, 2, H, Sp), generator=gen, device=dev) * 0.02 + 0.005}
    genkv = (torch.randn((2, 2, B, H, G, hd), generator=gen, device=dev) * 0.5).to(torch.bfloat16)
    x = params["embed"][torch.randint(3, cfg.vocab_size, (B,), generator=gen, device=dev)]
    cos, sin = (t[:, 0] for t in rope_angles((lens + step)[:, None], hd, cfg.rope_theta))
    got, _ = DS.decode_step_fused(p2, kv, genkv.clone(), lens, step, x, cos, sin, eps=eps)
    want, _ = DS.decode_step_fused_plain(p2, kv, genkv.clone(), lens, step, x, cos, sin, eps=eps)
    half, _ = DS.decode_step_fused_plain(p2, kv, genkv.clone(), lens // 2, step, x, cos, sin,
                                         eps=eps)
    teams, stages = DS.attn_layout(Sp + G, DS._slices(cfg.hidden_size))
    err9 = hold_cols(f"decode_step_fused 2 layers B={B} Sp+Gp={n} ({teams} attention teams, "
                     f"{stages} ring slots each) hidden", got, want,
                     {"the second half of every prompt masked": half})
    gk = genkv.clone()
    ms = device_ms(lambda: DS.decode_step_fused(p2, kv, gk, lens, step, x, cos, sin, eps=eps), 5)
    say(f"decode_step_fused 2 layers B={B} Sp+Gp={n}: {ms:.4f} ms")
    del kv, genkv, gk

    packed = DSV.pack_serving_weights(p2["layers"])
    s0 = n - G
    slab = {"kv": torch.randint(-127, 128, (2, B, 2, H, n, hd), generator=gen, device=dev,
                                dtype=torch.int8),
            "kvsc": torch.rand((2, B, 2, H, n), generator=gen, device=dev) * 0.02 + 0.005}
    args = (step, x, cos, sin, s0)
    got, _ = DSV.decode_step_serve(packed, slab, lens, *args, eps=eps)
    want, _ = DSV.decode_step_serve_plain(packed, slab, lens, *args, eps=eps)
    half, _ = DSV.decode_step_serve_plain(packed, slab, lens // 2, *args, eps=eps)
    teams, stages = DS.attn_layout(s0 + step, DS._slices(cfg.hidden_size))
    err10 = hold_cols(
        f"decode_step_serve 2 layers B={B} s0+step={s0 + step} ({teams} attention teams, "
        f"{stages} ring slots each) hidden", got, want,
        {"the second half of every prompt masked": half})
    ms = device_ms(lambda: DSV.decode_step_serve(packed, slab, lens, *args, eps=eps), 5)
    say(f"decode_step_serve 2 layers B={B} s0+step={s0 + step}: {ms:.4f} ms")
    del packed, slab
    torch.cuda.empty_cache()
    return {"decode_step_fused": err9, "decode_step_serve": err10}


# ------------------------------------------------------------------ phase 13


CONFIGS = {
    # A: int8 weights, W8A8 prefill, KV8, row 8 in every prefill layer, row 9
    # for every decode step (the lm_head on K1 after the prefill and each step)
    "A (fused int8)": {
        "env": {"REVISIONLLM_FUSED_MLP": "1", "REVISIONLLM_MEGAKERNEL": "1"},
        "quantize": "int8", "pack": False, "step": "mega", "kernels": FUSED,
        "launches": {"w8a8_mlp_fused": 32, "decode_step_fused": 11, "decode_attention": 0,
                     "int4_matmul": 0, "int8_matmul": 12}},
    # B: group-128 int4 weights (lm_head too), KV8; row 7 for the 7 matrices
    # of every layer and the lm_head at each of the 11 steps and the
    # prefill's lm_head, which dequantizes the rest
    "B (int4)": {
        "env": {}, "quantize": "int4", "pack": False, "step": "split", "kernels": INT4,
        "launches": {"int4_matmul": 11 * (32 * 7 + 1) + 1, "int8_matmul": 0,
                     "decode_attention": 11 * 32, "w8a8_mlp_fused": 0, "decode_step_fused": 0}},
    # C: the int8 tree packed into the serving chunks (pack_serving_weights
    # on the card, as bench.py:98-106), W8A8 prefill over the column chunks
    # into the unified slab, KV8; row 10 for every decode step (the lm_head,
    # which stays standard, on K1 after the prefill and each step)
    "C (packed int8 serving)": {
        "env": {"REVISIONLLM_SERVE": "1"}, "quantize": "int8", "pack": True, "step": "serve",
        "kernels": SERVE,
        "launches": {"decode_step_serve": 11, "int8_matmul": 12, "flash_attention": 32,
                     "decode_attention": 0, "decode_step_fused": 0, "w8a8_mlp_fused": 0,
                     "int4_matmul": 0}},
}
SWITCHES = ("REVISIONLLM_FUSED_MLP", "REVISIONLLM_MEGAKERNEL", "REVISIONLLM_Q4_PALLAS",
            "REVISIONLLM_SERVE")


class switched:
    """Sets the configuration's switches in os.environ (the others unset)
    while inside, as a user would set them before running the engine."""

    def __init__(self, env):
        self.env = env

    def __enter__(self):
        self.old = {k: os.environ.pop(k, None) for k in SWITCHES}
        os.environ.update(self.env)

    def __exit__(self, *exc):
        for k in SWITCHES:
            os.environ.pop(k, None)
            if self.old[k] is not None:
                os.environ[k] = self.old[k]


def phase_configs(dev, setup, runs):
    """Configurations A, B and C through ground_windows on the 1-hour movie
    at Vicuna-7B width and depth: chunk latency (median of `runs`), q/s,
    peak memory, launches in one run (fails unless they are the expected
    ones, rows 8 and 9 in A, row 7 in B, row 10 in C, and unless the 57
    entropies are finite), and where a chunk's time goes (prefill and
    decode step: wall, host enqueue, device busy). A runs on the slice's
    int8 engine; B on an int4 engine from the same seed; C on an engine
    over the slice's int8 tree packed on the card (the standard tree stays
    resident for the phases after this one, so C's peak memory holds both).
    Returns {label: launches}."""
    import torch

    slice_engine, movie, qf, qc = setup
    out = {}
    for label, conf in CONFIGS.items():
        if conf["pack"]:
            t0 = time.perf_counter()
            eng = packed_engine(slice_engine, dev)
            torch.cuda.synchronize()
            say(f"config {label}: the slice's int8 layers packed on the card (block 1024, F "
                f"padded to {eng.params['layers']['gate_proj']['scale'].shape[1]}) in "
                f"{time.perf_counter() - t0:.1f} s; the standard tree stays resident")
        elif conf["quantize"] == "int8":
            eng = slice_engine
        else:
            t0 = time.perf_counter()
            eng = make_engine(slice_engine.llama_cfg, slice_engine.adapter_cfg,
                              slice_engine.eval_cfg, dev, torch.bfloat16, quantize="int4")
            torch.cuda.synchronize()
            say(f"config {label}: int4 Vicuna-7B weights (group 128, lm_head too) built from "
                f"seed 0 in {time.perf_counter() - t0:.1f} s")
        with switched(conf["env"]):
            t0 = time.perf_counter()
            eng.ground_windows(movie, SENTENCE, qf, qc, movie_key="movie0")
            torch.cuda.synchronize()
            warm = time.perf_counter() - t0
            torch.cuda.reset_peak_memory_stats()
            res, launches, lat = run_slice(eng, movie, qf, qc, runs)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            check_result(res, 57)
            chunk_s = float(np.median(lat))
            say(f"config {label}: switches {conf['env'] or 'none'}; warm-up {warm:.3f} s; "
                f"ground_windows x{runs}: latencies {[round(x, 4) for x in lat]} s; chunk latency "
                f"(median) {chunk_s * 1e3:.1f} ms; q/s {1 / chunk_s:.4f}; peak memory "
                f"{peak:.2f} GiB; entropies finite")
            say(f"config {label}: launches in one ground_windows: "
                + str({k: n for k, n in launches.items() if n}))
            bad = {k: (launches[k], n) for k, n in conf["launches"].items() if launches[k] != n}
            if bad:
                raise AssertionError(f"config {label}: launches (got, expected) {bad}")
            say_breakdown(f"config {label}", step_breakdown(eng, movie, qf, conf["step"]))
        out[label] = launches
        if eng is not slice_engine:
            del eng
            torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------------ phase 14

CKPT_LAYERS = 4             # Vicuna-7B width, depth cut to 4 layers (2.1 GB of fp16)
CKPT_STD = 0.02             # HF Llama's initializer_range
CKPT_LOGITS_TOL = 1e-2      # relative L2 of first-step logits, loaded vs in-memory tree
CKPT_LORA = ("q_proj", "k_proj", "v_proj", "o_proj")
HF_NAMES = {"q_proj": "self_attn.q_proj", "k_proj": "self_attn.k_proj",
            "v_proj": "self_attn.v_proj", "o_proj": "self_attn.o_proj",
            "gate_proj": "mlp.gate_proj", "up_proj": "mlp.up_proj", "down_proj": "mlp.down_proj",
            "attn_norm": "input_layernorm", "mlp_norm": "post_attention_layernorm"}
ST_DTYPES = {"float16": "F16", "float32": "F32", "int8": "I8"}


def write_safetensors(path, tensors):
    """{name: array} -> a .safetensors file: the header's byte length (8
    bytes, little-endian), the JSON header (dtype, shape and data_offsets of
    each tensor, padded with spaces to 8 bytes), then the tensors' bytes in
    order. Returns the bytes written."""
    header, offset = {"__metadata__": {"format": "pt"}}, 0
    for name, a in tensors.items():
        header[name] = {"dtype": ST_DTYPES[a.dtype.name], "shape": list(a.shape),
                        "data_offsets": [offset, offset + a.nbytes]}
        offset += a.nbytes
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for a in tensors.values():
            f.write(np.ascontiguousarray(a, a.dtype.newbyteorder("<")).data)
    return 8 + len(raw) + offset


def ckpt_tree(cfg, device, seed=0, std=CKPT_STD):
    """The port-layout tree ([in, out] matrices stacked on L) of a random
    Llama as fp16 NumPy arrays, drawn on `device` from `seed`: N(0, std)
    matrices and embeddings, norms 1 + N(0, std). At 7B width the default
    std gives attention scores of std about 1.6, as HF's initializer does."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    L, D, F, V = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    q, kv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim

    def draw(*shape, mean=0.0):
        t = torch.randn(shape, generator=gen, device=device) * std + mean
        return t.to(torch.float16).cpu().numpy()

    shapes = {"q_proj": (L, D, q), "k_proj": (L, D, kv), "v_proj": (L, D, kv),
              "o_proj": (L, q, D), "gate_proj": (L, D, F), "up_proj": (L, D, F),
              "down_proj": (L, F, D)}
    layers = {n: draw(*s) for n, s in shapes.items()}
    layers.update(attn_norm=draw(L, D, mean=1.0), mlp_norm=draw(L, D, mean=1.0))
    return {"embed": draw(V, D), "layers": layers, "final_norm": draw(D, mean=1.0),
            "lm_head": draw(D, V)}


def hf_config(cfg):
    """config.json of LlamaForCausalLM for `cfg`, as Vicuna-7B v1.5's (fp16)."""
    return {"architectures": ["LlamaForCausalLM"], "model_type": "llama",
            "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
            "intermediate_size": cfg.intermediate_size, "num_hidden_layers": cfg.num_layers,
            "num_attention_heads": cfg.num_heads, "num_key_value_heads": cfg.num_kv_heads,
            "hidden_act": "silu", "rms_norm_eps": cfg.rms_norm_eps, "rope_theta": cfg.rope_theta,
            "max_position_embeddings": cfg.max_position_embeddings, "initializer_range": CKPT_STD,
            "tie_word_embeddings": False, "attention_bias": False, "bos_token_id": 1,
            "eos_token_id": 2, "pad_token_id": 0, "torch_dtype": "float16"}


def hf_shards(tree, fault=False):
    """The tree in HF layout ([out, in], HF names) as two shards, the first
    with the embedding and the first half of the layers. fault=True writes
    layer 0's q_proj untransposed (square, so it still loads)."""
    import torch

    def hf(w):  # [in, out] -> [out, in], the transposing copy in torch
        return torch.from_numpy(w).T.contiguous().numpy()

    L = tree["layers"]["q_proj"].shape[0]
    shards = ({"model.embed_tokens.weight": tree["embed"]},
              {"model.norm.weight": tree["final_norm"], "lm_head.weight": hf(tree["lm_head"])})
    for i in range(L):
        for name, hf_name in HF_NAMES.items():
            w = tree["layers"][name][i]
            if not name.endswith("_norm") and not (fault and i == 0 and name == "q_proj"):
                w = hf(w)
            shards[i >= L // 2][f"model.layers.{i}.{hf_name}.weight"] = w
    return shards


def write_checkpoint(path, cfg, tree, fault=False, shard2=None):
    """An HF checkpoint directory: config.json and two fp16 .safetensors
    shards (the second linked from `shard2` when given). Returns the bytes
    written."""
    os.makedirs(path)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_config(cfg), f)
    nbytes = 0
    for i, shard in enumerate(hf_shards(tree, fault)):
        name = os.path.join(path, f"model-0000{i + 1}-of-00002.safetensors")
        if i == 1 and shard2 is not None:
            os.symlink(shard2, name)
        else:
            nbytes += write_safetensors(name, shard)
    return nbytes


def write_stage_dir(path, cfg, acfg, seed=1):
    """A stage directory through the port's exporter: LoRA r 64 on CKPT_LORA
    (A ~ N(0, 1/64^2), B ~ N(0, CKPT_STD^2)) and the ClipEncoder adapter of
    `acfg` from `seed`. Returns (lora, lora_cfg, vision) as the exporter got
    them (f32 CPU tensors)."""
    import torch
    from revisionllm_tpu_torch.config import LoraConfig
    from revisionllm_tpu_torch.models import revisionllm
    from revisionllm_tpu_torch.models.llama import LAYER_MATRICES, _dims
    from revisionllm_tpu_torch.train.checkpoint import export_reference_artifacts

    lora_cfg = LoraConfig(r=64, alpha=128, target_patterns=CKPT_LORA)
    gen = torch.Generator().manual_seed(seed)
    dims = _dims(cfg)
    lora = {"layers": {}}
    for name in CKPT_LORA:
        din, dout = (dims[d] for d in LAYER_MATRICES[name])
        lora["layers"][name] = {
            "a": torch.randn((cfg.num_layers, din, 64), generator=gen) / 64,
            "b": torch.randn((cfg.num_layers, 64, dout), generator=gen) * CKPT_STD}
    vision = revisionllm.init_vision_params(acfg, seed=seed + 1, d_in=acfg.d_model,
                                            device="cpu")
    export_reference_artifacts(path, lora, lora_cfg, vision)
    return lora, lora_cfg, vision


def ckpt_reference(tree, lora, lora_cfg):
    """What the loader must give for the checkpoint of `tree` and a stage
    directory of `lora`, built in memory without the files and without
    models/convert.py: every value rounded to bf16, the LoRA merged
    (models.lora.merge on the bf16 base, A and B rounded to bf16, the result
    rounded again), then quantize_llama_params_host. NumPy arrays."""
    import torch
    from revisionllm_tpu_torch.models import lora as lora_mod
    from revisionllm_tpu_torch.ops import quant

    def bf(a):
        return torch.as_tensor(np.asarray(a, np.float32)).to(torch.bfloat16)

    adapter = {n: {k: bf(v).float() for k, v in m.items()} for n, m in lora["layers"].items()}
    merged = lora_mod.merge({"layers": {n: bf(w) for n, w in tree["layers"].items()}},
                            {"layers": adapter}, lora_cfg)["layers"]
    ref = {k: bf(tree[k]).float().numpy() for k in ("embed", "final_norm", "lm_head")}
    ref["layers"] = {n: w.float().numpy() for n, w in merged.items()}
    return quant.quantize_llama_params_host(ref)


def as_loaded(ref, vision, serve):
    """The reference trees as the loader hands them to the device (the
    serving pack with `serve`; bf16 floats, f32 scales), on the CPU."""
    import torch
    from revisionllm_tpu_torch.models.weights import params_from_numpy
    from revisionllm_tpu_torch.ops import quant

    if serve:
        ref = {**ref, "layers": quant.pack_serving_weights_host(ref["layers"])}
    cpu = torch.device("cpu")
    return (params_from_numpy(ref, cpu, torch.bfloat16),
            params_from_numpy(vision, cpu, torch.bfloat16))


def tree_mismatches(got, want):
    """Paths where the loaded tree `got` (any device) is not torch.equal to
    `want` (the CPU), in structure, dtype or value."""
    import torch

    got, want = dict(_named_leaves(got)), dict(_named_leaves(want))
    return sorted(set(got) ^ set(want)) + [
        p for p, w in want.items()
        if p in got and not (got[p].dtype == w.dtype and torch.equal(got[p].cpu(), w))]


class LoadClock:
    """Times the loader's steps while inside, by wrapping the functions it
    calls (the outermost call of each): reading and converting the
    checkpoint, the LoRA merge, the int8 quantization, the serving pack and
    the host-to-device copy. `seconds` holds the sums."""

    STEPS = (("load_pretrained", "revisionllm_tpu_torch.models.convert", "load_pretrained"),
             ("read", "revisionllm_tpu_torch.models.convert", "load_hf_llama_state"),
             ("merge", "revisionllm_tpu_torch.models.convert", "merge_lora"),
             ("quantize", "revisionllm_tpu_torch.ops.quant", "quantize_llama_params_host"),
             ("pack", "revisionllm_tpu_torch.ops.quant", "pack_serving_weights_host"),
             ("to device", "revisionllm_tpu_torch.models.weights", "params_from_numpy"))

    def __enter__(self):
        import importlib

        self.seconds = {step: 0.0 for step, _, _ in self.STEPS}
        self.orig = []
        for step, mod, name in self.STEPS:
            module = importlib.import_module(mod)
            fn = getattr(module, name)
            self.orig.append((module, name, fn))
            setattr(module, name, self._timed(step, fn))
        return self

    def _timed(self, step, fn):
        depth = [0]

        def wrapper(*a, **k):
            depth[0] += 1
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                depth[0] -= 1
                if depth[0] == 0:
                    self.seconds[step] += time.perf_counter() - t0
        return wrapper

    def __exit__(self, *exc):
        for module, name, fn in self.orig:
            setattr(module, name, fn)


def first_step_logits(eng, movie, qf_np):
    """Prefill logits [1, V] (f32) of the movie's first window under the
    engine's serving numerics (KV8, W8A8 where its weights are int8)."""
    import torch
    from revisionllm_tpu_torch.constants import QUESTIONS
    from revisionllm_tpu_torch.models import llama, revisionllm
    from revisionllm_tpu_torch.models.multimodal import build_splice_plan, stack_plans

    T, G = eng.eval_cfg.num_frames, eng.eval_cfg.max_new_tokens
    ids = eng._prompt_ids(SENTENCE, QUESTIONS["mad_grounding"])
    plan = stack_plans([build_splice_plan(ids, T, len(ids) - 1 + T + G)])
    plan = {k: torch.as_tensor(v, device=eng.device) for k, v in plan.items()}
    images = torch.as_tensor(movie[None, :T], device=eng.device).to(eng.dtype)
    qf, qv = eng._broadcast_query_feats(qf_np, 1)
    with torch.no_grad():
        video = revisionllm.encode_video(eng.adapter_cfg, eng.vision_params, images, qf, qv)
        embeds, pos, lens = revisionllm.assemble_inputs(eng.params, plan, video, dtype=eng.dtype)
        return llama.prefill_kv(eng.llama_cfg, eng.params, embeds, pos, kv_lens=lens,
                                kv_quant=True)[0].float()


def rel_l2(got, want):
    return ((got - want).norm() / want.norm()).item()


def same_records(got, want):
    """Stage-1 JSONL records: every field equal but the scores, which agree
    within rtol 1e-4."""
    def fields(r):
        return {k: v for k, v in r.items() if k != "info"}, r["info"]["iou"]

    return len(got) == len(want) and all(
        fields(g) == fields(w)
        and np.allclose(g["info"]["scores"], w["info"]["scores"], rtol=1e-4, atol=1e-6)
        for g, w in zip(got, want))


CKPT_RUNS = {
    # the CUDA default, REVISIONLLM_QUANT unset: int8 layers, W8A8 prefill
    # (csrc/w8a8_gemm.cu), K2, then K3 and K1 at every decode step
    "standard": {"env": {}, "kernels": SERVING + W8A8},
    # the host pack: row 10 for every decode step, K1 for the lm_head, K2
    "serve": {"env": {"REVISIONLLM_SERVE": "1"},
              "kernels": ("decode_step_serve", "int8_matmul", "flash_attention")},
}


def phase_checkpoint(dev, tmp, movie):
    """The HF checkpoint loader through the entry point a user calls: a
    random Llama at Vicuna-7B width and CKPT_LAYERS layers written as an HF
    directory of two fp16 .safetensors shards and a stage directory from the
    port's exporter, loaded by eval.loader.build_engine_from_args from
    stage1.parse_args' flags and run through stage1.run over the 1-hour
    movie, standard and with REVISIONLLM_SERVE=1. Fails unless each run
    launched its kernels (CKPT_RUNS), every leaf of the loaded trees is
    torch.equal to the reference built in memory (ckpt_reference), the JSONL
    records equal the reference engine's and the first-step logits agree
    within CKPT_LOGITS_TOL; and unless a checkpoint with layer 0's q_proj
    written untransposed fails the tree check and the logits check."""
    import torch
    from revisionllm_tpu_torch.config import LlamaConfig
    from revisionllm_tpu_torch.eval import loader, stage1
    from revisionllm_tpu_torch.eval import metrics as M
    from revisionllm_tpu_torch.eval.engine import GroundingEngine
    from revisionllm_tpu_torch.utils import kernels

    cfg = LlamaConfig(num_layers=CKPT_LAYERS)
    root = os.path.join(tmp, "checkpoint")
    base, stage = os.path.join(root, "vicuna"), os.path.join(root, "stage")
    common = pipeline_files(os.path.join(root, "inputs"), movie)
    qf_np = np.load(os.path.join(root, "inputs", "queries", "q0.npz"))["token_features"]

    def argv(model_base, log):
        return stage1.parse_args(common + ["--model_base", model_base, "--stage2", stage,
                                           "--log_path", os.path.join(root, log)] + S1_FLAGS)

    t0 = time.perf_counter()
    tree = ckpt_tree(cfg, dev)
    t1 = time.perf_counter()
    nbytes = write_checkpoint(base, cfg, tree)
    t2 = time.perf_counter()
    acfg = loader.adapter_cfg_from_args(argv(base, "unused")).with_hidden(cfg.hidden_size)
    lora, lora_cfg, vision = write_stage_dir(stage, cfg, acfg)
    say(f"checkpoint: Vicuna-7B width, {CKPT_LAYERS} layers: tree drawn on the card from seed 0 "
        f"in {t1 - t0:.2f} s; written as 2 fp16 .safetensors shards and config.json, "
        f"{nbytes / 1e9:.3f} GB in {t2 - t1:.2f} s ({nbytes / 1e9 / (t2 - t1):.2f} GB/s); "
        f"stage directory (LoRA r 64 on q/k/v/o, ClipEncoder T2V 768/8/2/2048) through the "
        f"port's exporter in {time.perf_counter() - t2:.2f} s")
    t0 = time.perf_counter()
    ref_np = ckpt_reference(tree, lora, lora_cfg)
    say(f"checkpoint: the reference tree built in memory (merge, bf16, quantize) in "
        f"{time.perf_counter() - t0:.2f} s")
    old_quant = os.environ.pop("REVISIONLLM_QUANT", None)
    try:
        for label, run in CKPT_RUNS.items():
            with switched(run["env"]):
                args = argv(base, f"log_{label}")
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                with LoadClock() as clock:
                    t0 = time.perf_counter()
                    eng = loader.build_engine_from_args(args, tokenizer=fake_tokenizer())
                    torch.cuda.synchronize()
                    total = time.perf_counter() - t0
                sec = clock.seconds
                kernels.reset_launches()
                with _CountIntMM() as int_mm:
                    stats = stage1.run(args, eng)
                    torch.cuda.synchronize()
                launches = dict(kernels.LAUNCHES)
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
                convert = sec["load_pretrained"] - sec["read"] - sec["merge"]
                say(f"checkpoint ({label}, switches {run['env'] or 'none'}): "
                    f"build_engine_from_args {total:.2f} s: read {sec['read']:.2f} s "
                    f"({nbytes / 1e9 / sec['read']:.2f} GB/s, from the page cache after the "
                    f"write), convert and round to bf16 {convert:.2f} s, merge {sec['merge']:.2f} "
                    f"s, quantize {sec['quantize']:.2f} s, pack {sec['pack']:.2f} s, "
                    f"host-to-device {sec['to device']:.2f} s; stage1.run {stats}; peak device "
                    f"memory {peak:.2f} GiB")
                say(f"checkpoint ({label}): launches in stage1.run: "
                    + str({k: n for k, n in launches.items() if n}) + f", torch._int_mm {int_mm.n}")
                missing = [k for k in run["kernels"] if launches[k] == 0]
                if missing or int_mm.n or stats["done"] != PIPE_QUERIES or stats["errors"]:
                    raise AssertionError(f"checkpoint ({label}): {stats}, never launched {missing}, "
                                         f"torch._int_mm x{int_mm.n}")

                ref_params, ref_vision = as_loaded(ref_np, vision, label == "serve")
                bad = tree_mismatches(eng.params, ref_params) + \
                    tree_mismatches(eng.vision_params, ref_vision)
                ref = GroundingEngine(cfg, eng.adapter_cfg, _to(ref_params, dev),
                                      _to(ref_vision, dev), fake_tokenizer(), eng.eval_cfg,
                                      device=dev)
                ref_args = argv(base, f"log_{label}_reference")
                stage1.run(ref_args, ref)
                same = same_records(M.load_prediction_logs(args.log_path, 1),
                                    M.load_prediction_logs(ref_args.log_path, 1))
                err = rel_l2(first_step_logits(eng, movie, qf_np),
                             first_step_logits(ref, movie, qf_np))
                n = len(_named_leaves(ref_params)) + len(_named_leaves(ref_vision))
                say(f"checkpoint ({label}): loaded tree against the one built in memory: "
                    f"{n - len(bad)} of {n} leaves torch.equal; JSONL records "
                    f"{'equal' if same else 'DIFFER'}; first-step logits relative L2 {err:.3e} "
                    f"(tol {CKPT_LOGITS_TOL})")
                if bad or not same or not err <= CKPT_LOGITS_TOL:
                    raise AssertionError(f"checkpoint ({label}): leaves differ {bad[:8]}, "
                                         f"records equal {same}, logits {err}")
                if label == "standard":
                    faulty = os.path.join(root, "vicuna_fault")
                    write_checkpoint(faulty, cfg, tree, fault=True, shard2=os.path.join(
                        base, "model-00002-of-00002.safetensors"))
                    del eng
                    torch.cuda.empty_cache()
                    eng = loader.build_engine_from_args(argv(faulty, "log_fault"),
                                                        tokenizer=fake_tokenizer())
                    bad = tree_mismatches(eng.params, ref_params)
                    err = rel_l2(first_step_logits(eng, movie, qf_np),
                                 first_step_logits(ref, movie, qf_np))
                    say(f"checkpoint (planted fault: layer 0's q_proj written untransposed): "
                        f"leaves that differ {bad}; first-step logits relative L2 {err:.3e}")
                    if not bad or err <= CKPT_LOGITS_TOL:
                        raise AssertionError("checkpoint: the planted fault passed a check")
                del eng, ref, ref_params, ref_vision
                torch.cuda.empty_cache()
    finally:
        if old_quant is not None:
            os.environ["REVISIONLLM_QUANT"] = old_quant



# ------------------------------------------------------------------ phase 15

SURF_FRAMES = 100           # a chat's window: 100 frames x 768, as demo.load_video_features
SURF_TOKENS = 64            # max_new_tokens of inference, the stream, the chat and captions
SURF_BATCH = 8              # inference's window batch with return_list
SURF_CPU_TOKENS = 8         # greedy tokens of the card-against-CPU inference at 2 layers
SURF_BUSY_STEPS = 16        # the stream's decode steps profiled for its busy time (a whole
                            # stream's 63 take torch.profiler about 30 s to collect)
SURF_QUESTIONS = ("what happens in the video?", "and what happens after that?")
SURF_PROMPT = "<video>\n" + SURF_QUESTIONS[0]   # the chat's first turn, as ChatSession asks it
T2V_VIDEOS = 1000           # MSR-VTT 1k-A: 1000 test clips, one query each
T2V_QUERIES = 3             # the queries run: split 0 of T2V_VIDEOS // T2V_QUERIES splits
T2V_FRAMES = (30, 90)       # a clip's feature track before linspace sampling to 100 frames
T2V_CPU_VIDEOS = 100        # the card-against-CPU retrieve_videos: one pass
T2V_FLAGS = ["--num_frames", "100", "--batch", "100", "--max_new_tokens", "8",
             "--debug", "True"]
SURF_TRAIN_STEPS = 3        # timed steps of training from the checkpoint, after one warm-up


def chat_geometry():
    """(positions, live) of the chat's prompt cache: SURF_PROMPT over a
    SURF_FRAMES window as inference and inference_stream plan it for
    SURF_TOKENS new tokens (the prompt's rows, padded by the tokens and 8),
    and the live prompt length."""
    from revisionllm_tpu_torch import inference

    live = len(inference._prompt_ids(fake_tokenizer(), SURF_PROMPT, None)) - 1 + SURF_FRAMES
    return live + SURF_TOKENS + 8, live


def bf16_spacing(x):
    """The gap between two neighbouring bf16 values at magnitude x."""
    return math.ldexp(1.0, math.frexp(abs(x))[1] - 8) if x else 0.0


def hold_steps(label, card, cpu, rel=5e-2):
    """Hold a greedy decode's logits on the card (`card`, LogitTrace.steps:
    the prefill's, then each decode step's) against the CPU's: the same
    number of steps, each step's logits within `rel` of its largest
    magnitude (at least `rel`), and the greedy tokens (each row's argmax)
    equal, so that every step runs on the same inputs on both sides. A
    greedy token may differ only at a tie: where on each side the two
    tokens' logits lie within two bf16 steps of each other (the lm_head
    rounds them to bf16). The steps after such a tie run on other tokens
    and are not held. Raises at the first step that breaks a rule, with the
    top-2 logits of both sides in the row that differs. Returns (the worst
    held step's max abs difference, its tolerance, None or (the step of the
    tie, the card's top-2, the CPU's top-2))."""
    if len(card) != len(cpu):
        raise AssertionError(f"{label}: {len(card)} decode steps on the card, {len(cpu)} on "
                             f"the CPU")
    worst = (0.0, 1.0)
    for k, (a, b) in enumerate(zip(card, cpu)):
        diff = (a - b).abs().max().item()
        tol = rel * max(1.0, b.abs().max().item())
        if not diff <= tol:
            raise AssertionError(f"{label}: step {k}: logits max_abs_diff {diff:.4e} > tol "
                                 f"{tol:.3e}")
        if diff * worst[1] >= worst[0] * tol:
            worst = (diff, tol)
        rows = (a.argmax(-1) != b.argmax(-1)).nonzero().flatten().tolist()
        for r in rows:
            ta, tb = int(a[r].argmax()), int(b[r].argmax())
            gaps = (a[r, ta] - a[r, tb]).item(), (b[r, tb] - b[r, ta]).item()
            steps = [2 * bf16_spacing(max(abs(x[r, ta].item()), abs(x[r, tb].item())))
                     for x in (a, b)]
            if any(g > s for g, s in zip(gaps, steps)):
                raise AssertionError(
                    f"{label}: step {k}: greedy tokens differ beyond a tie in row {r} (logit "
                    f"gaps {gaps}, two bf16 steps {steps}); top-2: card {top2(a[r])}, CPU "
                    f"{top2(b[r])}")
        if rows:
            return worst + ((k, top2(a[rows[0]]), top2(b[rows[0]])),)
    return worst + (None,)


def hold_sharded(label, steps, want, res, ref, exact, offset=0, rel=5e-2):
    """Phase 19's hold of a sharded chunk against the one-rank run: `steps`
    (LogitTrace.steps) are this rank's logits a decode step, `want` the
    one-rank run's at this rank's rows (from global row `offset`), `res`
    ground_windows' result (whole on every rank), `ref` the one-rank
    answers and entropies.

    `exact`, a mesh without tensor parallelism (each rank runs whole rows
    through the same kernels; the batch and fsdp gathers copy): every
    step's logits (so every greedy token), the answers and the entropies
    bit-identical. Otherwise the tensor ranks sum their partial products in
    another order: every step's logits within `rel` of its largest
    magnitude on the rows not yet tied; a greedy token may differ only at a
    tie (hold_steps' rule, widened by the step's max abs difference), and
    that row leaves the hold from the next step, since it then decodes other
    tokens; the untied windows' answers equal and their entropies within
    `rel` relative. Raises at the first break; returns {"diff", "tol",
    "ties": [(step, row)], "entropy_diff", "answers_equal"}."""
    import torch

    if len(steps) != len(want):
        raise AssertionError(f"{label}: {len(steps)} decode steps, {len(want)} on one rank")
    got_ent, ref_ent = (np.asarray(x, np.float64) for x in (res["scores_entropy"], ref["entropy"]))
    if exact:
        for k, (a, b) in enumerate(zip(steps, want)):
            if not torch.equal(a, b):
                raise AssertionError(f"{label}: step {k}: logits differ from one rank's by "
                                     f"{(a - b).abs().max().item():.4e}; without tensor "
                                     f"parallelism they must be equal")
        if res["answers"] != ref["answers"] or not np.array_equal(got_ent, ref_ent):
            raise AssertionError(f"{label}: answers or entropies differ from one rank's")
        return {"diff": 0.0, "tol": 0.0, "ties": [], "entropy_diff": 0.0,
                "answers_equal": True}
    live = torch.ones(want[0].shape[0], dtype=torch.bool)
    worst, ties = (0.0, 1.0), []
    for k, (a, b) in enumerate(zip(steps, want)):
        rows = live.nonzero().flatten()
        diff = (a[rows] - b[rows]).abs().max().item()
        tol = rel * max(1.0, b[rows].abs().max().item())
        if not diff <= tol:
            raise AssertionError(f"{label}: step {k}: logits max_abs_diff {diff:.4e} > tol "
                                 f"{tol:.3e}")
        if diff * worst[1] >= worst[0] * tol:
            worst = (diff, tol)
        for r in rows[a[rows].argmax(-1) != b[rows].argmax(-1)].tolist():
            ta, tb = int(a[r].argmax()), int(b[r].argmax())
            gaps = (a[r, ta] - a[r, tb]).item(), (b[r, tb] - b[r, ta]).item()
            limit = [2 * bf16_spacing(max(abs(x[r, ta].item()), abs(x[r, tb].item()))) + diff
                     for x in (a, b)]
            if any(g > s for g, s in zip(gaps, limit)):
                raise AssertionError(
                    f"{label}: step {k}: greedy tokens differ beyond a tie in row {r} (logit "
                    f"gaps {gaps}, limits {limit}); top-2: sharded {top2(a[r])}, one rank "
                    f"{top2(b[r])}")
            ties.append((k, r))
            live[r] = False
    held = [offset + r for r in live.nonzero().flatten().tolist()
            if offset + r < len(ref["answers"])]
    ent = float(np.abs(got_ent[held] - ref_ent[held]).max()) if held else 0.0
    for w in held:
        if res["answers"][w] != ref["answers"][w]:
            raise AssertionError(f"{label}: window {w} (no tie) answers {res['answers'][w]!r}, "
                                 f"one rank {ref['answers'][w]!r}")
        if not abs(got_ent[w] - ref_ent[w]) <= rel * abs(ref_ent[w]):
            raise AssertionError(f"{label}: window {w} (no tie) entropy {got_ent[w]}, one "
                                 f"rank {ref_ent[w]}")
    return {"diff": worst[0], "tol": worst[1], "ties": ties, "entropy_diff": ent,
            "answers_equal": res["answers"] == ref["answers"]}


def top2(logits):
    """((value, id), (value, id)) of the two largest entries of a 1-D row."""
    v, i = logits.float().topk(2)
    return tuple((round(float(a), 4), int(b)) for a, b in zip(v, i))


def first_divergence(streamed, batch_tokens, eos_id):
    """The first step where the streamed token ids differ from a batch row's
    greedy tokens cut at its first eos (the stream yields no eos), or None
    when they agree at every step."""
    batch = list(batch_tokens)
    if eos_id in batch:
        batch = batch[: batch.index(eos_id)]
    for i, (a, b) in enumerate(zip(streamed, batch)):
        if a != b:
            return i
    return None if len(streamed) == len(batch) else min(len(streamed), len(batch))


class LogitTrace:
    """While inside, records the logits that every llama.prefill_kv call
    and every decode step returns (f32, on the CPU): `steps[k]` is the
    [B, V] logits that choose decode step k's token. A decode step is a
    llama.decode_step_split call, or on the card a generation.DecodeGraphs
    step (eager, captured or replayed), read when it returns: the split
    step inside it is not recorded again, and a capture reads nothing on
    the host."""

    def __enter__(self):
        from revisionllm_tpu_torch.models import generation, llama

        self.steps, self.depth = [], 0
        self.orig = (llama.prefill_kv, llama.decode_step_split, generation.DecodeGraphs.step)

        def wrap(fn, logits):
            def spy(*a, **k):
                self.depth += 1
                try:
                    out = fn(*a, **k)
                finally:
                    self.depth -= 1
                if not self.depth:
                    self.steps.append(logits(out).float().cpu())
                return out
            return spy

        llama.prefill_kv = wrap(self.orig[0], lambda out: out[0])
        llama.decode_step_split = wrap(self.orig[1], lambda out: out[0])
        generation.DecodeGraphs.step = wrap(self.orig[2], lambda out: out)
        return self

    def __exit__(self, *exc):
        from revisionllm_tpu_torch.models import generation, llama

        llama.prefill_kv, llama.decode_step_split, generation.DecodeGraphs.step = self.orig


def write_t2v_corpus(root, n_videos=T2V_VIDEOS, n_queries=T2V_QUERIES, d=768, seed=0,
                     frames=T2V_FRAMES):
    """An eval set at MSR-VTT 1k-A's geometry under `root`, from `seed`: a
    feature store of `n_videos` clip tracks (video{i}.npy, [n, d] f32 with n
    drawn in `frames`), the queries in msrvtt.load_queries' JSON layout (one
    per clip, the 1k-A protocol) and the query features (25 token features
    and a CLS) of the first `n_queries`. Returns (msrvtt's input flags, the
    track lengths)."""
    rng = np.random.default_rng(seed)
    feats, qdir = os.path.join(root, "feats"), os.path.join(root, "queries")
    os.makedirs(feats)
    os.makedirs(qdir)
    lengths = rng.integers(frames[0], frames[1] + 1, size=n_videos)
    queries = {}
    for i, n in enumerate(lengths):
        np.save(os.path.join(feats, f"video{i}.npy"), rng.normal(size=(n, d)).astype(np.float32))
        queries[f"q{i}"] = {"video": f"video{i}", "sentence": f"{SENTENCE} in clip {i}."}
    for i in range(n_queries):
        np.savez(os.path.join(qdir, f"q{i}.npz"),
                 token_features=rng.normal(size=(25, d)).astype(np.float32),
                 cls_features=rng.normal(size=(d,)).astype(np.float32))
    path = os.path.join(root, "queries.json")
    with open(path, "w") as f:
        json.dump(queries, f)
    return ["--data_path", path, "--feat_folder", feats, "--q_feat_dir", qdir], lengths


def t2v_engine(dev, cfg, params, args, seed=2):
    """The pipeline's stage-2 engine for msrvtt's `args`: the hierarchy cls
    T2V adapter from `seed` over `params`, the eval configuration of the
    flags (batch 100, max_new_tokens 8)."""
    import torch
    from revisionllm_tpu_torch.eval import loader
    from revisionllm_tpu_torch.eval.engine import GroundingEngine
    from revisionllm_tpu_torch.models import revisionllm

    acfg = loader.adapter_cfg_from_args(args).with_hidden(cfg.hidden_size)
    vision = revisionllm.init_vision_params(acfg, seed=seed, d_in=acfg.d_model,
                                            dtype=torch.bfloat16, device=dev)
    return GroundingEngine(cfg, acfg, params, vision, fake_tokenizer(),
                           loader.eval_cfg_from_args(args), device=dev)


def t2v_stack(args, n):
    """The first `n` candidates of the store as msrvtt.run samples them:
    [n, num_frames, d]."""
    from revisionllm_tpu_torch.data.feature_store import open_feature_store

    store = open_feature_store(args.feat_folder)
    out = []
    for i in range(n):
        feats = store.get(f"video{i}")
        out.append(feats[np.linspace(0, feats.shape[0] - 1, args.num_frames, dtype=np.int32)])
    return np.stack(out)


def stream_busy(parts, image, question, qf, qv, steps=SURF_BUSY_STEPS):
    """The device's busy ms and the launches of one decode token of
    inference_stream, from the stream itself: the stream closed after
    1 + `steps` tokens under torch.profiler, less the stream closed after
    its first token (the same prompt and prefill), over its `steps` decode
    steps (fewer where it ends sooner). Returns (busy ms, launches by
    kernel, decode steps)."""
    import itertools

    from revisionllm_tpu_torch import inference
    from revisionllm_tpu_torch.utils import kernels

    def stream(n):
        it = inference.inference_stream(*parts, image, question, qf, qv,
                                        max_new_tokens=SURF_TOKENS)
        count = len(list(itertools.islice(it, n)))
        it.close()
        return count

    runs = []
    for n in (1, 1 + steps):
        kernels.reset_launches()
        count, ms, _ = profiled(lambda: stream(n))
        runs.append((count, ms, dict(kernels.LAUNCHES)))
    (_, first_ms, first), (count, ms, whole) = runs
    steps = max(count - 1, 1)
    launches = {k: (v - first.get(k, 0)) / steps for k, v in whole.items()
                if v > first.get(k, 0)}
    return (ms - first_ms) / steps, launches, steps


def counted(fn):
    """(fn(), the device's launches by kernel (DeviceLaunches), torch._int_mm
    calls, wall ms from an idle device to the end of fn's device work,
    under the profiler)."""
    with DeviceLaunches() as seen, _CountIntMM() as int_mm:
        out, ms = timed_ms(fn)
    return out, {k: n for k, n in seen.launches.items() if n}, int_mm.n, ms


def stream_once(parts, image, question, qf, qv):
    """inference_stream once: (the yielded strings, the streamed token ids,
    ms from the call to the first token, the wall ms between each two
    tokens)."""
    import torch
    from revisionllm_tpu_torch import inference
    from revisionllm_tpu_torch.models import generation

    toks, marks = [], []
    inner = generation.generate_stream

    def spy(*a, **k):
        for t in inner(*a, **k):
            toks.append(t)
            marks.append(time.perf_counter())
            yield t

    generation.generate_stream = spy
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        texts = list(inference.inference_stream(*parts, image, question, qf, qv,
                                                max_new_tokens=SURF_TOKENS))
    finally:
        generation.generate_stream = inner
    return texts, toks, (marks[0] - t0) * 1e3, list(np.diff(marks) * 1e3)


def phase_surfaces(dev, setup, tmp):
    """The serving surfaces through the entry points a user calls, at
    Vicuna-7B width and depth on the slice's int8 weights: inference (B 1,
    then B 8 with return_list), inference_stream (its tokens against the
    batch path's), the web demo over HTTP on the loopback against
    ChatSession.ask, caption_windows over the 1-hour movie, msrvtt.run over
    a 1k-A-shaped corpus (3 queries), then inference and retrieve_videos on
    the card against the CPU at 2 layers."""
    import dataclasses
    import urllib.parse
    import urllib.request

    import torch
    from revisionllm_tpu_torch import demo, inference, webdemo
    from revisionllm_tpu_torch.eval import msrvtt
    from revisionllm_tpu_torch.eval.engine import GroundingEngine

    eng, movie, qf_np, _ = setup
    cfg = eng.llama_cfg
    parts_s = {"start": time.perf_counter()}
    root = os.path.join(tmp, "surfaces")
    os.makedirs(root)
    rng = np.random.default_rng(15)
    window = rng.normal(size=(SURF_FRAMES, 768)).astype(np.float32)
    window_path = os.path.join(root, "window.npy")
    np.save(window_path, window)
    qf1 = qf_np[None]
    qv1 = np.ones(qf1.shape[:2], bool)

    def parts():
        return cfg, eng.adapter_cfg, eng.params, eng.vision_params, fake_tokenizer()

    # 1. inference, B 1 and B 8
    from revisionllm_tpu_torch.ops.quant import KERNEL_MAX_M

    prompt_len = chat_geometry()[0]
    outs = {}
    for B in (1, SURF_BATCH):
        image = window[None] if B == 1 else rng.normal(size=(B, SURF_FRAMES, 768)).astype(
            np.float32)
        qf, qv = np.repeat(qf1, B, 0), np.repeat(qv1, B, 0)

        def call():
            return inference.inference(*parts(), image, SURF_PROMPT, qf, qv,
                                       max_new_tokens=SURF_TOKENS, return_list=B > 1)

        call()
        torch.cuda.reset_peak_memory_stats()
        (answers, out), launches, int_mm, ms = counted(call)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        rows = B * prompt_len
        ent = out["entropy"].float()
        say(f"surfaces: inference B={B} ({SURF_FRAMES} frames x 768, {SURF_TOKENS} greedy "
            f"tokens; the prefill's {rows} rows take "
            f"{'K1' if rows <= KERNEL_MAX_M else 'W8A8'}): wall {ms:.1f} ms, "
            f"{ms / SURF_TOKENS:.2f} ms a token; peak memory {peak:.2f} GiB; launches "
            f"{launches}, torch._int_mm {int_mm}")
        missing = [k for k in SERVING if k not in launches]
        if B * prompt_len > KERNEL_MAX_M:
            missing += [k for k in W8A8 if k not in launches]
        ok = (isinstance(answers, str) if B == 1 else len(answers) == B) and \
            tuple(ent.shape) == (B, SURF_TOKENS) and bool(ent.isfinite().all())
        if missing or int_mm or not ok:
            raise AssertionError(f"inference B={B}: never launched {missing}, torch._int_mm "
                                 f"x{int_mm}, output ok {ok}")
        outs[B] = (answers, out)

    parts_s["inference"] = time.perf_counter()

    # 2. inference_stream against the batch path
    answer1, out1 = outs[1]
    texts, toks, ttft, gaps = stream_once(parts(), window[None], SURF_PROMPT, qf1, qv1)
    per_tok = float(np.mean(gaps))
    batch_toks = out1["tokens"][0].tolist()
    at = first_divergence(toks, batch_toks, 2)
    say(f"surfaces: inference_stream B=1: {len(toks)} tokens; time to the first token "
        f"{ttft:.1f} ms, then {per_tok:.2f} ms a token (wall); final string equals inference's "
        f"answer: {texts[-1] == answer1}; streamed tokens equal generate's greedy tokens: "
        f"{at is None}")
    if at is not None or texts[-1] != answer1:
        with LogitTrace() as s_trace:
            list(inference.inference_stream(*parts(), window[None], SURF_PROMPT, qf1, qv1,
                                            max_new_tokens=SURF_TOKENS))
        with LogitTrace() as b_trace:
            inference.inference(*parts(), window[None], SURF_PROMPT, qf1, qv1,
                                max_new_tokens=SURF_TOKENS)
        k = at or 0
        raise AssertionError(f"stream and batch differ at step {k}: top-2 streamed "
                             f"{top2(s_trace.steps[k][0])}, batch {top2(b_trace.steps[k][0])}")
    busy, launches, n = stream_busy(parts(), window[None], SURF_PROMPT, qf1, qv1)
    wall = float(np.mean(gaps[:n]))
    say(f"surfaces: inference_stream's decode token at B=1 (a split decode step, the argmax "
        f"read back and the text decoded), its first {n} decode steps: wall {wall:.2f} ms (the "
        f"stream above), device busy {busy:.3f} ms (the stream closed after {n + 1} tokens "
        f"under the profiler, less the one closed after its first; idle share "
        f"{max(0.0, 1 - busy / wall) * 100:.1f}%); launches a token {launches}")
    if launches.get("int8_matmul", 0) != 7 * cfg.num_layers + 1 or \
            launches.get("decode_attention", 0) != cfg.num_layers or \
            n != min(SURF_BUSY_STEPS, len(toks) - 1):
        raise AssertionError(f"the B=1 step left K1 or K3: {launches} over {n} steps")

    parts_s["stream"] = time.perf_counter()

    # 3. the web demo over HTTP on the loopback
    def make_session(path):
        return demo.ChatSession(parts(), demo.load_video_features(path),
                                max_new_tokens=SURF_TOKENS)

    srv = webdemo.DemoServer(make_session, host="127.0.0.1", port=0)
    srv.start_background()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        with open(window_path, "rb") as f:
            req = urllib.request.Request(base + "/api/video?name=window.npy", data=f.read(),
                                         method="POST")
        status = json.loads(urllib.request.urlopen(req, timeout=120).read())["status"]
        streamed, turn_ms = [], []
        for q in SURF_QUESTIONS:
            t0 = time.perf_counter()
            with urllib.request.urlopen(f"{base}/api/ask?q={urllib.parse.quote(q)}",
                                        timeout=300) as resp:
                events = [line.decode().strip()[6:] for line in resp
                          if line.startswith(b"data: ")]
            turn_ms.append((time.perf_counter() - t0) * 1e3)
            if events[-1] != "[DONE]":
                raise AssertionError(f"web demo: the stream did not end: {events[-3:]}")
            streamed.append(json.loads(events[-2]))
    finally:
        srv.shutdown()
    fresh = make_session(window_path)
    asked = [fresh.ask(q) for q in SURF_QUESTIONS]
    say(f"surfaces: web demo on 127.0.0.1:{srv.port}: upload '{status}'; two turns over HTTP "
        f"(server-sent events) in {[round(x, 1) for x in turn_ms]} ms; streamed answers equal "
        f"ChatSession.ask on a fresh session (the second turn with history): {streamed == asked}")
    if streamed != asked or len(fresh.history) != 2:
        raise AssertionError(f"web demo: {streamed!r} != {asked!r}")

    parts_s["web demo"] = time.perf_counter()

    # 4. caption_windows over the 1-hour movie
    cap = GroundingEngine(cfg, eng.adapter_cfg, eng.params, eng.vision_params, fake_tokenizer(),
                          dataclasses.replace(eng.eval_cfg, max_new_tokens=SURF_TOKENS),
                          device=dev)
    cap.caption_windows(movie, movie_key="movie0")
    res, launches, int_mm, ms = counted(lambda: cap.caption_windows(movie, movie_key="movie0"))
    n = len(res["answers"])
    say(f"surfaces: caption_windows over the 1-hour movie: {n} windows in one chunk of "
        f"{cap.eval_cfg.batch}, {SURF_TOKENS} tokens; chunk latency {ms:.1f} ms, q/s "
        f"{1e3 / ms:.4f}; launches {launches}, torch._int_mm {int_mm}")
    missing = [k for k in SERVING + W8A8 if k not in launches]
    if n != 57 or missing or int_mm:
        raise AssertionError(f"caption_windows: {n} answers, never launched {missing}, "
                             f"torch._int_mm x{int_mm}")
    del cap

    parts_s["captions"] = time.perf_counter()

    # 5. msrvtt.run at 1k-A's geometry
    t0 = time.perf_counter()
    flags, lengths = write_t2v_corpus(os.path.join(root, "t2v"), T2V_VIDEOS, T2V_QUERIES)
    say(f"surfaces: t2v corpus of {T2V_VIDEOS} clip tracks ({int(lengths.min())}-"
        f"{int(lengths.max())} frames x 768) and {T2V_QUERIES} queries written in "
        f"{time.perf_counter() - t0:.2f} s")
    log = os.path.join(root, "t2v_log")
    args = msrvtt.parse_args(flags + T2V_FLAGS + [
        "--log_path", log, "--total_split", str(T2V_VIDEOS // T2V_QUERIES), "--split", "0"])
    t2v = t2v_engine(dev, cfg, eng.params, args)
    n_pass = math.ceil(T2V_VIDEOS / t2v.eval_cfg.batch)
    lat, passes = [], []
    retrieve, run_chunk = t2v.retrieve_videos, t2v._run_chunk

    def timed_retrieve(*a, **k):
        passes.append(0)
        out, ms = timed_ms(lambda: retrieve(*a, **k))
        lat.append(ms)
        return out

    def counted_chunk(*a, **k):
        passes[-1] += 1
        return run_chunk(*a, **k)

    t2v.retrieve_videos, t2v._run_chunk = timed_retrieve, counted_chunk
    metrics, launches, int_mm, ms = counted(lambda: msrvtt.run(args, t2v))
    with open(os.path.join(log, "predictions_streaming_0.txt")) as f:
        lines = [json.loads(line) for line in f]
    say(f"surfaces: msrvtt.run, {len(lines)} queries over {T2V_VIDEOS} candidates: per-query "
        f"latency {[round(x, 1) for x in lat]} ms (p50 {float(np.median(lat)):.1f}), passes a "
        f"query {passes}, whole run {ms:.1f} ms; launches {launches}, torch._int_mm {int_mm}; "
        f"R@1/5/10 {metrics.get('R@1')}/{metrics.get('R@5')}/{metrics.get('R@10')}, MedR "
        f"{metrics.get('MedR')} (random weights: not held); chosen candidates per query "
        f"{[len(r['info']['ranked']) for r in lines]}; first answers {lines[0]['answer'][:2]}")
    for r in lines:
        ranked, scores = r["info"]["ranked"], r["info"]["scores"]
        if not (len(set(ranked)) == len(ranked) == len(scores)
                and all(0 <= c < T2V_VIDEOS for c in ranked)
                and np.isfinite(scores).all() and scores == sorted(scores, reverse=True)
                and len(r["answer"]) == n_pass):
            raise AssertionError(f"msrvtt: malformed ranking for {r['query_id']}")
    missing = [k for k in SERVING if k not in launches]
    if len(lines) != T2V_QUERIES or missing or passes != [n_pass] * T2V_QUERIES or \
            not os.path.isfile(os.path.join(log, "result_t2v.json")):
        raise AssertionError(f"msrvtt: {len(lines)} queries, passes {passes}, never launched "
                             f"{missing}, result_t2v.json written "
                             f"{os.path.isfile(os.path.join(log, 'result_t2v.json'))}")
    t2v.retrieve_videos, t2v._run_chunk = retrieve, run_chunk
    planted_t2v_scores(t2v, t2v_stack(args, T2V_VIDEOS), args)
    del t2v
    torch.cuda.empty_cache()

    parts_s["msrvtt"] = time.perf_counter()

    # 6. the card against the CPU at 2 layers
    surfaces_compare(dev, window, qf_np, args)
    parts_s["compare"] = time.perf_counter()
    marks = list(parts_s.items())
    say(f"surfaces: the serving part in {marks[-1][1] - marks[0][1]:.1f} s: "
        + ", ".join(f"{k} {t - marks[i][1]:.1f}" for i, (k, t) in enumerate(marks[1:])))


def planted_t2v_scores(t2v, stack, args):
    """retrieve_videos' scoring on the card with every pass answered: random
    weights rarely answer 'In video N' with a number, so each pass's answer
    is replaced by 'In video p' (p the pass) after its decode. Fails unless
    every pass's candidate is ranked once and the scores equal, within rtol
    1e-4, the inverse mean entropies times the CLS cosines (normalized by
    their largest magnitude) that proposal_cosine_scores gives on the CPU."""
    import torch
    from revisionllm_tpu_torch.eval.similarity import proposal_cosine_scores

    q = np.load(os.path.join(args.q_feat_dir, "q0.npz"))
    read, inv = t2v._read_chunk, []

    def answered(out):
        _, stats = read(out)
        inv.append(1.0 / max(float(stats[0, 2]), 1e-9))
        return [f"In video {len(inv) - 1}"], stats

    t2v._read_chunk = answered
    try:
        res = t2v.retrieve_videos(stack, f"{SENTENCE} in clip 0", q["token_features"],
                                  q["cls_features"], corpus_key="planted")
    finally:
        t2v._read_chunk = read
    batch = t2v.eval_cfg.batch
    chosen = [min(p * batch, len(stack) - batch) + p for p in range(len(inv))]
    frames = torch.from_numpy(stack[chosen])
    cos = proposal_cosine_scores(torch.from_numpy(q["cls_features"]).float(), frames,
                                 torch.ones(frames.shape[:2], dtype=torch.bool), k=3).tolist()
    m = max(abs(c) for c in cos)
    want = sorted(((s * c / m, i) for s, c, i in zip(inv, cos, chosen)), reverse=True)
    ok = res["ranked"] == [i for _, i in want] and np.allclose(
        res["scores"], [s for s, _ in want], rtol=1e-4, atol=0)
    say(f"surfaces: retrieve_videos' scoring with every pass answered (planted 'In video p'): "
        f"{len(res['ranked'])} candidates ranked, scores "
        f"{[round(float(x), 4) for x in res['scores']]}; equal to the inverse entropies x CLS "
        f"cosines on the CPU: {ok}")
    if not ok:
        raise AssertionError(f"planted t2v scores: {res['ranked']} {res['scores']} != {want}")


def surfaces_compare(dev, window, qf_np, t2v_args):
    """inference and one retrieve_videos query with the kernels on the card
    against the plain path on the CPU, at Vicuna-7B width and 2 layers from
    one seed, serving numerics on both (as compare_paths): hold_steps on
    every step's logits (within 5% of the largest, the greedy tokens equal
    but at a bf16 tie; the decode steps run K3 at B 1 on the card); the
    answers printed."""
    import torch
    from revisionllm_tpu_torch import inference
    from revisionllm_tpu_torch.config import AdapterConfig, LlamaConfig
    from revisionllm_tpu_torch.eval import loader
    from revisionllm_tpu_torch.eval.engine import GroundingEngine
    from revisionllm_tpu_torch.models import generation, llama, revisionllm
    from revisionllm_tpu_torch.ops import flash_attention, quant

    cpu = torch.device("cpu")
    cfg = LlamaConfig(num_layers=2)
    acfg = AdapterConfig(clip_adapter_text=True, hierarchy=False, feature_mode="temporal",
                         hidden_size=cfg.hidden_size)
    hcfg = loader.adapter_cfg_from_args(t2v_args).with_hidden(cfg.hidden_size)
    params = llama.init_params(cfg, seed=0, dtype=torch.bfloat16, device=cpu, quantize="int8")
    vis_t = revisionllm.init_vision_params(acfg, seed=1, dtype=torch.bfloat16, device=cpu)
    vis_h = revisionllm.init_vision_params(hcfg, seed=2, dtype=torch.bfloat16, device=cpu)
    stack = t2v_stack(t2v_args, T2V_CPU_VIDEOS)
    q = np.load(os.path.join(t2v_args.q_feat_dir, "q0.npz"))
    qc = q["cls_features"] / np.linalg.norm(q["cls_features"])
    qv = np.ones((1, len(qf_np)), bool)
    quant.set_w8a8(True)
    generation.set_kv8(True)
    flash_attention.set_attn_bf16(False)
    outs = {}
    try:
        for device in (dev, cpu):
            t0 = time.perf_counter()
            p = _to(params, device)
            with LogitTrace() as tr:
                _, out = inference.inference(cfg, acfg, p, _to(vis_t, device), fake_tokenizer(),
                                             window[None], SURF_PROMPT, qf_np[None], qv,
                                             max_new_tokens=SURF_CPU_TOKENS)
            inf = tr.steps
            eng = GroundingEngine(cfg, hcfg, p, _to(vis_h, device), fake_tokenizer(),
                                  loader.eval_cfg_from_args(t2v_args), device=device)
            with LogitTrace() as tr:
                res = eng.retrieve_videos(stack, f"{SENTENCE} in clip 0", q["token_features"], qc)
            outs[device.type] = (inf, (tr.steps, res), time.perf_counter() - t0)
    finally:
        quant.set_w8a8(None)
        generation.set_kv8(None)
        flash_attention.set_attn_bf16(None)
    (ik, (rk, xk), tk), (ip, (rp, xp), tp) = outs[dev.type], outs["cpu"]
    same = sum(a == b for a, b in zip(xk["answers"], xp["answers"]))
    for label, sk, sp, extra in (
            ("inference", ik, ip, ""),
            ("retrieve_videos", rk, rp, f"; answers {same} of {len(xp['answers'])} equal, "
             f"rankings {'equal' if xk['ranked'] == xp['ranked'] else 'differ'}")):
        first = (sk[0] - sp[0]).abs().max().item()
        diff, tol, tie = hold_steps(f"surfaces compare ({label})", sk, sp)
        held = len(sk) if tie is None else tie[0] + 1
        tokens = "greedy tokens equal at every step" if tie is None else (
            f"greedy tokens equal up to step {tie[0]}, a tie there (top-2 card {tie[1]}, CPU "
            f"{tie[2]}): the steps after it run on other tokens and are not held")
        say(f"surfaces compare: {label}, Vicuna-7B width, 2 layers, kernels on the card vs plain "
            f"on the CPU: first-step logits max_abs_diff {first:.4e} (max |logit| "
            f"{sp[0].abs().max().item():.3f}); {held} of {len(sk)} steps' logits held, the worst "
            f"max_abs_diff {diff:.4e} (its tol {tol:.3e}); {tokens}{extra} (both calls: card "
            f"{tk:.1f} s, CPU {tp:.1f} s)")


def phase_surfaces_train(dev, tmp, paths):
    """Training from a checkpoint through train_cli.main: phase 8's flags
    plus --model_base on phase 14's 4-layer Vicuna-width directory and
    --pretrain_clip_adapter on its stage directory's projector, the
    FakeTokenizer, 1 warm-up and SURF_TRAIN_STEPS timed steps. Fails unless
    the losses are finite, row 4's kernels launched, and the assembled base
    equals, leaf for leaf, the loader's tree (load_pretrained without
    rounding, quantize_llama_params_host without the int8 lm_head). Then the
    run's export served: build_engine_from_args and stage1.run on one query."""
    import torch
    from revisionllm_tpu_torch.eval import loader, stage1
    from revisionllm_tpu_torch.eval import metrics as M
    from revisionllm_tpu_torch.models.convert import load_pretrained
    from revisionllm_tpu_torch.models.weights import params_from_numpy
    from revisionllm_tpu_torch.ops.quant import quantize_llama_params_host
    from revisionllm_tpu_torch.train import train_cli
    from revisionllm_tpu_torch.utils import kernels

    t_phase = time.perf_counter()
    ckpt = os.path.join(tmp, "checkpoint")
    base_dir, stage = os.path.join(ckpt, "vicuna"), os.path.join(ckpt, "stage")
    out = os.path.join(tmp, "surfaces_train")
    marks, losses = [], []

    def on_step(step, batch, metrics):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        losses.append(float(metrics["loss"]))
        if step == 1:
            torch.cuda.reset_peak_memory_stats()

    argv = train_argv(paths, out, SURF_TRAIN_STEPS + 1) + [
        "--model_base", base_dir,
        "--pretrain_clip_adapter", os.path.join(stage, "non_lora_trainables.bin")]
    kernels.reset_launches()
    t0 = time.perf_counter()
    run, _ = train_cli.main(argv, on_step=on_step, tokenizer=fake_tokenizer())
    t_end = time.perf_counter()
    launches = {k: kernels.LAUNCHES[k] / (SURF_TRAIN_STEPS + 1) for k in TRAINING}
    steps = np.diff(marks)
    med = float(np.median(steps))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    say(f"surfaces train: train_cli.main from the checkpoint ({run.llama_cfg.num_layers} layers, "
        f"Vicuna-7B width, --quant_base, the stage directory's T2V projector, seq "
        f"{run.train_cfg.model_max_length}, batch 1): load and warm-up step {marks[0] - t0:.2f} "
        f"s; {SURF_TRAIN_STEPS} timed steps ms {[round(float(x) * 1e3, 1) for x in steps]}, "
        f"median {med * 1e3:.1f} ms, {run.train_cfg.model_max_length / med:.1f} padded tokens/s; "
        f"peak memory {peak:.2f} GiB; losses {[round(x, 4) for x in losses]}; row-4 launches a "
        f"step {launches}; save and export {t_end - marks[-1]:.2f} s")
    if not np.isfinite(losses).all() or not all(launches.values()):
        raise AssertionError(f"surfaces train: losses {losses}, row-4 launches {launches}")

    _, ref, _ = load_pretrained(base_dir, run.adapter_cfg)
    ref = params_from_numpy(quantize_llama_params_host(ref, quantize_lm_head=False),
                            torch.device("cpu"), torch.bfloat16)
    bad = tree_mismatches(run.base, ref)
    n = len(_named_leaves(ref))
    say(f"surfaces train: the assembled base against load_pretrained + host quantization: "
        f"{n - len(bad)} of {n} leaves torch.equal")
    if bad:
        raise AssertionError(f"surfaces train: base leaves differ {bad[:8]}")
    del run, ref
    torch.cuda.empty_cache()

    # train -> export -> serve: the run's export through the eval loader, on
    # phase 14's inputs (the 1-hour movie), split 0 of PIPE_QUERIES: 1 query
    inputs = os.path.join(ckpt, "inputs")
    args = stage1.parse_args([
        "--data_path", os.path.join(inputs, "val.json"), "--feat_folder",
        os.path.join(inputs, "feats"), "--q_feat_dir", os.path.join(inputs, "queries"),
        "--debug", "True", "--model_base", base_dir, "--stage2", out, "--log_path",
        os.path.join(tmp, "surfaces_serve"), "--total_split", str(PIPE_QUERIES)] + S1_FLAGS)
    t0 = time.perf_counter()
    eng = loader.build_engine_from_args(args, tokenizer=fake_tokenizer())
    t1 = time.perf_counter()
    kernels.reset_launches()
    stats = stage1.run(args, eng)
    torch.cuda.synchronize()
    served = {k: n for k, n in kernels.LAUNCHES.items() if n}
    logs = M.load_prediction_logs(args.log_path, args.total_split)
    say(f"surfaces train: the export served: build_engine_from_args {t1 - t0:.2f} s, stage1.run "
        f"on 1 query {stats}; launches {served}; the training part in "
        f"{time.perf_counter() - t_phase:.1f} s")
    if stats["done"] != 1 or stats["errors"] or len(logs) != 1 or \
            len(logs[0]["answer"]) != 57 or [k for k in SERVING if k not in served]:
        raise AssertionError(f"surfaces train: the export did not serve: {stats}, {served}")
    del eng
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ phase 16

P16_STEPS = 3               # timed steps of each training configuration, after one warm-up
# stage-2 hierarchy training at TRAIN_STAGE2.json's geometry
# (scripts/train_stage2_sustained.py:76-103): 100 windows x 250 frames a step
STAGE2_FLAGS = ["--preset", "stage2_long_100", "--quant_base", "--per_device_batch_size", "1",
                "--model_max_length", "256"]
# the stage-2 compare's cut: 33 windows of 250 frames (a preset of its own),
# since the CPU side of the adapter over 100 windows does not fit the phase
STAGE2_COMPARE_FLAGS = ["--preset", "stage2_long_33"] + STAGE2_FLAGS[2:]
STREAM_FLAGS = ["--preset", "stage1_stream", "--quant_base", "--per_device_batch_size", "1"]
# the stream compare: gt_multi's memory (the prefix's 24 tokens and 5 memory
# frames: 29 rows), padded to 512, where a clip's 250 frames, the 29 rows and
# its text fit; the CPU side of both losses at the preset's 2048 took 122.6 s
# on the H100's host
STREAM_COMPARE_FLAGS = STREAM_FLAGS + ["--memory_type", "gt_multi", "--model_max_length", "512"]
STREAM_MEMORY_ROWS = 24 + 5
# openai/clip-vit-large-patch14's config.json
VIT_L14 = {"vision": {"layers": 24, "width": 1024, "heads": 16, "mlp": 4096, "patch": 14,
                      "image": 224},
           "text": {"layers": 12, "width": 768, "heads": 12, "mlp": 3072, "vocab": 49408,
                    "positions": 77},
           "projection": 768}
CLIP_STD = 0.02             # the initializer_range of HF's CLIPConfig
VIDEO = {"seconds": 60, "fps": 25, "width": 320, "height": 240}
VIDEO_FPS = 5.0             # feature extraction rate: 300 frames of the 60 s video
CLIP_QUERIES = {"q0": "a man opens the old door", "q1": "two dogs run across a field",
                "q2": "the train leaves the station at night"}
CLIP_CPU_FRAMES = 4         # frames of the card-against-CPU CLIP compare
CLIP_TOL = 1e-4             # relative L2 of each feature, card against CPU, f32 (TF32 off)
DEMO_QUESTION = "what happens in the video?"
DEMO_FRAMES = 100           # demo.load_video_features' linspace frames


@contextlib.contextmanager
def shared_base():
    """Inside, llama.init_params draws each base once: train_cli.assemble's
    later calls with the same arguments get the first one's tree (the
    compares of phase 16 share one 2-layer base on the host)."""
    from revisionllm_tpu_torch.models import llama

    init, memo = llama.init_params, {}

    def once(*args, **kwargs):
        key = repr((args, sorted(kwargs.items())))
        if key not in memo:
            memo[key] = init(*args, **kwargs)
        return memo[key]

    llama.init_params = once
    try:
        yield
    finally:
        llama.init_params = init


def stream_corpus(tmp):
    """The stream corpus at the stage-1 features' geometry: 768-d, 5 fps,
    540 s movies (4 for training, 1 held out)."""
    from revisionllm_tpu_torch.data.synthetic import make_stream_corpus

    return make_stream_corpus(os.path.join(tmp, "stream_corpus"), n_train_movies=4,
                              n_val_movies=1, d=768, fps=5.0, seed=12)


def train16_argv(flags, data, out, steps):
    """train_cli flags: `flags` (the configuration), `data` (the corpus),
    `steps` steps, one save and the export at the end."""
    return flags + data + ["--seed", "0", "--output_dir", out, "--max_steps", str(steps),
                           "--save_steps", str(steps), "--log_steps", "1"]


def batch_windows(batch):
    """(windows, frames) a batch feeds the adapter: a hierarchy batch's B x V
    windows of T frames, a stream batch's two clips, else B windows."""
    frames = sum(int(np.prod(batch[k].shape[:-1])) for k in ("images", "c2_images")
                 if k in batch)
    windows = sum(int(np.prod(batch[k].shape[:-2])) for k in ("images", "c2_images")
                  if k in batch)
    return windows, frames


def timed_train(tag, argv):
    """train_cli.main over `argv` (its last step the export): the first step
    a warm-up, the others timed. Prints the step ms (median), windows/s,
    frames/s, peak memory and each row-4 kernel's launches a step; fails
    unless every loss is finite, all three row-4 kernels ran and no kernel
    without a backward (K1, K2, K3, the W8A8 kernels, torch._int_mm) did. Returns (run,
    optimizer, the last batch, the median loop step in s)."""
    import torch
    from revisionllm_tpu_torch.train import train_cli
    from revisionllm_tpu_torch.utils import kernels

    marks, losses, last = [], [], {}

    def on_step(step, batch, metrics):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        losses.append(float(metrics["loss"]))
        last["batch"] = batch
        if step == 1:
            torch.cuda.reset_peak_memory_stats()

    kernels.reset_launches()
    t0 = time.perf_counter()
    with _CountIntMM() as int_mm:
        run, opt = train_cli.main(argv, on_step=on_step)
    t_end = time.perf_counter()
    n = len(marks)
    launches = {k: v / n for k, v in kernels.LAUNCHES.items() if v}
    steps = np.diff(marks)
    med = float(np.median(steps)) if len(steps) else float("nan")
    windows, frames = batch_windows(last["batch"])
    say(f"{tag}: train_cli.main {argv[1]}, "
        f"{run.llama_cfg.num_layers} layers, int8 base, {run.adapter_cfg.kind} adapter, seq "
        f"{run.train_cfg.model_max_length}, batch {run.train_cfg.per_device_batch_size}, "
        f"{windows} windows / {frames} frames a step; set-up and warm-up step "
        f"{marks[0] - t0:.2f} s; {len(steps)} timed steps ms "
        f"{[round(float(x) * 1e3, 1) for x in steps]}, median {med * 1e3:.1f} ms, "
        f"{windows / med:.1f} windows/s, {frames / med:.1f} frames/s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; losses "
        f"{[round(x, 4) for x in losses]}; launches a step {launches}, torch._int_mm "
        f"{int_mm.n}; save and export {t_end - marks[-1]:.2f} s")
    missing = [k for k in TRAINING if not launches.get(k)]
    stray = {k: launches[k] for k in SERVING + W8A8 if launches.get(k)}
    if not np.isfinite(losses).all() or missing or stray or int_mm.n:
        raise AssertionError(f"{tag}: losses {losses}, row-4 kernels not launched {missing}, "
                             f"kernels without a backward {stray}, torch._int_mm x{int_mm.n}")
    return run, opt, last["batch"], med


def profile_step(tag, dev, run, opt, loop_s):
    """One more train step of `run` on a batch built beforehand, under
    torch.profiler: its wall time, the device's busy time (summed kernel
    time) against it and against the loop step of `loop_s` seconds (which
    builds its batch on the host), and the kernel time by group."""
    import torch
    from revisionllm_tpu_torch.train import trainer

    step_fn = trainer.make_train_step(run.llama_cfg, run.adapter_cfg, run.train_cfg, opt,
                                      stream=run.data_cfg.stream)
    batch = run.batch([0])
    gen = torch.Generator(device=dev).manual_seed(5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, busy, events = profiled(lambda: step_fn(run.trainable, run.frozen, run.base, batch, gen))
    wall = (time.perf_counter() - t0) * 1e3
    groups, _ = group_kernels(events)
    say(f"{tag} profile: one step on a prebuilt batch under the profiler: wall {wall:.1f} ms, "
        f"device busy {busy:.1f} ms (idle share {max(0.0, 1 - busy / wall) * 100:.1f}%); against "
        f"the loop step's {loop_s * 1e3:.1f} ms (its batch built on the host): idle share "
        f"{max(0.0, 1 - busy / (loop_s * 1e3)) * 100:.1f}%; kernel ms by group "
        + str({k: round(ms, 2) for k, (ms, n) in groups.items() if n}))


def prefetch_check(dev, run, opt, steps=P16_STEPS):
    """data/prefetcher.DevicePrefetcher over the run's host batches: the
    batches come out on the device, equal and in order; then `steps` train
    steps fed by run.batch (built and copied in the loop) and `steps` fed by
    the prefetcher (built and copied by its thread during the step before):
    the consumer's wait for each batch, each step's own wall (from its
    batch in hand to its end, which grows if the fill thread holds the
    interpreter while the step enqueues its kernels) and the loop's whole
    time."""
    import torch
    from revisionllm_tpu_torch.data.prefetcher import DevicePrefetcher
    from revisionllm_tpu_torch.train import trainer

    def host(i):
        return {k: torch.from_numpy(np.asarray(v)) for k, v in run.host_batch([i]).items()}

    want = [host(i) for i in range(steps)]
    got = list(DevicePrefetcher(iter(want), device=dev))
    torch.cuda.synchronize()
    if len(got) != steps or any(
            set(g) != set(w) or any(g[k].device.type != dev.type or not torch.equal(g[k].cpu(), w[k])
                                    for k in w) for g, w in zip(got, want)):
        raise AssertionError("prefetcher: the batches differ from their host copies")
    del got
    step_fn = trainer.make_train_step(run.llama_cfg, run.adapter_cfg, run.train_cfg, opt,
                                      stream=run.data_cfg.stream)
    gen = torch.Generator(device=dev).manual_seed(7)

    def loop(batches):
        waits, walls = [], []
        start = t0 = time.perf_counter()
        for b in batches:
            t_in = time.perf_counter()
            waits.append((t_in - t0) * 1e3)
            step_fn(run.trainable, run.frozen, run.base, b, gen)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            walls.append((t0 - t_in) * 1e3)
        return waits, walls, (time.perf_counter() - start) * 1e3

    plain = loop(run.batch([i]) for i in range(steps))
    fed = loop(DevicePrefetcher((host(i) for i in range(steps)), device=dev))
    say(f"prefetcher: {steps} batches through DevicePrefetcher equal to their host copies, on "
        f"the card, in order; run.batch in the loop, then the prefetcher (its first batch has "
        f"nothing to overlap): host wait a step {[round(x, 1) for x in plain[0]]} / "
        f"{[round(x, 1) for x in fed[0]]} ms, the step's own wall "
        f"{[round(x, 1) for x in plain[1]]} / {[round(x, 1) for x in fed[1]]} ms, the loop "
        f"{plain[2]:.1f} / {fed[2]:.1f} ms, a step after the first "
        f"{(plain[2] - plain[0][0] - plain[1][0]) / (steps - 1):.1f} / "
        f"{(fed[2] - fed[0][0] - fed[1][0]) / (steps - 1):.1f} ms")


def clip_shapes(geom):
    """(name, shape, init) of every tensor of a CLIPModel state dict in HF's
    key layout at `geom` (VIT_L14's shape); init is "normal", "zeros",
    "ones" or "logit_scale"."""
    out = []

    def lin(name, dout, din, bias=True):
        out.append((f"{name}.weight", (dout, din), "normal"))
        if bias:
            out.append((f"{name}.bias", (dout,), "zeros"))

    def norm(name, d):
        out.extend([(f"{name}.weight", (d,), "ones"), (f"{name}.bias", (d,), "zeros")])

    def tower(prefix, g):
        d = g["width"]
        for i in range(g["layers"]):
            lp = f"{prefix}.encoder.layers.{i}"
            for m in ("k_proj", "v_proj", "q_proj", "out_proj"):
                lin(f"{lp}.self_attn.{m}", d, d)
            norm(f"{lp}.layer_norm1", d)
            lin(f"{lp}.mlp.fc1", g["mlp"], d)
            lin(f"{lp}.mlp.fc2", d, g["mlp"])
            norm(f"{lp}.layer_norm2", d)

    v, t = geom["vision"], geom["text"]
    out.append(("text_model.embeddings.token_embedding.weight", (t["vocab"], t["width"]),
                "normal"))
    out.append(("text_model.embeddings.position_embedding.weight", (t["positions"], t["width"]),
                "normal"))
    tower("text_model", t)
    norm("text_model.final_layer_norm", t["width"])
    out.append(("vision_model.embeddings.class_embedding", (v["width"],), "normal"))
    out.append(("vision_model.embeddings.patch_embedding.weight",
                (v["width"], 3, v["patch"], v["patch"]), "normal"))
    out.append(("vision_model.embeddings.position_embedding.weight",
                ((v["image"] // v["patch"]) ** 2 + 1, v["width"]), "normal"))
    norm("vision_model.pre_layrnorm", v["width"])
    tower("vision_model", v)
    norm("vision_model.post_layernorm", v["width"])
    lin("visual_projection", geom["projection"], v["width"], bias=False)
    lin("text_projection", geom["projection"], t["width"], bias=False)
    out.append(("logit_scale", (), "logit_scale"))
    return out


def clip_state(geom, dev, seed=0, std=CLIP_STD):
    """A CLIPModel state dict at `geom` (clip_shapes) drawn on `dev` from
    `seed`: weights and embeddings ~ N(0, std^2), zero biases, unit
    LayerNorms, CLIP's logit scale log(1 / 0.07). {name: f32 numpy array}."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for name, shape, init in clip_shapes(geom):
        if init == "normal":
            out[name] = (torch.randn(shape, generator=gen, device=dev) * std).cpu().numpy()
        elif init == "logit_scale":
            out[name] = np.array(np.log(1 / 0.07), np.float32)
        else:
            out[name] = (np.ones if init == "ones" else np.zeros)(shape, np.float32)
    return out


def clip_config(geom):
    """The HF config.json of a CLIPModel at `geom`."""
    v, t = geom["vision"], geom["text"]
    return {
        "architectures": ["CLIPModel"], "model_type": "clip", "projection_dim": geom["projection"],
        "logit_scale_init_value": 2.6592, "initializer_factor": 1.0, "torch_dtype": "float32",
        "text_config": {"model_type": "clip_text_model", "vocab_size": t["vocab"],
                        "hidden_size": t["width"], "intermediate_size": t["mlp"],
                        "num_hidden_layers": t["layers"], "num_attention_heads": t["heads"],
                        "max_position_embeddings": t["positions"], "hidden_act": "quick_gelu",
                        "projection_dim": geom["projection"], "bos_token_id": t["vocab"] - 2,
                        "eos_token_id": t["vocab"] - 1, "pad_token_id": 1},
        "vision_config": {"model_type": "clip_vision_model", "hidden_size": v["width"],
                          "intermediate_size": v["mlp"], "num_hidden_layers": v["layers"],
                          "num_attention_heads": v["heads"], "image_size": v["image"],
                          "patch_size": v["patch"], "hidden_act": "quick_gelu",
                          "projection_dim": geom["projection"]},
    }


def write_clip(path, geom, dev, seed=0):
    """An HF CLIP directory at `geom`: model.safetensors (f32) and
    config.json. Returns the bytes written."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(clip_config(geom), f, indent=2)
    return write_safetensors(os.path.join(path, "model.safetensors"), clip_state(geom, dev, seed))


def clip_tokenize(texts, length=77, vocab=VIT_L14["text"]["vocab"]):
    """A stand-in for CLIP's BPE tokenizer (not in the repository): the
    start token (vocab - 2), one id a word from its CRC-32, the end token
    (vocab - 1, the largest id: encode_text pools at argmax), zeros after."""
    import zlib

    out = np.zeros((len(texts), length), np.int64)
    for i, text in enumerate(texts):
        ids = [vocab - 2] + [1 + zlib.crc32(w.encode()) % (vocab - 3)
                             for w in text.lower().split()][: length - 2] + [vocab - 1]
        out[i, : len(ids)] = ids
    return out


def video_frames(seconds, fps, width, height, seed=0, block=8):
    """uint8 RGB frames [T, H, W, 3] from `seed`: 8 x 8-pixel blocks of
    random colour that drift one block a second."""
    rng = np.random.default_rng(seed)
    T = int(seconds * fps)
    tiles = rng.integers(0, 256, size=(int(seconds) + 1, height // block, width // block + T, 3),
                         dtype=np.uint8)
    out = np.empty((T, height, width, 3), np.uint8)
    for t in range(T):
        sec = int(t // fps)
        src = tiles[sec, :, sec : sec + width // block]
        out[t] = np.repeat(np.repeat(src, block, axis=0), block, axis=1)
    return out


class TimedEncoder:
    """Wraps a ClipFeatureExtractor: times encode_images (its result is
    back on the host, so the device is done) and keeps the first frames'
    pixels for the CPU compare."""

    def __init__(self, inner, keep):
        self.inner, self.keep = inner, keep
        self.seconds, self.frames, self.kept = 0.0, 0, None

    def encode_images(self, pixels):
        t0 = time.perf_counter()
        out = self.inner.encode_images(pixels)
        self.seconds += time.perf_counter() - t0
        self.frames += len(pixels)
        if self.kept is None:
            self.kept = (pixels[: self.keep].copy(), out[: self.keep].copy())
        return out


def phase_clip(dev, tmp):
    """CLIP at ViT-L/14's geometry and the feature tools: a checkpoint
    written from a seed in HF's layout, read by the port's own reader; a
    60 s .y4m at 25 fps, 320 x 240; extract_video_features at 5 fps (300
    frames) and extract_text_features for 3 queries into RVFS stores on the
    card; both stores read back through the native reader and the Python
    one (equal, and open_store_native must take the native route); 4 frames
    and the 3 texts on the card against the CPU at full depth. Returns
    (the CLIP directory, the video, the extractor)."""
    import torch
    from revisionllm_tpu_torch.data import feature_extraction as FE
    from revisionllm_tpu_torch.data.feature_store import RvfsStore
    from revisionllm_tpu_torch.data.native_store import NativeRvfsStore, open_store_native
    from revisionllm_tpu_torch.data.video_reader import write_y4m
    from revisionllm_tpu_torch.models.clip import convert_hf_clip
    from revisionllm_tpu_torch.models.convert import load_hf_llama_state

    root = os.path.join(tmp, "clip")
    clip_dir, video = os.path.join(root, "clip-vit-large-patch14"), os.path.join(root, "movie.y4m")
    t0 = time.perf_counter()
    nbytes = write_clip(clip_dir, VIT_L14, dev)
    t1 = time.perf_counter()
    write_y4m(video, video_frames(**VIDEO), fps=VIDEO["fps"])
    t2 = time.perf_counter()
    state = load_hf_llama_state(clip_dir)
    tree = convert_hf_clip(state)
    del state
    ex = FE.ClipFeatureExtractor(tree, device=dev)
    t3 = time.perf_counter()
    n_params = sum(t.numel() for _, t in _named_leaves(ex.params) if isinstance(t, torch.Tensor))
    say(f"clip: ViT-L/14 geometry ({n_params / 1e6:.1f} M params) written from seed 0 as HF "
        f"model.safetensors + config.json, {nbytes / 1e9:.3f} GB in {t1 - t0:.2f} s; the "
        f".y4m ({VIDEO['seconds']} s, {VIDEO['fps']} fps, {VIDEO['width']} x {VIDEO['height']}, "
        f"{os.path.getsize(video) / 1e6:.1f} MB) in {t2 - t1:.2f} s; read, converted and moved "
        f"to the card in {t3 - t2:.2f} s")

    timed = TimedEncoder(ex, CLIP_CPU_FRAMES)
    store = os.path.join(root, "video.rvfs")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    FE.extract_video_features(timed, {"movie": video}, store, target_fps=VIDEO_FPS)
    t_video = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    text_store = os.path.join(root, "text.rvfs")
    t0 = time.perf_counter()
    FE.extract_text_features(ex, CLIP_QUERIES, clip_tokenize, text_store)
    t_text = time.perf_counter() - t0
    feats = RvfsStore(store).get("movie")
    want_frames = int(round(VIDEO["seconds"] * VIDEO_FPS))
    say(f"clip: extract_video_features at {VIDEO_FPS:g} fps: {timed.frames} frames in "
        f"{t_video:.2f} s, of which decode, sampling, crop and the store "
        f"{t_video - timed.seconds:.2f} s and the encoder {timed.seconds:.2f} s "
        f"({timed.seconds / timed.frames * 1e3:.2f} ms a frame, "
        f"{timed.frames / timed.seconds:.1f} frames/s, batches of {ex.batch_size}); peak memory "
        f"{peak:.2f} GiB; extract_text_features for {len(CLIP_QUERIES)} queries {t_text:.2f} s")
    if feats.shape != (want_frames, VIT_L14["projection"]) or not np.isfinite(feats).all():
        raise AssertionError(f"clip: video features {feats.shape}, finite "
                             f"{np.isfinite(feats).all()}")

    # the stores through the native reader and the Python one
    for path in (store, text_store):
        nat, py = open_store_native(path), RvfsStore(path)
        if not isinstance(nat, NativeRvfsStore):
            raise AssertionError(f"clip: open_store_native took {type(nat).__name__}, not the "
                                 f"native reader")
        for key in py.keys():
            got, want = nat.get_record(key), py.get_record(key)
            if set(got) != set(want) or not all(np.array_equal(got[k], want[k]) for k in want):
                raise AssertionError(f"clip: the native reader differs at {key}")
        nat.close()
    say(f"clip: both stores read back through NativeRvfsStore (build/native/) equal to the "
        f"Python reader, record for record")

    # the card against the CPU at full depth
    t0 = time.perf_counter()
    cpu = FE.ClipFeatureExtractor(tree, device="cpu")
    pixels, card_img = timed.kept
    ids = clip_tokenize(list(CLIP_QUERIES.values()))
    card_txt = ex.encode_texts(ids)
    cpu_img, cpu_txt = cpu.encode_images(pixels), cpu.encode_texts(ids)
    errs = {"image": [float(np.linalg.norm(a - b) / np.linalg.norm(b))
                      for a, b in zip(card_img, cpu_img)]}
    for k in ("cls_features", "token_features"):
        errs[k] = [float(np.linalg.norm(a - b) / np.linalg.norm(b))
                   for a, b in zip(card_txt[k], cpu_txt[k])]
    worst = max(max(v) for v in errs.values())
    say(f"clip compare: ViT-L/14 at full depth, f32, card vs CPU: relative L2 of each feature "
        f"{ {k: [float(f'{e:.2e}') for e in v] for k, v in errs.items()} }, worst {worst:.2e} "
        f"(tol {CLIP_TOL:.0e}) ({time.perf_counter() - t0:.1f} s)")
    if not worst <= CLIP_TOL:
        raise AssertionError(f"clip: the card differs from the CPU by {worst}")
    del cpu, tree
    return clip_dir, video, ex


def demo_answer(argv, tokenizer):
    """demo.main(argv) with one question on stdin: its one answer."""
    import contextlib
    import io

    from revisionllm_tpu_torch import demo

    buf = io.StringIO()
    stdin = sys.stdin
    sys.stdin = io.StringIO(DEMO_QUESTION + "\n\n")
    try:
        with contextlib.redirect_stdout(buf):
            demo.main(argv, tokenizer=tokenizer)
    finally:
        sys.stdin = stdin
    answers = [line.split("assistant> ", 1)[1] for line in buf.getvalue().splitlines()
               if "assistant> " in line]
    if len(answers) != 1:
        raise AssertionError(f"demo: expected one answer, got {buf.getvalue()[-500:]!r}")
    return answers[0]


def recording_tokenizer():
    """fake_tokenizer() that also keeps, in order, each id list it decodes
    (in `.decoded`): the FakeTokenizer decodes most ids to '?', so two
    answers are compared by their ids."""
    tok = fake_tokenizer()
    tok.decoded, decode = [], tok.decode

    def recording(ids, **kwargs):
        tok.decoded.append([int(i) for i in ids])
        return decode(ids, **kwargs)

    tok.decode = recording
    return tok


def phase_raw_video_demo(tmp, clip_dir, video, ex):
    """demo.main from the raw video: --video the .y4m, --clip_path the CLIP
    directory, phase 14's 4-layer checkpoint and stage projector, one
    question on stdin; the DEMO_FRAMES features it encoded against those of
    this function's own decode at 1 fps, linspace sampling and `ex` (the
    card's extractor, held against the CPU in phase_clip), within CLIP_TOL;
    then demo.main on a .npy of the latter. Fails unless the features
    agree, the two runs decode the same token ids, and K1, K2 and K3 ran in
    the first."""
    import torch
    from revisionllm_tpu_torch import demo
    from revisionllm_tpu_torch.data.feature_extraction import (
        decode_frames,
        linspace_sample,
        preprocess_frames,
    )
    from revisionllm_tpu_torch.utils import kernels

    ckpt = os.path.join(tmp, "checkpoint")
    common = ["--model_base", os.path.join(ckpt, "vicuna"), "--pretrain_clip_adapter",
              os.path.join(ckpt, "stage", "non_lora_trainables.bin")]
    seen = []
    load = demo.load_video_features

    def recording(*a, **k):
        seen.append(load(*a, **k))
        return seen[-1]

    demo.load_video_features = recording
    kernels.reset_launches()
    tok_raw, tok_npy = recording_tokenizer(), recording_tokenizer()
    t0 = time.perf_counter()
    try:
        raw = demo_answer(common + ["--video", video, "--clip_path", clip_dir], tok_raw)
    finally:
        demo.load_video_features = load
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = {k: n for k, n in kernels.LAUNCHES.items() if n}
    want = ex.encode_images(preprocess_frames(linspace_sample(decode_frames(video, 1.0),
                                                              DEMO_FRAMES)))
    t2 = time.perf_counter()
    got = seen[0]
    if got.shape != want.shape or want.shape != (DEMO_FRAMES, VIT_L14["projection"]):
        raise AssertionError(f"demo: features {got.shape}, its own decode's {want.shape}")
    err = max(float(np.linalg.norm(a - b) / np.linalg.norm(b)) for a, b in zip(got, want))
    npy = os.path.join(tmp, "clip", "movie_features.npy")
    np.save(npy, want)
    from_npy = demo_answer(common + ["--video", npy], tok_npy)
    t3 = time.perf_counter()
    ids_raw, ids_npy = tok_raw.decoded, tok_npy.decoded
    say(f"demo: demo.main --video the .y4m --clip_path (4-layer Vicuna-width checkpoint, its "
        f"stage projector): {got.shape[0]} frames x {got.shape[1]} features, answer "
        f"{raw[:60]!r} ({len(raw)} chars) in {t1 - t0:.2f} s, launches {launches}; its "
        f"features against this phase's decode at 1 fps, linspace sampling and the card's "
        f"encoder: worst relative L2 {err:.2e} (tol {CLIP_TOL:.0e}, {t2 - t1:.2f} s); "
        f"demo.main on the .npy of those: {sum(map(len, ids_npy))} decoded ids in "
        f"{len(ids_npy)} calls, equal to the raw run's {ids_raw == ids_npy}, answer equal "
        f"{from_npy == raw} ({t3 - t2:.2f} s)")
    missing = [k for k in SERVING if k not in launches]
    if not err <= CLIP_TOL or not ids_raw or ids_raw != ids_npy or from_npy != raw or missing:
        raise AssertionError(f"demo: features {err}, ids {ids_raw} vs {ids_npy}, kernels not "
                             f"launched {missing}")


def phase_rest(dev, tmp, paths, smi):
    """Phase 16, the rest of training and raw video: stage-2 hierarchy
    training (stage2_long_100) and the streaming-memory loss (stage1_stream)
    through train_cli.main at Vicuna-7B width and depth, DevicePrefetcher
    over the stage-2 batches, a train step of each configuration on the
    card against the CPU at 2 layers (stage2_long_33; the stream's double
    loss over gt_multi's 29 memory rows), CLIP at ViT-L/14's geometry with
    the feature tools, and the demo from a raw video. `smi` is the card's
    nvidia-smi name and power limit."""
    import torch

    say(f"phase 16 on {smi}")
    t_phase = time.perf_counter()
    marks = {}
    data2 = ["--data_path", paths["train_json"], "--feat_folder", paths["features"],
             "--q_feat_dir", paths["queries"]]
    run, opt, _, loop_s = timed_train("stage-2 train", train16_argv(
        STAGE2_FLAGS, data2, os.path.join(tmp, "stage2_train"), P16_STEPS + 1))
    profile_step("stage-2 train", dev, run, opt, loop_s)
    prefetch_check(dev, run, opt)
    del run, opt
    torch.cuda.empty_cache()
    marks["stage-2 training"] = time.perf_counter()

    corpus = stream_corpus(tmp)
    data_s = ["--data_path", corpus["train_json"], "--feat_folder", corpus["features"]]
    run, opt, _, _ = timed_train("stream train", train16_argv(
        STREAM_FLAGS, data_s, os.path.join(tmp, "stream_train"), P16_STEPS + 1))
    del run, opt
    torch.cuda.empty_cache()
    marks["stream training"] = time.perf_counter()

    from revisionllm_tpu_torch.models.multimodal import KIND_MEMORY

    with shared_base():
        hold_train_step(dev, train16_argv(STAGE2_COMPARE_FLAGS, data2, "unused", 1),
                        "stage-2 compare")
        batch = hold_train_step(dev, train16_argv(STREAM_COMPARE_FLAGS, data_s, "unused", 1),
                                "stream compare", stream_loss="double")
    rows = (batch["c2_kind"] == KIND_MEMORY).sum(1).tolist()
    say(f"stream compare: gt_multi's visual_memory {tuple(batch['visual_memory'].shape)}, "
        f"memory positions in clip 2's plan {rows}")
    if batch["visual_memory"].shape[1] != 5 or rows != [STREAM_MEMORY_ROWS]:
        raise AssertionError(f"gt_multi: memory rows {rows}")
    marks["compares"] = time.perf_counter()

    clip_dir, video, ex = phase_clip(dev, tmp)
    marks["clip"] = time.perf_counter()
    phase_raw_video_demo(tmp, clip_dir, video, ex)
    del ex
    torch.cuda.empty_cache()
    marks["demo"] = time.perf_counter()
    say_phase(16, t_phase, marks)


# ------------------------------------------------------------------ phase 17

CHAPTERS_WINDOWS = 100      # the chapters_stage2_100 preset's windows (eval batch 100)
CHAPTERS_TOKENS = 8         # max_new_tokens, as the stage-2 pipeline's (S2_FLAGS)
# the card-against-CPU compare's cut: 8 windows of 32 frames (the preset's
# 100 window tokens a pass, 3 passes): the CPU side of the hidden-wide
# adapter over 700 windows of 250 frames would take minutes. At 20 window
# tokens a pass the first-step logits' bf16 noise alone (bf16 against f32
# on the CPU, scripts/torch_chapters_noise.py) is 5.07% of the largest,
# above the 5% limit; at 100, 3.04%
CHAPTERS_CPU = {"windows": 8, "num_frames": 32, "batch": 100}
PHASE17_BUDGET_S, PHASE18_BUDGET_S = 90.0, 120.0
# the alternate train compares: stage2_long_33's hierarchy batches (parity
# 0) and temporal windows of 250 frames (parity 1), padded to 512 where a
# window's 250 frame tokens and its text fit
ALT_COMPARE_FLAGS = STAGE2_COMPARE_FLAGS + ["--model_max_length", "512"]
# each parity once and each self-attention variant once: the CPU sides of
# all four pairs take most of the phase's budget; the CPU tests hold all
# four against JAX
ALT_COMPARES = (("linformer", 0), ("performer", 1))


def chapters_movie(n_windows, ecfg, d, seed):
    """[ctx, d] f32 features from `seed` with exactly `n_windows` stage-2
    windows under `ecfg` (window debug_window x feature_fps frames, stride
    a fifth of it): ctx = (n_windows + 1) strides."""
    step = int(ecfg.debug_window * ecfg.feature_fps) // ecfg.stride
    return np.random.default_rng(seed).standard_normal(((n_windows + 1) * step, d),
                                                       dtype=np.float32)


def chapters_compare(dev, acfg, ecfg, qf, qc):
    """Stage-2 retrieval at the chapters geometry with the kernels on the
    card against the plain path on the CPU, at Vicuna-7B width, 2 layers and
    one seed, cut to CHAPTERS_CPU: the card runs `retrieve`; the same call's
    rows then run on both devices through encode_video (the hidden-wide
    adapter) and prefill_kv, whose first-step logits must agree within 5%
    of the largest."""
    import dataclasses

    import torch
    from revisionllm_tpu_torch.config import LlamaConfig
    from revisionllm_tpu_torch.constants import QUESTIONS
    from revisionllm_tpu_torch.eval.engine import GroundingEngine
    from revisionllm_tpu_torch.models import generation, llama, revisionllm
    from revisionllm_tpu_torch.models.multimodal import build_splice_plan, stack_plans
    from revisionllm_tpu_torch.ops import flash_attention, quant
    from revisionllm_tpu_torch.ops import windows as W

    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    cfg = LlamaConfig(num_layers=2)
    ecfg = dataclasses.replace(ecfg, num_frames=CHAPTERS_CPU["num_frames"],
                               batch=CHAPTERS_CPU["batch"])
    params = llama.init_params(cfg, seed=0, dtype=torch.bfloat16, device=cpu, quantize=True)
    vision = revisionllm.init_vision_params(acfg, seed=2, dtype=torch.bfloat16, device=cpu)
    movie = chapters_movie(CHAPTERS_CPU["windows"], ecfg, cfg.hidden_size, seed=9)
    quant.set_w8a8(True)
    generation.set_kv8(True)
    flash_attention.set_attn_bf16(False)
    out = {}
    try:
        for device in (dev, cpu):
            eng = GroundingEngine(cfg, acfg, _to(params, device), _to(vision, device),
                                  fake_tokenizer(), ecfg, device=device)
            if device == dev:
                res = eng.retrieve(movie, SENTENCE, qf, qc, rng=np.random.default_rng(0))
            row_idx = eng._stage2_passes(eng._stage2_win_idx(len(movie)),
                                         np.random.default_rng(0))[4]
            ids = eng._prompt_ids(SENTENCE, QUESTIONS["retrieval"])
            nv = row_idx[0].shape[0]
            plan_np = stack_plans([build_splice_plan(ids, nv, len(ids) - 1 + nv + 8)]
                                  * len(row_idx))
            plan = {k: torch.as_tensor(v, device=device) for k, v in plan_np.items()}
            images = W.gather_windows(eng._features_to_device(movie),
                                      np.stack(row_idx)).to(torch.bfloat16)
            video = revisionllm.encode_video(acfg, eng.vision_params, images,
                                             *eng._broadcast_query_feats(qf, len(row_idx)))
            embeds, pos, lens = revisionllm.assemble_inputs(eng.params, plan, video,
                                                            dtype=torch.bfloat16)
            logits, _ = llama.prefill_kv(cfg, eng.params, embeds, pos, kv_lens=lens,
                                         kv_quant=True)
            out[device.type] = logits.float().cpu()
            del eng
    finally:
        quant.set_w8a8(None)
        generation.set_kv8(None)
        flash_attention.set_attn_bf16(None)
    card, host = out[dev.type], out["cpu"]
    diff = (card - host).abs().max().item()
    tol = 5e-2 * max(1.0, host.abs().max().item())
    say(f"chapters compare: Vicuna-7B width, 2 layers, {res['num_windows']} windows x "
        f"{ecfg.num_frames} frames of {cfg.hidden_size}-d features, {len(row_idx)} passes of "
        f"{nv} window tokens, kernels on the card vs plain on the CPU: first-step logits "
        f"max_abs_diff {diff:.4e} (tol {tol:.3e}); the card's retrieve answered "
        f"{len(res['answers'])} passes ({time.perf_counter() - t0:.1f} s)")
    if not diff <= tol:
        raise AssertionError(f"chapters logits differ by {diff} > {tol}")


def say_phase(n, t_phase, marks, budget=None):
    """Print phase `n`'s time (against its budget, if given), split at
    `marks` ({part: the time it ended})."""
    last, parts = t_phase, {}
    for k, t in marks.items():
        parts[k] = round(t - last, 1)
        last = t
    within = "" if budget is None else f"budget {budget:.0f} s; "
    say(f"phase {n}: {time.perf_counter() - t_phase:.1f} s ({within}{parts})")


def phase_chapters(dev, paths, smi):
    """Phase 17, the chapters adapter and the adapter's other modes: stage-2
    `retrieve` at the chapters_stage2_100 preset (the cross_attn ClipEncoder
    at the LLM's width, its query through text_proj) over 100 windows of
    250 frames (500 s at 2 fps) of hidden-wide (4096) features from a seed,
    on Vicuna-7B at full width and depth with int8 weights: ms a query, the
    adapter's ms and peak memory over the query's 7 passes, the launches of
    K1, K2 and K3 (each must run); the same at 2 layers against the CPU
    (chapters_compare); then one 'alternate' train step at each parity
    (ALT_COMPARES: the linformer self-attention on the T2V layers at parity
    0, the performer at 1), the card against the CPU at 2 layers by phase
    9's limits. `smi` is the
    card's nvidia-smi name and power limit."""
    import dataclasses

    import torch
    from revisionllm_tpu_torch.config import LlamaConfig, get_preset
    from revisionllm_tpu_torch.models import revisionllm
    from revisionllm_tpu_torch.ops import windows as W

    say(f"phase 17 on {smi}")
    t_phase = time.perf_counter()
    marks = {}
    wl = get_preset("chapters_stage2_100")
    cfg = LlamaConfig()
    acfg = wl.adapter.with_hidden(cfg.hidden_size)
    ecfg = dataclasses.replace(wl.eval, max_new_tokens=CHAPTERS_TOKENS)
    eng = make_engine(cfg, acfg, ecfg, dev, torch.bfloat16, seed=0)
    movie = chapters_movie(CHAPTERS_WINDOWS, ecfg, cfg.hidden_size, seed=7)
    rng = np.random.default_rng(8)
    qf = rng.standard_normal((25, acfg.d_model), dtype=np.float32)
    qc = rng.standard_normal(cfg.hidden_size, dtype=np.float32)
    qc /= np.linalg.norm(qc)
    marks["set-up"] = time.perf_counter()

    def query():
        return eng.retrieve(movie, SENTENCE, qf, qc, rng=np.random.default_rng(0),
                            movie_key="chapters")

    query()  # warm-up
    torch.cuda.reset_peak_memory_stats()
    with DeviceLaunches() as seen:
        res, ms = timed_ms(query)
    launches = {k: n for k, n in seen.launches.items() if n}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    row_idx = eng._stage2_passes(eng._stage2_win_idx(len(movie)), np.random.default_rng(0))[4]
    images = W.gather_windows(eng._features_to_device(movie, "chapters"),
                              np.stack(row_idx)).to(torch.bfloat16)
    q, v = eng._broadcast_query_feats(qf, len(row_idx))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    toks, adapter_ms = timed_ms(lambda: revisionllm.encode_video(acfg, eng.vision_params,
                                                                 images, q, v))
    adapter_gib = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    say(f"chapters: retrieve at chapters_stage2_100 (cross_attn ClipEncoder at d "
        f"{acfg.hidden_size}, text_proj {acfg.d_model} -> {acfg.hidden_size}), Vicuna-7B "
        f"{cfg.num_layers} layers int8, {res['num_windows']} windows x {ecfg.num_frames} frames "
        f"of {movie.shape[1]}-d features ({movie.shape[0]} frames), {len(res['answers'])} "
        f"passes of {row_idx[0].shape[0]} window tokens: {ms:.1f} ms a query, "
        f"{1e3 / ms:.4f} q/s, peak {peak:.2f} GiB; the adapter over "
        f"{int(np.prod(images.shape[:2]))} windows {adapter_ms:.1f} ms, "
        f"{adapter_gib:.2f} GiB above its inputs, tokens {tuple(toks.shape)}; launches "
        f"{launches}")
    missing = [k for k in SERVING if not launches.get(k)]
    if (missing or res["num_windows"] != CHAPTERS_WINDOWS
            or not np.isfinite(res["mean_entropy"]).all()):
        raise AssertionError(f"chapters: kernels not launched {missing}, windows "
                             f"{res['num_windows']}, entropies {res['mean_entropy']}")
    del eng, images, toks, q, v
    torch.cuda.empty_cache()
    marks["retrieve"] = time.perf_counter()
    chapters_compare(dev, acfg, ecfg, qf, qc)
    marks["chapters compare"] = time.perf_counter()
    data2 = ["--data_path", paths["train_json"], "--feat_folder", paths["features"],
             "--q_feat_dir", paths["queries"]]
    with shared_base():
        for kind, parity in ALT_COMPARES:
            hold_train_step(dev, train16_argv(ALT_COMPARE_FLAGS, data2, "unused", 1),
                            f"alternate compare ({kind}, parity {parity})",
                            adapter={"feature_mode": "alternate", "ca_self_attn": kind},
                            data={"clip_adapter_feature": "alternate"},
                            iteration_step=parity)
    marks["alternate compares"] = time.perf_counter()
    say_phase(17, t_phase, marks, PHASE17_BUDGET_S)


# ------------------------------------------------------------------ phase 18

GLM_WORDS = ("when", "does", "the", "dog", "jump", "from", "to", "a", "man", "opens", "old",
             "door", "video", "happen", "it", "two", "cats", "run", "across", "field", "train",
             "leaves", "station", "at", "night", "chapter", "begins", "ends", "scene", "shows")
GLM_PREFIX_STD = 1.0        # the prefix table's std (init 0.02 x 50): keys of unit order


def glm_prompts(tok, n=GLM_B, length=GLM_PROMPT, seed=3):
    """`n` ChatGLM2 prompts from preprocess_glm over `tok` ([gMASK] sop
    <|user|> words ... <|assistant|>), live lengths length, length - 3, ...:
    (ids [n, length] int64 right-padded with 0, lengths [n] int32)."""
    import torch
    from revisionllm_tpu_torch.data.preprocess import preprocess_glm

    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        text = " ".join(rng.choice(GLM_WORDS, length - 3 * i - 4))
        ids = preprocess_glm([{"from": "human", "value": text}], tok)["input_ids"].tolist()
        rows.append(ids[:-1] + [tok.get_command("<|assistant|>")])
    lens = [len(r) for r in rows]
    if max(lens) != length:
        raise AssertionError(f"GLM prompts of {lens} tokens, not up to {length}")
    ids = torch.zeros((n, length), dtype=torch.long)
    for i, r in enumerate(rows):
        ids[i, : len(r)] = torch.as_tensor(r)
    return ids, torch.as_tensor(lens, dtype=torch.int32)


def glm_model(cfg, device, seed=0):
    """ChatGLM2 int8 serving weights from `seed` (llama.init_params, one
    matrix at a time) with q/k/v biases drawn from the seed (N(0, 0.5^2)),
    and a P-tuning prefix table of GLM_PREFIX positions (models/prefix.py,
    its std GLM_PREFIX_STD) on `device`: (params, prefix params)."""
    import torch
    from revisionllm_tpu_torch.models import llama, prefix

    params = llama.init_params(cfg, seed=seed, dtype=torch.bfloat16, device=device,
                               quantize=True)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    for name in ("q_bias", "k_bias", "v_bias"):
        b = params["layers"][name]
        params["layers"][name] = (0.5 * torch.randn(b.shape, generator=gen, device=device)
                                  ).to(b.dtype)
    pp = prefix.init_prefix_params(cfg, GLM_PREFIX, gen, device=device)
    pp["embed"] = pp["embed"] * (GLM_PREFIX_STD / 0.02)
    return params, pp


def glm_compare(dev, cfg, ids, lens, eos_id):
    """generate on ChatGLM2 at full width and 2 layers with the kernels on
    the card against the plain path on the CPU, serving numerics on both,
    with the P-tuning prefix and without: hold_steps on every step's logits
    (within 5% of the largest, greedy tokens equal but at a bf16 tie)."""
    import dataclasses

    import torch
    from revisionllm_tpu_torch.models import generation, llama, prefix
    from revisionllm_tpu_torch.ops import flash_attention, quant

    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    cfg = dataclasses.replace(cfg, num_layers=2)
    params, pp = glm_model(cfg, cpu, seed=4)
    pos = torch.arange(ids.shape[1])[None].expand(ids.shape[0], -1)
    quant.set_w8a8(True)
    generation.set_kv8(True)
    flash_attention.set_attn_bf16(False)
    steps = {}
    try:
        for device in (dev, cpu):
            p = _to(params, device)
            embeds = llama.embed_tokens(p, ids.to(device))
            for label, pkv in (("prefix", prefix.prefix_kv(cfg, _to(pp, device))),
                               ("none", None)):
                with LogitTrace() as tr:
                    generation.generate(cfg, p, embeds, pos.to(device), lens.to(device),
                                        eos_id=eos_id, max_new_tokens=GLM_TOKENS, prefix_kv=pkv)
                steps[(device.type, label)] = tr.steps
    finally:
        quant.set_w8a8(None)
        generation.set_kv8(None)
        flash_attention.set_attn_bf16(None)
    for label in ("prefix", "none"):
        diff, tol, tie = hold_steps(f"GLM compare ({label})", steps[(dev.type, label)],
                                    steps[("cpu", label)])
        say(f"GLM compare ({'P-tuning prefix' if label == 'prefix' else 'no prefix'}): "
            f"ChatGLM2-6B width, 2 layers, B {ids.shape[0]}, {GLM_TOKENS} greedy tokens, "
            f"kernels on the card vs plain on the CPU: worst step's logits max_abs_diff "
            f"{diff:.4e} (tol {tol:.3e}); "
            + ("greedy tokens equal at every step" if tie is None else
               f"first bf16 tie at step {tie[0]}: card {tie[1]}, CPU {tie[2]}"))
    say(f"GLM compare: {time.perf_counter() - t0:.1f} s")


def phase_glm(dev, tmp, smi):
    """Phase 18, ChatGLM2-6B with P-tuning: LlamaConfig.chatglm2_6b() at full
    width and depth (28 layers, hidden 4096, FFN 13696, vocab 65024, 32
    heads over 2 kv heads) with int8 weights and nonzero q/k/v biases from a
    seed, a P-tuning prefix of 128 positions (ChatGLM2-6B's P-tuning v2
    example), 8 prompts of about 300 tokens from preprocess_glm over a
    build_test_model tokenizer written here; generate 12 greedy tokens with
    the prefix and without: prefill and decode-step ms, launches of K1, K2,
    K3 and row 6 (fails unless K3 ran 28 x 11 times, row 6 28 times with
    the prefix and K2 28 times without), peak memory, with the prefix a
    decode step's busy time and K3's share under the profiler; then
    glm_compare."""
    import torch
    from revisionllm_tpu_torch.config import LlamaConfig
    from revisionllm_tpu_torch.models import generation, llama, prefix
    from revisionllm_tpu_torch.tokenization_glm import ChatGLMTokenizer
    from revisionllm_tpu_torch.utils import spm

    say(f"phase 18 on {smi}")
    t_phase = time.perf_counter()
    marks = {}
    path = os.path.join(tmp, "glm_tokenizer.model")
    Path(path).write_bytes(spm.build_test_model(GLM_WORDS))
    tok = ChatGLMTokenizer(path)
    ids, lens = glm_prompts(tok)
    cfg = LlamaConfig.chatglm2_6b()
    params, pp = glm_model(cfg, dev)
    pkv = prefix.prefix_kv(cfg, pp)
    embeds = llama.embed_tokens(params, ids.to(dev))
    pos = torch.arange(ids.shape[1], device=dev)[None].expand(ids.shape[0], -1)
    lens_d = lens.to(dev)
    torch.cuda.synchronize()
    marks["set-up"] = time.perf_counter()
    L, G = cfg.num_layers, GLM_TOKENS
    want = {"prefix": {"flash_attention_prefixed": L, "flash_attention": 0},
            "none": {"flash_attention": L, "flash_attention_prefixed": 0}}
    launched = {}
    for label, p in (("prefix", pkv), ("none", None)):
        def run(p=p):
            return generation.generate(cfg, params, embeds, pos, lens_d, eos_id=tok.eos_token_id,
                                       max_new_tokens=G, prefix_kv=p)

        run()  # warm-up
        torch.cuda.reset_peak_memory_stats()
        with DeviceLaunches() as seen:
            out, ms = timed_ms(run)
        launches = {k: n for k, n in seen.launches.items() if n}
        launched[label] = launches
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        _, pre_ms = timed_ms(lambda: llama.prefill_kv(cfg, params, embeds, pos, kv_lens=lens_d,
                                                      kv_quant=True, prefix_kv=p))
        what = f"P-tuning prefix of {GLM_PREFIX}" if p is not None else "no prefix"
        say(f"GLM generate ({what}): ChatGLM2-6B {L} layers int8, B {ids.shape[0]}, prompts "
            f"{lens.tolist()} tokens, {G} greedy tokens: {ms:.1f} ms, prefill {pre_ms:.1f} ms, "
            f"a decode step {(ms - pre_ms) / (G - 1):.2f} ms (the rest over {G - 1} steps); "
            f"peak {peak:.2f} GiB; launches {launches}; row 0's tokens "
            f"{out['tokens'][0].tolist()}")
        if p is not None:
            # the device's busy time a decode step and K3's share, under the
            # profiler: one generate less one prefill, over G - 1 steps
            _, gen_busy, gen_ev = profiled(run)
            _, pre_busy, pre_ev = profiled(lambda: llama.prefill_kv(
                cfg, params, embeds, pos, kv_lens=lens_d, kv_quant=True, prefix_kv=p))
            k3 = "K3 decode_attention"
            k3_ms = group_kernels(gen_ev)[0][k3][0] - group_kernels(pre_ev)[0][k3][0]
            say(f"GLM generate ({what}): a decode step {(gen_busy - pre_busy) / (G - 1):.3f} ms "
                f"busy, K3 {k3_ms / (G - 1):.4f} ms of it ({L} launches a step, "
                f"{k3_ms / (L * (G - 1)):.4f} ms each)")
        bad = {k: launches.get(k, 0) for k, n in want[label].items() if launches.get(k, 0) != n}
        if launches.get("decode_attention", 0) != L * (G - 1):
            bad["decode_attention"] = launches.get("decode_attention", 0)
        if not launches.get("int8_matmul") or not torch.isfinite(out["entropy"]).all() or bad:
            raise AssertionError(f"GLM generate ({label}): launches {launches} ({bad} off), "
                                 f"entropies finite {bool(torch.isfinite(out['entropy']).all())}")
        marks[f"generate ({label})"] = time.perf_counter()
    del params, pkv, embeds
    torch.cuda.empty_cache()
    glm_compare(dev, cfg, ids, lens, tok.eos_token_id)
    marks["compare"] = time.perf_counter()
    say_phase(18, t_phase, marks, PHASE18_BUDGET_S)
    return launched


# ------------------------------------------------------------------ main


# ------------------------------------------------------------------ phase 19

# The distributed layer on one card: two ranks over gloo (NCCL refuses two
# ranks on one device), the stage-1 chunk cut to P19_LAYERS layers (gloo
# stages every collective through the host: an fsdp chunk gathers each
# layer's shards in the prefill and in each of 11 decode steps), and a
# 2-layer QLoRA step
P19_LAYERS = 8
P19_MESHES = ((1, 1, 2), (2, 1, 1), (1, 2, 1))
P19_TRAIN_MESHES = ((2, 1, 1), (1, 1, 2))
P19_TRAIN_ROWS = 2          # the train step's batch: one row a rank under dp 2
P19_BUDGET = 150.0
GLOO_NOTE = ("gloo stages CUDA tensors through the host: these collective times are no "
             "guide to NVLink")


def check_sharded_shapes(dev, tps=(2, 4)):
    """Each kernel of the sharded path against its plain version at the
    shapes one rank gives it under tensor parallelism `tps` (Vicuna-7B),
    correctness only, by the limits of its own check: K1 at M 64 for
    q/k/v/o's input and output (4096 / tp), gate/up (11008 / tp), down's
    K (11008 / tp) and the lm_head (32000 / tp) by hold_cols; K2 at 32 / tp
    heads (B 64, T 318, ragged) within 2e-2; K3 at 32 / tp kv heads (B 64,
    S 318, G 12, step 11) by hold_k3; row 4's forward, dq and dk/dv at
    32 / tp heads (B 1, T 2048, kv_len 330) by hold; row 8 at 11008 / tp
    columns (M 64 and 19200) by hold_mlp. Returns the worst error a
    kernel."""
    import torch
    from revisionllm_tpu_torch.ops import decode_attention as DA
    from revisionllm_tpu_torch.ops import flash_attention as FA
    from revisionllm_tpu_torch.ops import quant as Q

    gen = torch.Generator(device=dev).manual_seed(19)
    worst = {}

    def note(name, err):
        worst[name] = max(worst.get(name, 0.0), err)

    for tp in tps:
        for K, N in ((4096, 4096 // tp), (4096 // tp, 4096), (4096, 11008 // tp),
                     (11008 // tp, 4096), (4096, 32000 // tp)):
            x = torch.randn((64, K), generator=gen, device=dev).to(torch.bfloat16)
            q, sc = Q.quantize_int8(torch.randn((K, N), generator=gen, device=dev) * K ** -0.5)
            note("int8_matmul", hold_cols(f"int8_matmul tp {tp} M=64 K={K} N={N}",
                                          Q.int8_matmul(x, q, sc), Q.int8_matmul_plain(x, q, sc)))
        H = 32 // tp
        qh, kh, vh = (torch.randn((64, 318, H, 128), generator=gen, device=dev)
                      .to(torch.bfloat16) for _ in range(3))
        lens = torch.randint(200, 319, (64,), generator=gen, device=dev, dtype=torch.int32)
        err = (FA.flash_attention(qh, kh, vh, causal=True, kv_lens=lens).float()
               - FA.flash_attention_plain(qh, kh, vh, causal=True, kv_lens=lens).float()
               ).abs().max().item()
        if not err <= 2e-2:
            raise AssertionError(f"flash_attention tp {tp} H={H}: max_abs_err {err} > 2e-2")
        note("flash_attention", err)
        args = (*k3_inputs(gen, 64, H, 318, 12, 1, 280, dev), 11)
        note("decode_attention", hold_k3(f"decode_attention tp {tp} KH={H}",
                                         DA.decode_attention(*args),
                                         DA.decode_attention_plain(*args)))
        q4, k4, v4, do = (torch.randn((1, 2048, H, 128), generator=gen, device=dev)
                          .to(torch.bfloat16) for _ in range(4))
        l4 = torch.full((1,), 330, dtype=torch.int32, device=dev)
        o, lse = FA.flash_fwd_lse(q4, k4, v4, kv_lens=l4, causal=True)
        o2, _ = FA.flash_fwd_lse_plain(q4, k4, v4, kv_lens=l4, causal=True)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        a4 = (q4, k4, v4, do, lse, delta)
        dk, dv = FA.flash_dkv(*a4, kv_lens=l4, causal=True)
        dk2, dv2 = FA.flash_dkv_plain(*a4, kv_lens=l4, causal=True)
        for name, got, want in (
                ("flash_fwd_lse", o, o2),
                ("flash_dq", FA.flash_dq(*a4, kv_lens=l4, causal=True),
                 FA.flash_dq_plain(*a4, kv_lens=l4, causal=True)),
                ("flash_dkv", dk, dk2), ("flash_dkv", dv, dv2)):
            note(name, hold(f"{name} tp {tp} H={H}", got, want))
        for M in (64, 19200):
            a8 = mlp_inputs(gen, M, 4096, 11008 // tp, dev)
            note("w8a8_mlp_fused", hold_mlp(f"w8a8_mlp_fused tp {tp} M={M} N={11008 // tp}",
                                            Q.w8a8_mlp_fused(*a8), Q.w8a8_mlp_fused_plain(*a8)))
        del qh, kh, vh, q4, k4, v4, do, a4, a8
    torch.cuda.empty_cache()
    say("sharded shapes against the plain versions, worst error a kernel: "
        + json.dumps({k: float(f"{v:.3e}") for k, v in worst.items()}))
    return worst


def p19_check_collectives(dev):
    """What the design needs of the backend, on CUDA tensors: all_reduce
    (sum and max) and all_gather, in bf16 and f32, with exact results."""
    import torch
    import torch.distributed as dist

    r, n = dist.get_rank(), dist.get_world_size()
    for dt in (torch.bfloat16, torch.float32):
        t = torch.full((1000,), float(r + 1), dtype=dt, device=dev)
        dist.all_reduce(t)
        m = torch.full((7,), float(r), dtype=dt, device=dev)
        dist.all_reduce(m, op=dist.ReduceOp.MAX)
        parts = [torch.empty((3, 5), dtype=dt, device=dev) for _ in range(n)]
        dist.all_gather(parts, torch.full((3, 5), float(r), dtype=dt, device=dev))
        ok = (t.eq(n * (n + 1) / 2).all() and m.eq(n - 1).all()
              and all(p.eq(i).all() for i, p in enumerate(parts)))
        if not bool(ok):
            raise AssertionError(f"{dist.get_backend()}: a collective gave wrong values in {dt}")
    return f"{dist.get_backend()}: all_reduce (sum, max) and all_gather on CUDA bf16 and f32 ok"


def p19_train_run(dev, paths):
    """train_cli's assembly of the stage-1 QLoRA flags (phase 8's) at full
    width cut to 2 layers, on the card, and its first P19_TRAIN_ROWS
    items as one batch (the adapter's dropout kept: every process draws
    the same masks from the same CUDA generator)."""
    import dataclasses

    from revisionllm_tpu_torch.train import train_cli

    args = train_cli.parse_args(train_argv(paths, "unused", 1))
    llama_cfg, adapter_cfg, data_cfg, train_cfg = train_cli.build_configs(args)
    run = train_cli.assemble(dataclasses.replace(llama_cfg, num_layers=2), adapter_cfg,
                             data_cfg, train_cfg, dev, seed=0, quant_base=True)
    return run, run.batch(list(range(P19_TRAIN_ROWS)))


def p19_grads(run, batch, dev, mesh=None):
    """The batch's loss and the gradient of every trainable leaf (CPU f32)
    from trainer.make_grad_fn, one process (mesh None) or this rank of
    `mesh` (over its shards of the base), the generator seeded 0 on the
    card; and the step's ms."""
    import torch
    from revisionllm_tpu_torch.parallel import sharding
    from revisionllm_tpu_torch.train import trainer

    tr = _to(run.trainable, dev, grad=True)
    named = _named_leaves(tr)
    gen = torch.Generator(device=dev).manual_seed(0)
    base = run.base
    if mesh is not None:
        base = sharding.shard_params(mesh, base, sharding.llama_param_specs(base))
    grad_fn = trainer.make_grad_fn(run.llama_cfg, run.adapter_cfg, run.train_cfg, mesh=mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, grads = grad_fn(tr, {}, base, batch, gen, [t for _, t in named])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return loss.item(), {n: g.float().cpu() for (n, _), g in zip(named, grads)}, ms


def p19_hold_grads(tag, got, want):
    """phase 9's limits: the loss within 2e-3 relative, every gradient leaf
    within 5e-2 relative L2 (grad_rel_errors). Returns (the loss's relative
    difference, the worst leaf, its error)."""
    (lg, gg), (lw, gw) = got, want
    if not abs(lg - lw) <= 2e-3 * abs(lw):
        raise AssertionError(f"{tag}: loss {lg} against the one-rank {lw}")
    rel = grad_rel_errors(gg, gw)
    worst = max(rel, key=rel.get)
    if not rel[worst] <= 5e-2:
        raise AssertionError(f"{tag}: gradient {worst} relative L2 {rel[worst]:.3e} > 5e-2")
    return abs(lg - lw) / abs(lw), worst, rel[worst]


def p19_warm_groups(mesh, dev):
    """One small all-reduce on each process group of `mesh`: NCCL makes a
    group's communicator at its first collective (gloo when the group is
    made), which the timed chunk would otherwise pay for."""
    import torch
    import torch.distributed as dist

    for axis in ("data", "fsdp", "tensor", "batch", "world"):
        dist.all_reduce(torch.zeros(1, device=dev), group=mesh.group(axis))


def collective_ms() -> float:
    """The collectives' summed ms since the last spans.reset(), from their
    `comm.*` spans: on the device's clock, on the host's for CPU tensors."""
    from revisionllm_tpu_torch.utils import spans

    rows = [r for n, r in spans.summary().items() if n.startswith("comm.")]
    return sum(r["host_ms"] if r["device_ms"] is None else r["device_ms"] for r in rows)


def p19_rank(layers, meshes, train_meshes, ref_path, paths):
    """One rank of phase 19 (or of scripts/torch_parallel_4gpu.py): the
    backend check; the slice's chunk at `layers` layers under each mesh of
    `meshes`, its greedy decode held against the one-rank run's logits in
    `ref_path` (this rank's rows, hold_sharded), timed after the process's
    one untimed chunk without a mesh (its first kernel calls) and one small
    collective on each of the mesh's groups (p19_warm_groups), with the
    chunk's collectives and kernel launches; then the train step's
    gradients under each of `train_meshes`, timed after an untimed step
    (rank 0 returns them). The parent reports."""
    import torch
    import torch.distributed as dist
    from revisionllm_tpu_torch.eval.engine import GroundingEngine
    from revisionllm_tpu_torch.parallel import comm
    from revisionllm_tpu_torch.parallel import mesh as mesh_lib
    from revisionllm_tpu_torch.utils import kernels, spans

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    rank = dist.get_rank()
    out = {"rank": rank, "check": p19_check_collectives(dev), "serve": [], "train": []}
    eng, movie, qf, qc = slice_setup(dev, layers, tag=f"phase 19 rank {rank}")
    ref = torch.load(ref_path)
    if meshes:  # the process's first kernel calls, untimed, on its own
        eng.ground_windows(movie, SENTENCE, qf, qc, movie_key="movie0")
    for shape in meshes:
        mesh = mesh_lib.create_mesh(*shape)
        e = GroundingEngine(eng.llama_cfg, eng.adapter_cfg, eng.params, eng.vision_params,
                            eng.tokenizer, eng.eval_cfg, device=dev, mesh=mesh)
        p19_warm_groups(mesh, dev)
        dist.barrier()
        comm.reset_stats()
        spans.reset()
        torch.cuda.synchronize()
        with DeviceLaunches() as seen:
            t0 = time.perf_counter()
            with LogitTrace() as trace, spans.enabled():
                res = e.ground_windows(movie, SENTENCE, qf, qc, movie_key="movie0")
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        coll_ms = collective_ms()
        stats, launches = dict(comm.STATS), seen.launches
        comm.reset_stats()
        check_result(res, 57)
        shard = mesh_lib.batch_sharding(mesh)
        B = ref["steps"][0].shape[0]
        want = [shard.local(s, B) for s in ref["steps"]]
        offset = shard.index * (B // shard.n) if shard.splits(B) else 0
        held = hold_sharded(f"mesh {shape} rank {rank}", trace.steps, want, res, ref,
                            exact=shape[2] == 1, offset=offset)
        out["serve"].append({"shape": shape, "ms": ms, "collective_ms": coll_ms, "stats": stats,
                             "launches": launches, "held": held, "rows": len(trace.steps[0]),
                             "steps": len(trace.steps)})
        del e
        torch.cuda.empty_cache()
    if train_meshes:
        run, batch = p19_train_run(dev, paths)
        for shape in train_meshes:
            mesh = mesh_lib.create_mesh(*shape)
            p19_grads(run, batch, dev, mesh)  # untimed: the groups' first collectives
            dist.barrier()
            kernels.reset_launches()
            comm.reset_stats()
            spans.reset()
            with spans.enabled():
                loss, grads, ms = p19_grads(run, batch, dev, mesh)
            coll_ms = collective_ms()
            out["train"].append({"shape": shape, "loss": loss, "ms": ms,
                                 "collective_ms": coll_ms, "stats": dict(comm.STATS),
                                 "launches": dict(kernels.LAUNCHES),
                                 "grads": grads if rank == 0 else None})
            comm.reset_stats()
    return out


def p19_reference(dev, layers, tmp):
    """The one-rank run the ranks are held against: the slice's chunk at
    `layers` layers in this process (its per-step logits, answers and
    entropies saved to a file the ranks read), timed."""
    import torch

    eng, movie, qf, qc = slice_setup(dev, layers, tag="phase 19 one rank")
    eng.ground_windows(movie, SENTENCE, qf, qc, movie_key="movie0")  # warm-up
    torch.cuda.synchronize()
    with DeviceLaunches() as seen:
        t0 = time.perf_counter()
        with LogitTrace() as trace:
            res = eng.ground_windows(movie, SENTENCE, qf, qc, movie_key="movie0")
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    check_result(res, 57)
    path = os.path.join(tmp, f"p19_ref_{layers}.pt")
    torch.save({"steps": trace.steps, "answers": res["answers"],
                "entropy": res["scores_entropy"]}, path)
    del eng
    torch.cuda.empty_cache()
    return path, ms, seen.launches


def p19_report(tag, results, ref_ms, ref_launches, train_ref, note):
    """Print each mesh's numbers a rank and hold the launches: every
    serving kernel on every rank, row 4's on every train rank."""
    for i, first in enumerate(results[0]["serve"]):
        shape = first["shape"]
        for r in results:
            s = r["serve"][i]
            h = s["held"]
            if any(s["launches"].get(k, 0) == 0 for k in SERVING):
                raise AssertionError(f"{tag}: mesh {shape} rank {r['rank']}: a serving kernel "
                                     f"never launched: {s['launches']}")
            say(f"{tag}: mesh {shape} rank {r['rank']}: {s['rows']} rows, chunk {s['ms']:.1f} ms "
                f"(one rank {ref_ms:.1f} ms); collectives a chunk: "
                f"{s['stats'].get('all_reduce', 0)} all-reduces "
                f"{s['stats'].get('all_reduce_bytes', 0) / 1e6:.1f} MB, "
                f"{s['stats'].get('all_gather', 0)} all-gathers "
                f"{s['stats'].get('all_gather_bytes', 0) / 1e6:.1f} MB, "
                f"{s['collective_ms']:.1f} ms ({note}); launches "
                f"{ {k: v for k, v in s['launches'].items() if v} } (one rank: "
                f"{ {k: v for k, v in ref_launches.items() if v} }); "
                + ("logits, greedy tokens, answers and entropies equal to one rank's at all "
                   f"{s['steps']} steps" if shape[2] == 1 else
                   f"logits max abs diff {h['diff']:.3e} (tol {h['tol']:.3e}) over "
                   f"{s['steps']} steps, bf16 ties (step, row) {h['ties']} (those rows not "
                   f"held after), answers {'all equal' if h['answers_equal'] else 'equal where untied'}, "
                   f"untied entropies max diff {h['entropy_diff']:.3e} (tol 5e-2 relative)"))
    for i, first in enumerate(results[0]["train"]):
        shape = first["shape"]
        got = (first["loss"], first["grads"])
        rel_loss, leaf, rel = p19_hold_grads(f"{tag}: train mesh {shape}", got, train_ref[:2])
        for r in results:
            t = r["train"][i]
            if any(t["launches"].get(k, 0) == 0 for k in TRAINING):
                raise AssertionError(f"{tag}: train mesh {shape} rank {r['rank']}: a row-4 "
                                     f"kernel never launched: {t['launches']}")
            if t["loss"] != first["loss"]:
                raise AssertionError(f"{tag}: train mesh {shape}: the ranks' losses differ")
            say(f"{tag}: train mesh {shape} rank {r['rank']}: loss+grads {t['ms']:.1f} ms (one "
                f"rank {train_ref[2]:.1f} ms); collectives: {t['stats'].get('all_reduce', 0)} "
                f"all-reduces {t['stats'].get('all_reduce_bytes', 0) / 1e6:.1f} MB, "
                f"{t['stats'].get('all_gather', 0)} all-gathers "
                f"{t['stats'].get('all_gather_bytes', 0) / 1e6:.1f} MB, "
                f"{t['collective_ms']:.1f} ms ({note}); row-4 launches "
                f"{ {k: t['launches'].get(k, 0) for k in TRAINING} }")
        say(f"{tag}: train mesh {shape} against one rank: loss {first['loss']:.5f} vs "
            f"{train_ref[0]:.5f} (rel diff {rel_loss:.2e}, tol 2e-03), worst gradient {leaf} "
            f"relative L2 {rel:.2e} (tol 5e-02)")


def phase_parallel(dev, tmp, paths, smi, layers=P19_LAYERS, meshes=P19_MESHES,
                   train_meshes=P19_TRAIN_MESHES, backend="gloo", budget=P19_BUDGET, tag=None):
    """Phase 19, the distributed layer: the one-rank run of the slice's chunk
    at `layers` layers and of the train step (2 layers) in this process,
    then len(mesh) ranks spawned over `backend` (gloo on one card, passed
    explicitly: NCCL refuses two ranks on one device) run p19_rank: each
    serving mesh's chunk held against the one-rank logits (hold_sharded), each
    train mesh's loss and gradients by phase 9's limits; each rank's chunk
    ms, collectives a chunk (count, bytes, ms) and kernel launches; the
    phase's time against `budget`."""
    import torch
    from revisionllm_tpu_torch.parallel.launch import spawn

    tag = tag or "phase 19"
    nranks = math.prod(meshes[0] if meshes else train_meshes[0])
    note = GLOO_NOTE if backend == "gloo" else f"{backend}"
    say(f"{tag} on {smi}: {nranks} ranks over {backend}"
        + (" (NCCL refuses two ranks on one card)" if backend == "gloo" else "")
        + f", the stage-1 chunk at {layers} layers (depth cut from 32), train at 2 layers")
    t_phase = time.perf_counter()
    marks = {}
    check_sharded_shapes(dev)
    marks["kernels at the ranks' shapes"] = time.perf_counter()
    torch.cuda.empty_cache()
    ref_path, ref_ms, ref_launches = p19_reference(dev, layers, tmp)
    marks["one-rank chunk"] = time.perf_counter()
    train_ref = None
    if train_meshes:
        run, batch = p19_train_run(dev, paths)
        p19_grads(run, batch, dev)  # warm-up
        train_ref = p19_grads(run, batch, dev)
        del run, batch
        marks["one-rank train step"] = time.perf_counter()
    torch.cuda.empty_cache()
    results = spawn(p19_rank, nranks, (layers, meshes, train_meshes, ref_path, paths),
                    backend=backend, timeout_s=600.0)
    marks["ranks"] = time.perf_counter()
    say(f"{tag}: " + "; ".join(sorted({r['check'] for r in results})))
    p19_report(tag, results, ref_ms, ref_launches, train_ref, note)
    say_phase(19 if tag == "phase 19" else tag, t_phase, marks, budget)
    return results


def main() -> int:
    root = Path(__file__).resolve().parent
    if not (root / "revisionllm_tpu_torch" / "__init__.py").is_file():
        print("chip_smoke: run from a checkout of the repository "
              "(revisionllm_tpu_torch/ not found beside this script)", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 3
    sys.path.insert(0, str(root))
    from revisionllm_tpu_torch.utils import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    say(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    secs = kernels.build()
    say(f"build: {time.perf_counter() - t0:.1f} s wall, per kernel {json.dumps({k: round(v, 1) for k, v in secs.items()})}")
    report_ptxas(kernels)

    records = {}
    for check in (check_int8_matmul, check_flash_attention, check_decode_attention,
                  check_int4_matmul, check_fused_mlp, check_w8a8_gemm, check_moe_kernels):
        rec = check(dev, ITERS)
        records[rec["name"]] = rec
    for rec in check_flash_vjp(dev, ITERS) + check_prefix_attention(dev, ITERS):
        records[rec["name"]] = rec
    for name, err in check_flash_edges(dev).items():
        records[name]["max_abs_err"] = max(records[name]["max_abs_err"], err)
    launches, setup = phase_slice(dev, RUNS)
    for name in SERVING:
        records[name]["launches"] = launches[name]
    records["decode_step_fused"] = check_decode_step(dev, ITERS, setup[0].params)
    records["decode_step_serve"] = check_decode_serve(dev, ITERS, setup[0].params,
                                                      records["decode_step_fused"]["ms"])
    for name, err in check_long_caches(dev, setup[0].params).items():
        records[name]["max_abs_err"] = max(records[name]["max_abs_err"], err)
    for name, rec in records.items():
        rec.update(route="cuda", source=f"revisionllm_tpu_torch/csrc/{SOURCES[name]}.cu",
                   replaces=REPLACES[name])
    phase_compare(dev)
    phase_profile(dev, setup)
    launches = phase_configs(dev, setup, RUNS)
    for label, conf in CONFIGS.items():
        for name in conf["kernels"]:
            records[name]["launches"] = launches[label][name]
        phase_compare(dev, f"config {label}", conf["quantize"], conf["env"], conf["kernels"],
                      conf["pack"])

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        launches = phase_pipeline(dev, setup, tmp)
        for name in PIPELINE:
            records[name]["launches"] = launches[name]
        phase_checkpoint(dev, tmp, setup[1])
        phase_surfaces(dev, setup, tmp)
        del setup
        torch.cuda.empty_cache()
        phase_pipeline_compare(dev)
        paths = _corpus(tmp)
        launches = phase_train(dev, tmp, paths)
        for name in TRAINING:
            records[name]["launches"] = launches[name]
        torch.cuda.empty_cache()
        phase_train_compare(dev, paths)
        phase_surfaces_train(dev, tmp, paths)
        phase_rest(dev, tmp, paths, smi)
        phase_chapters(dev, paths, smi)
        launches = phase_glm(dev, tmp, smi)
        records["decode_attention"]["g16_launches"] = launches["prefix"]["decode_attention"]
        records["flash_attention_prefixed"]["glm_launches"] = \
            launches["prefix"]["flash_attention_prefixed"]
        phase_parallel(dev, tmp, paths, smi)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    print(json.dumps({"kernels": list(records.values())}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
