#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (revisionllm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Every run goes through every phase, so every number it prints was
measured in that run. Phases:
  1. the card's name and power limit (nvidia-smi);
  2. build the six CUDA kernels from the four sources in csrc/ (one nvcc
     per source, all in parallel);
  3. each kernel against its plain PyTorch version on the card, at the
     stage-1 shapes (Vicuna-7B, chunk of 64 windows): max error against the
     stated tolerance, device time of the kernel, of the plain version and of
     one PyTorch library call for the same function, and the least time the
     H100 SXM data sheet allows (3.35 TB/s; 989 TFLOP/s bf16);
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
     time grouped by hand-written kernel (K1 = matmul + finalize), library
     GEMM and the rest, and the device's idle share;
  7. the row-4 kernels (forward with LSE, dq, dk/dv) against their plain
     versions at the training shape (B = 1, H = 32, T = S = 2048, d = 128,
     causal), at full length and at a ragged kv_len of 330: the relative
     L2 error of each whole output and of each of its (64-row tile, head)
     blocks against stated limits, two planted faults that must fail those
     limits, device times, the data-sheet bound, and SDPA's forward and
     backward as the yardstick;
  8. the training slice through its entry point, train_cli.main: QLoRA at
     Vicuna-7B width and depth (the stage1_dense preset: int8 frozen base
     made from a seed, dense bf16 lm_head, LoRA r 64 on all seven linears,
     the ClipEncoder adapter with T2V, remat, batch 1, sequence 2048) over
     the synthetic corpus, 1 warm-up and 6 timed steps: step time,
     tokens/s, peak memory, loss and grad norm per step, each row-4
     kernel's launches (fails if one is 0, or if K1, K2, K3 or
     torch._int_mm ran), the log, the async checkpoint main saved against
     the trained trees, and the export; one step under the profiler;
     auto-resume for one more step; the no-silent-detach rule on the card;
  9. one train step with the kernels on the card against the plain path on
     the CPU, from train_cli's assembly at full width, 2 layers and
     sequence 2048: the loss and the gradient of every trainable leaf
     (LoRA and the adapter).

Prints phase lines, then one JSON line of per-kernel numbers, the
nvidia-smi line, and last {"ok": true, "device": {...}}. Exits non-zero,
with no result line, when CUDA is missing, when run outside a checkout of
the repository, or when any phase fails. Imports nothing of JAX.
"""

from __future__ import annotations

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
REPLACES = {
    "int8_matmul": "revisionllm_tpu/ops/quant.py:46",
    "flash_attention": "revisionllm_tpu/ops/flash_attention.py:40",
    "decode_attention": "revisionllm_tpu/ops/decode_attention.py:40",
    "flash_fwd_lse": "revisionllm_tpu/ops/flash_attention.py:352",
    "flash_dq": "revisionllm_tpu/ops/flash_attention.py:415",
    "flash_dkv": "revisionllm_tpu/ops/flash_attention.py:464",
}
SOURCES = {
    "int8_matmul": "int8_matmul", "flash_attention": "flash_attention",
    "decode_attention": "decode_attention", "flash_fwd_lse": "flash_attention",
    "flash_dq": "flash_attention_vjp", "flash_dkv": "flash_attention_vjp",
}
SERVING = ("int8_matmul", "flash_attention", "decode_attention")
TRAINING = ("flash_fwd_lse", "flash_dq", "flash_dkv")
TRAIN_STEPS = 6             # timed train steps after one warm-up


def say(msg: str) -> None:
    print(f"# {msg}", flush=True)


def bound(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / BF16_OPS_PER_S * 1e3
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
    ("K1 int8_matmul (q8_matmul + q8_finalize)", r"q8_matmul_kernel|q8_finalize_kernel"),
    ("K2 flash_attention", r"flash_fwd_kernel"),
    ("K3 decode_attention", r"decode_attn_kernel"),
    ("row 4 flash_fwd_lse", r"flash_fwd_lse_kernel"),
    ("row 4 flash_dq", r"flash_dq_kernel"),
    ("row 4 flash_dkv", r"flash_dkv_kernel"),
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


def check_int8_matmul(dev, iters):
    import torch
    from revisionllm_tpu_torch.ops import quant as Q

    M = 64
    # (K, N, launches per decode step): q/k/v/o, gate/up, down per layer x 32,
    # then the lm_head
    shapes = [(4096, 4096, 4 * 32), (4096, 11008, 2 * 32), (11008, 4096, 32), (4096, 32000, 1)]
    gen = torch.Generator(device=dev).manual_seed(3)
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0.0, "ops": 0.0}
    worst = 0.0
    details = []
    for K, N, per_step in shapes:
        x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
        copies = max(1, math.ceil(128e6 / (K * N)))
        ws = []
        for _ in range(copies):
            q, s = Q.quantize_int8(torch.randn((K, N), generator=gen, device=dev) * K ** -0.5)
            ws.append((q, s, Q.dequantize_int8(q, s, torch.bfloat16)))
        got = Q.int8_matmul(x, ws[0][0], ws[0][1])
        want = Q.int8_matmul_plain(x, ws[0][0], ws[0][1])
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        # both round an f32 sum (taken in another order) to bf16: 2^-7 of
        # the largest output is two bf16 steps
        tol = 2.0 ** -7 * max(1.0, want.float().abs().max().item())
        if not err <= tol:
            raise AssertionError(f"int8_matmul {K}x{N}: max_abs_err {err} > {tol}")
        worst = max(worst, err)
        pick = cycled(ws)
        ms = device_ms(lambda: Q.int8_matmul(x, *pick()[:2]), iters)
        plain = device_ms(lambda: Q.int8_matmul_plain(x, *pick()[:2]), iters)
        lib = device_ms(lambda: torch.matmul(x, pick()[2]), iters)
        nbytes = M * K * 2 + K * N + N * 4 + M * N * 2
        ops = 2.0 * M * K * N
        b, by = bound(nbytes, ops)
        say(f"int8_matmul M={M} K={K} N={N}: max_abs_err {err:.3e} (tol {tol:.3e}) "
            f"kernel {ms:.4f} ms plain {plain:.4f} ms torch.matmul(bf16 W) {lib:.4f} ms "
            f"bound {b:.4f} ms ({by}) [{per_step} launches per decode step]")
        details.append({"K": K, "N": N, "ms": ms, "plain_ms": plain, "library_ms": lib,
                        "bound_ms": b, "per_decode_step": per_step})
        for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib)):
            tot[key] += per_step * val
        tot["bytes"] += per_step * nbytes
        tot["ops"] += per_step * ops
    # other tile heights (chunks of 1 and 200 windows) and K, N that are no
    # multiple of the tiles, correctness only
    for M2, K2, N2 in ((1, 4096, 4096), (200, 4096, 4096), (37, 4104, 4112)):
        x = torch.randn((M2, K2), generator=gen, device=dev).to(torch.bfloat16)
        q, s = Q.quantize_int8(torch.randn((K2, N2), generator=gen, device=dev) * K2 ** -0.5)
        want = Q.int8_matmul_plain(x, q, s).float()
        err = (Q.int8_matmul(x, q, s).float() - want).abs().max().item()
        tol = 2.0 ** -7 * max(1.0, want.abs().max().item())
        say(f"int8_matmul M={M2} K={K2} N={N2}: max_abs_err {err:.3e} (tol {tol:.3e})")
        if not err <= tol:
            raise AssertionError(f"int8_matmul M={M2} K={K2} N={N2}: max_abs_err {err} > {tol}")
        worst = max(worst, err)
    b, by = bound(tot["bytes"], tot["ops"])
    return {
        "name": "int8_matmul", "max_abs_err": worst, "ms": tot["ms"],
        "plain_ms": tot["plain_ms"], "bound_ms": b, "bound_by": by,
        "library_ms": tot["library_ms"],
        "unit": "one decode step at B=64 (225 launches: 32 layers x 7 + lm_head)",
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


def check_decode_attention(dev, iters):
    import torch
    import torch.nn.functional as F
    from revisionllm_tpu_torch.ops import decode_attention as DA

    B, KH, S, G, hd = 64, 32, 318, 12, 128
    gen = torch.Generator(device=dev).manual_seed(5)
    q = torch.randn((B, KH, 1, hd), generator=gen, device=dev).to(torch.bfloat16)
    pk, pv = (torch.randint(-127, 128, (B, S, KH, hd), generator=gen, device=dev, dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand((B, S, KH), generator=gen, device=dev) * 0.02 + 0.005 for _ in range(2))
    gk, gv = (torch.randn((B, G, KH, hd), generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
    lens = torch.randint(280, S + 1, (B,), generator=gen, device=dev, dtype=torch.int32)
    out = None
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
    # the other variants, correctness only: a bf16 prompt cache (KV8 off)
    # and GQA (32 query heads over 8 kv heads)
    for label, quant, KH2, group in (("bf16 prompt", False, 32, 1), ("GQA int8", True, 8, 4)):
        q2 = torch.randn((B, KH2, group, hd), generator=gen, device=dev).to(torch.bfloat16)
        if quant:
            pk2, pv2 = (torch.randint(-127, 128, (B, S, KH2, hd), generator=gen, device=dev,
                                      dtype=torch.int8) for _ in range(2))
            ks2, vs2 = (torch.rand((B, S, KH2), generator=gen, device=dev) * 0.02 + 0.005 for _ in range(2))
        else:
            pk2, pv2 = (torch.randn((B, S, KH2, hd), generator=gen, device=dev).to(torch.bfloat16)
                        for _ in range(2))
            ks2 = vs2 = None
        gk2, gv2 = (torch.randn((B, G, KH2, hd), generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
        args = (q2, pk2, pv2, ks2, vs2, gk2, gv2, lens, 5)
        err = (DA.decode_attention(*args).float() - DA.decode_attention_plain(*args).float()).abs().max().item()
        say(f"decode_attention {label} KH={KH2} group={group} step=5: max_abs_err {err:.3e} (tol 1.0e-02)")
        if not err <= 1e-2:
            raise AssertionError(f"decode_attention {label}: max_abs_err {err} > 1e-2")
        out["max_abs_err"] = max(out["max_abs_err"], err)
    return out


# ------------------------------------------------------------------ phase 4


def make_engine(cfg, acfg, ecfg, device, dtype, seed=0):
    """Random int8 Vicuna params (built one layer at a time) and adapter."""
    from revisionllm_tpu_torch.eval.engine import GroundingEngine
    from revisionllm_tpu_torch.models import llama, revisionllm
    from revisionllm_tpu_torch.utils.testing import FakeTokenizer

    params = llama.init_params(cfg, seed=seed, dtype=dtype, device=device, quantize=True)
    vision = revisionllm.init_vision_params(acfg, seed=seed + 1, d_in=acfg.d_model,
                                            dtype=dtype, device=device)
    tok = FakeTokenizer()
    for i in range(300):
        tok._id(str(i))
    return GroundingEngine(cfg, acfg, params, vision, tok, ecfg, device=device)


def run_slice(engine, movie, qf, qc, runs):
    """ground_windows once counted, then `runs - 1` more; returns (result,
    launches of the first run, list of latencies in s)."""
    import torch
    from revisionllm_tpu_torch.utils import kernels

    lat = []
    launches = None
    res = None
    for r in range(runs):
        if r == 0:
            kernels.reset_launches()
        if engine.device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = engine.ground_windows(movie, "a man opens the old door", qf, qc, movie_key="movie0")
        if engine.device.type == "cuda":
            torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        if r == 0:
            launches = dict(kernels.LAUNCHES)
    return res, launches, lat


def check_result(res, n_windows):
    if res["num_windows"] != n_windows or len(res["answers"]) != n_windows:
        raise AssertionError(f"expected {n_windows} windows, got {res['num_windows']}")
    ent = np.asarray(res["scores_entropy"], np.float64)
    if ent.shape != (n_windows,) or not np.isfinite(ent).all() or (ent < 0).any():
        raise AssertionError("entropy scores are not finite and non-negative")


def slice_setup(dev):
    """The stage-1 serving configuration of bench.py:48-200 at Vicuna-7B full
    width and depth: (engine, movie [18000, 768], query tokens [25, 768],
    query CLS [768]), weights and inputs made from seed 0."""
    import torch
    from revisionllm_tpu_torch.config import AdapterConfig, EvalConfig, LlamaConfig

    cfg = LlamaConfig()
    acfg = AdapterConfig(clip_adapter_text=True, hierarchy=False, feature_mode="temporal",
                         hidden_size=cfg.hidden_size)
    ecfg = EvalConfig(debug_window=125, num_frames=250, feature_fps=5.0, batch=64,
                      stride=2, max_new_tokens=12)
    t0 = time.perf_counter()
    engine = make_engine(cfg, acfg, ecfg, dev, torch.bfloat16)
    torch.cuda.synchronize()
    say(f"slice: Vicuna-7B, {cfg.num_layers} layers, int8 weights built from seed 0 in "
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
    res = engine.ground_windows(movie, "a man opens the old door", qf, qc, movie_key="movie0")
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
    missing = [k for k in SERVING if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    return launches, setup


def phase_profile(dev, setup):
    """Where one chunk's time goes, on the slice's engine and inputs. For the
    adapter + splice, the prefill and each decode step: the wall time by
    CUDA events from an idle device, the host's time to enqueue the part,
    and the device's busy time (its kernels summed under torch.profiler).
    A part whose wall time matches its enqueue time and exceeds its busy
    time is paced by the host. Then one ground_windows under the profiler,
    its kernel time by group."""
    import torch
    from revisionllm_tpu_torch.constants import QUESTIONS
    from revisionllm_tpu_torch.models import llama, revisionllm
    from revisionllm_tpu_torch.models.multimodal import build_splice_plan, stack_plans

    eng, movie, qf_np, _ = setup
    cfg, acfg = eng.llama_cfg, eng.adapter_cfg
    ids = eng._prompt_ids("a man opens the old door", QUESTIONS["mad_grounding"])
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
        images = feats[idx[:64]].to(torch.bfloat16)
        video = revisionllm.encode_video(acfg, eng.vision_params, images, qf)
        return revisionllm.assemble_inputs(eng.params, plan, video, dtype=torch.bfloat16)

    def prefill(embeds, pos, lens):
        return llama.prefill_kv(cfg, eng.params, embeds, pos, kv_lens=lens, kv_quant=True)

    for _ in range(2):  # the first pass warms up
        (embeds, pos, lens), ad_wall, ad_host = timed(adapter)
        (logits, pkv), pf_wall, pf_host = timed(lambda: prefill(embeds, pos, lens))
        gen = llama.init_gen_cache(cfg, 64, 12, torch.bfloat16, dev)
        tok = llama.embed_tokens(eng.params, logits.argmax(-1)[:, None])
        steps = []
        for g in range(11):
            step = partial(llama.decode_step_split, cfg, eng.params, pkv, lens, gen, g, tok)
            (logits, gen), wall, host = timed(step)
            steps.append((wall, host))
    _, ad_busy, _ = profiled(adapter)
    _, pf_busy, _ = profiled(lambda: prefill(embeds, pos, lens))
    _, st_busy, st_events = profiled(partial(llama.decode_step_split, cfg, eng.params, pkv, lens, gen, 5, tok))
    st_wall = float(np.median([w for w, _ in steps]))
    st_host = float(np.median([h for _, h in steps]))
    say(f"profile: adapter+splice wall {ad_wall:.2f} ms, host enqueue {ad_host:.2f} ms, "
        f"device busy {ad_busy:.2f} ms")
    say(f"profile: prefill wall {pf_wall:.2f} ms, host enqueue {pf_host:.2f} ms, device busy {pf_busy:.2f} ms")
    say(f"profile: decode step (median of 11) wall {st_wall:.2f} ms, host enqueue {st_host:.2f} ms; "
        f"device busy {st_busy:.2f} ms at step 5 (idle share {max(0.0, 1 - st_busy / st_wall) * 100:.1f}%); "
        f"11 steps wall {sum(w for w, _ in steps):.1f} ms")
    groups, _ = group_kernels(st_events)
    say("profile: decode step 5 kernels: " + "; ".join(
        f"{label} {ms:.3f} ms x{n}" for label, (ms, n) in groups.items() if n))

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.ground_windows(movie, "a man opens the old door", qf_np, None, movie_key="movie0")
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


def compare_paths(dev, cfg, acfg, batch, num_frames, new_tokens, seed=0):
    """Kernel path on `dev` against the plain path on the CPU, from the same
    seed, serving numerics on both (W8A8, KV8, f32 attention scores on the
    CPU as in K2). Returns (max |logit diff|, max |logit|, token agreement)."""
    import torch
    from revisionllm_tpu_torch.constants import IMAGE_TOKEN_INDEX
    from revisionllm_tpu_torch.models import generation, llama, revisionllm
    from revisionllm_tpu_torch.models.multimodal import build_splice_plan, stack_plans
    from revisionllm_tpu_torch.ops import flash_attention, quant

    cpu = torch.device("cpu")
    params = llama.init_params(cfg, seed=seed, dtype=torch.bfloat16, device=cpu, quantize=True)
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
            outs[device.type] = (logits.float().cpu(), gen["tokens"].cpu())
    finally:
        quant.set_w8a8(None)
        generation.set_kv8(None)
        flash_attention.set_attn_bf16(None)
    (lk, tk), (lp, tp) = outs[dev.type], outs["cpu"]
    diff = (lk - lp).abs().max().item()
    agree = (tk == tp).float().mean().item()
    return diff, lp.abs().max().item(), agree


def phase_compare(dev):
    from revisionllm_tpu_torch.config import AdapterConfig, LlamaConfig

    cfg = LlamaConfig(num_layers=2)
    acfg = AdapterConfig(clip_adapter_text=True, hierarchy=False, feature_mode="temporal",
                         hidden_size=cfg.hidden_size)
    t0 = time.perf_counter()
    diff, scale, agree = compare_paths(dev, cfg, acfg, batch=2, num_frames=250, new_tokens=12)
    # bf16 activations, and int8 activation or KV quantization can round a
    # value across a boundary on one side only: 5% of the largest logit
    tol = 5e-2 * max(1.0, scale)
    say(f"compare: Vicuna-7B width, 2 layers, kernels on the card vs plain on the CPU: "
        f"first-step logits max_abs_diff {diff:.4e} (tol {tol:.3e}, max |logit| {scale:.3f}); "
        f"greedy tokens agree {agree * 100:.1f}% ({time.perf_counter() - t0:.1f} s)")
    if not diff <= tol:
        raise AssertionError(f"logits differ by {diff} > {tol}")


# ------------------------------------------------------------------ phase 7


def _pairs(T, lens, causal=True):
    """Live (row, column) pairs of causal attention over T rows with kv_len
    per batch row."""
    t_idx = np.arange(T)
    return sum(int(np.minimum(t_idx + 1 if causal else T, n).sum()) for n in lens)


TILE = 64                   # rows per tile of the row-4 kernels
VJP_TOL = 1e-2              # relative L2 error of a whole o, dq, dk or dv
VJP_TILE_TOL = 2e-2         # ... and of each of its (64-row tile, head) blocks


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


def check_flash_vjp(dev, iters):
    """Row 4 at the training shape. Returns the three kernel records (the
    ragged case, which is what a training batch gives them)."""
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
    # more. Two planted faults must fail these limits: the last live tile
    # scaled by 0.9, and the last live kv tile dropped (the plain version
    # at kv_len cut to that tile's start). lse is f32: 1e-3 absolute.
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
            rel, worst = rel_errs(got, want)
            err = (got.float() - want.float()).abs().max().item()
            scaled = got.clone()
            scaled[:, tile] *= 0.9
            faults = {"last live tile x0.9": rel_errs(scaled, want),
                      "last live kv tile dropped": rel_errs(dropped, want)}
            say(f"{name} {tname} ({label}, kv_len {n}): relative L2 {rel:.2e} (tol {VJP_TOL:.0e}), "
                f"worst tile {worst:.2e} (tol {VJP_TILE_TOL:.0e}), max_abs_err {err:.3e}; planted "
                f"faults, worst tile (whole tensor): "
                + ", ".join(f"{f} {w:.2e} ({r:.2e})" for f, (r, w) in faults.items()))
            if not (rel <= VJP_TOL and worst <= VJP_TILE_TOL):
                raise AssertionError(f"{name} {tname} {label}: relative L2 {rel}, worst tile {worst}")
            passed = [f for f, (r, w) in faults.items() if r <= VJP_TOL and w <= VJP_TILE_TOL]
            if passed:
                raise AssertionError(f"{name} {tname} {label}: the limits accept planted faults {passed}")
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
        lh = [n] * B
        pairs = _pairs(T, lh)
        rows_b = B * T * H * d * 2          # one bf16 [B, T, H, d] tensor, all rows
        kv_b = B * n * H * d * 2            # one bf16 k or v, live rows only
        stat_b = B * H * T * 4              # one f32 lse or delta
        bounds = {
            "flash_fwd_lse": bound(2 * rows_b + 2 * kv_b + stat_b + B * 4, 4.0 * H * d * pairs),
            "flash_dq": bound(3 * rows_b + 2 * kv_b + 2 * stat_b + B * 4, 6.0 * H * d * pairs),
            # dk and dv are written for all T rows (zeros past kv_len)
            "flash_dkv": bound(4 * rows_b + 2 * kv_b + 2 * stat_b + B * 4, 8.0 * H * d * pairs),
        }
        times = {"flash_fwd_lse": (t_fwd, p_fwd, l_fwd), "flash_dq": (t_dq, p_dq, l_bwd),
                 "flash_dkv": (t_dkv, p_dkv, l_bwd)}
        for name in TRAINING:
            ms, plain, lib = times[name]
            b, by = bounds[name]
            lib_label = "sdpa fwd" if name == "flash_fwd_lse" else "sdpa bwd (dq+dk+dv)"
            say(f"{name} B={B} H={H} T=S={T} d={d} causal kv_len={n} ({label}): "
                f"max_abs_err {errs[name]:.3e} kernel {ms:.4f} ms plain {plain:.4f} ms "
                f"{lib_label}{' is_causal' if mask is None else ' masked'} {lib:.4f} ms "
                f"bound {b:.4f} ms ({by})")
            if label == "ragged":
                records[name].update(ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                                     library_ms=lib,
                                     unit=f"one launch = one layer, T=2048, kv_len {n} "
                                          f"(library: {lib_label}, masked)")
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
    stray = {k: launches[k] for k in SERVING if launches[k]}
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
    import dataclasses

    import torch
    from revisionllm_tpu_torch.train import train_cli, trainer

    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    cfgs = train_cli.build_configs(train_cli.parse_args(train_argv(paths, "unused", 1)))
    llama_cfg, adapter_cfg, data_cfg, train_cfg = cfgs
    run = train_cli.assemble(dataclasses.replace(llama_cfg, num_layers=2),
                             dataclasses.replace(adapter_cfg, dropout=0.0), data_cfg, train_cfg,
                             cpu, seed=0, quant_base=True)
    batch = run.batch([0])
    loss_fn = trainer.make_loss_fn(run.llama_cfg, run.adapter_cfg, run.train_cfg)
    out = {}
    for device in (dev, cpu):
        b, bs = _to(run.base, device), _to(batch, device)
        tr = _to(run.trainable, device, grad=True)
        named = _named_leaves(tr)
        gen = torch.Generator(device=device).manual_seed(0)
        with trainer._dequant_trace():
            loss = loss_fn(tr, {}, b, bs, gen)
            grads = torch.autograd.grad(loss, [t for _, t in named])
        out[device.type] = (loss.item(), {n: g.float().cpu() for (n, _), g in zip(named, grads)})
    (lk, gk), (lp, gp) = out[dev.type], out["cpu"]
    # The key projection's bias has no gradient in exact arithmetic (it adds
    # the same q.b to every score of a row, which the softmax ignores), so
    # both sides return rounding noise there, about 1e-8 in norm. Its error
    # is measured against the gradient of the same layer's query bias.
    rel = {}
    for n, want in gp.items():
        ref = gp[n[:-len("wk/b")] + "wq/b"] if n.endswith("/wk/b") else want
        e, r = (gk[n] - want).norm().item(), ref.norm().item()
        rel[n] = e / r if r > 0 else (math.inf if e > 0 else 0.0)
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
    say(f"train compare: Vicuna-7B width, 2 layers, seq {run.train_cfg.model_max_length}, "
        f"kernels on the card vs plain on the CPU: loss {lk:.5f} vs {lp:.5f} (rel diff "
        f"{abs(lk - lp) / abs(lp):.2e}, tol {loss_tol:.0e}); gradient relative L2, worst leaf "
        f"of each group: " + "; ".join(f"{g} ({len(groups[g])} leaves) {rel[n]:.2e} at {n}"
                                      for g, n in worst.items())
        + f" (tol {grad_tol:.0e}) ({time.perf_counter() - t0:.1f} s)")
    top = sorted(groups["vision"], key=rel.get, reverse=True)[:5]
    say("train compare: the 5 worst vision leaves "
        + str({n: float(f"{rel[n]:.2e}") for n in top}) + "; key-bias gradient norms "
        + str({n: (float(f"{gk[n].norm().item():.2e}"), float(f"{gp[n].norm().item():.2e}"))
               for n in groups["vision"] if n.endswith("/wk/b")}) + " (card, CPU)")
    if not abs(lk - lp) <= loss_tol * abs(lp):
        raise AssertionError(f"train loss differs: {lk} vs {lp}")
    bad = {n: r for n, r in rel.items() if not r <= grad_tol}
    if bad:
        raise AssertionError(f"gradients differ: {bad}")


# ------------------------------------------------------------------ main


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
    for name in kernels.KERNELS:
        log = kernels.library_path(name).with_suffix(".log")
        if log.exists():
            text = log.read_text()
            regs = sorted({int(m) for m in re.findall(r"Used (\d+) registers", text)})
            spills = sorted({int(m) for m in re.findall(r"(\d+) bytes spill stores", text)})
            say(f"ptxas {name}: registers per instantiation {regs}; spill-store bytes {spills}")

    records = {}
    for check in (check_int8_matmul, check_flash_attention, check_decode_attention):
        rec = check(dev, ITERS)
        records[rec["name"]] = rec
    for rec in check_flash_vjp(dev, ITERS):
        records[rec["name"]] = rec
    for name, rec in records.items():
        rec.update(route="cuda", source=f"revisionllm_tpu_torch/csrc/{SOURCES[name]}.cu",
                   replaces=REPLACES[name])
    launches, setup = phase_slice(dev, RUNS)
    for name in SERVING:
        records[name]["launches"] = launches[name]
    phase_compare(dev)
    phase_profile(dev, setup)
    del setup
    torch.cuda.empty_cache()

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        paths = _corpus(tmp)
        launches = phase_train(dev, tmp, paths)
        for name in TRAINING:
            records[name]["launches"] = launches[name]
        torch.cuda.empty_cache()
        phase_train_compare(dev, paths)
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
