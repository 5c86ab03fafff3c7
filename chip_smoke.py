#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (revisionllm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Every run goes through every phase, so every number it prints was
measured in that run. Phases:
  1. the card's name and power limit (nvidia-smi);
  2. build the three CUDA kernels from csrc/ (one nvcc each, in parallel);
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
     GEMM and the rest, and the device's idle share.

Prints phase lines, then one JSON line of per-kernel numbers, the
nvidia-smi line, and last {"ok": true, "device": {...}}. Exits non-zero,
with no result line, when CUDA is missing, when run outside a checkout of
the repository, or when any phase fails. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
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
}


def say(msg: str) -> None:
    print(f"# {msg}", flush=True)


def bound(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / BF16_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_events(prof):
    """The CUDA kernel events of a torch.profiler run (CUPTI's "Command
    Buffer Full" stall records are not kernels)."""
    from torch.autograd import DeviceType

    return [e for e in prof.events()
            if e.device_type == DeviceType.CUDA and not e.name.startswith("Command Buffer")]


# device kernels by what launched them: the hand-written kernels by their
# __global__ names, then the int8 GEMM of the W8A8 prefill (torch._int_mm),
# then the other library GEMMs (the adapter's bf16 products)
KERNEL_GROUPS = (
    ("K1 int8_matmul (q8_matmul + q8_finalize)", r"q8_matmul_kernel|q8_finalize_kernel"),
    ("K2 flash_attention", r"flash_fwd_kernel"),
    ("K3 decode_attention", r"decode_attn_kernel"),
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
    missing = [k for k, n in launches.items() if n == 0]
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


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
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
        rec.update(route="cuda", source=f"revisionllm_tpu_torch/csrc/{rec['name']}.cu",
                   replaces=REPLACES[rec["name"]])
        records[rec["name"]] = rec
    launches, setup = phase_slice(dev, RUNS)
    for name, rec in records.items():
        rec["launches"] = launches[name]
    phase_compare(dev)
    phase_profile(dev, setup)

    print(json.dumps({"kernels": list(records.values())}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
