"""Int8 weight quantization and the quantized matmul dispatch.

Counterpart of revisionllm_tpu/ops/quant.py. Per-output-channel absmax int8
weights halve the weight bytes of the memory-bound decode step. `q8_apply`
keeps JAX's dispatch rule (ops/quant.py:237-276):

- M <= 256 (every decode matmul): `int8_matmul`, kernel K1
  (csrc/int8_matmul.cu) on a CUDA tensor, its plain version on a CPU one;
- M > 256 with W8A8 on (prefill): `w8a8_matmul`, per-row int8 activations
  times int8 weights with int32 accumulation. In JAX this is an XLA int8 dot
  outside any Pallas kernel, so here it stays a PyTorch call (`torch._int_mm`);
- otherwise exact dequantization, then a matmul.

Quantization divides and rounds half to even (`torch.round`, like
`jnp.round`), so the int8 values are bit-equal to JAX's.
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, Optional, Sequence, Tuple

import torch

from revisionllm_tpu_torch.utils import kernels

_PLANS: Dict[tuple, Tuple[int, int, int, int]] = {}
KERNEL_MAX_M = 256  # q8_apply sends M <= 256 rows to K1, as JAX's pallas_max_m


def quantize_int8(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """w: [..., K, N] -> (int8 values [..., K, N], f32 scales [..., N])."""
    wf = w.float()
    absmax = wf.abs().amax(dim=-2)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(wf / scale.unsqueeze(-2)), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    return (q.float() * scale.unsqueeze(-2)).to(dtype)


def int8_matmul_plain(x: torch.Tensor, w_q8: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """K1's maths step by step: widen int8 to f32 (exact), multiply with f32
    accumulation, apply the per-column scale, cast to x's type."""
    K, N = w_q8.shape
    x2 = x.reshape(-1, K)
    acc = x2.float() @ w_q8.float()
    return (acc * scale).to(x.dtype).reshape(*x.shape[:-1], N)


def _q8_plan(M: int, K: int, N: int, device: torch.device) -> Tuple[int, int, int, int]:
    """(mt, padded N, K splits, K rows per split) for K1, cached per shape.

    Mirrors csrc/int8_matmul.cu: blocks of 128 columns, 64-row stages, 4
    stages of x and int8 W plus one widened W tile in shared memory. K is
    split so that the grid fills one wave of resident blocks."""
    key = (M, K, N, device.index)
    plan = _PLANS.get(key)
    if plan is None:
        mt = 1
        while mt * 16 < M:
            mt *= 2
        n_pad = -(-N // 128) * 128
        k_tiles = -(-K // 64)
        smem = 4 * (mt * 16 * 72 * 2 + 64 * 128) + 64 * 136 * 2
        per_sm = max(1, min((228 * 1024) // (smem + 1024), 8))
        slots = per_sm * torch.cuda.get_device_properties(device).multi_processor_count
        splitk = max(1, min(round(slots / (n_pad // 128)), k_tiles))
        k_per_split = -(-k_tiles // splitk) * 64
        plan = (mt, n_pad, -(-K // k_per_split), k_per_split)
        _PLANS[key] = plan
    return plan


def int8_matmul(x: torch.Tensor, w_q8: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x: [..., K] (bf16 on the card); w_q8: [K, N] int8; scale: [N] f32 ->
    [..., N] in x's type. Leading dims of x flatten into M <= 256.

    A CPU tensor takes `int8_matmul_plain`; a CUDA tensor launches K1."""
    if x.device.type == "cpu":
        return int8_matmul_plain(x, w_q8, scale)
    K, N = w_q8.shape
    x2 = x.reshape(-1, K)
    M = x2.shape[0]
    dev = x.device
    if not (
        1 <= M <= KERNEL_MAX_M and K % 8 == 0 and N % 16 == 0 and scale.shape == (N,)
        and x2.dtype == torch.bfloat16 and w_q8.dtype == torch.int8
        and scale.dtype == torch.float32 and w_q8.device == dev and scale.device == dev
        and x2.is_contiguous() and w_q8.is_contiguous() and scale.is_contiguous()
        and x2.data_ptr() % 16 == 0 and w_q8.data_ptr() % 16 == 0
    ):
        raise ValueError(
            "int8_matmul kernel takes contiguous 16-byte-aligned bf16 x [M<=256, K%8==0], "
            f"int8 w [K, N%16==0] and f32 scale [N] on one device; got x {x2.dtype} "
            f"{tuple(x2.shape)}, w {w_q8.dtype} {tuple(w_q8.shape)}, scale {scale.dtype} "
            f"{tuple(scale.shape)}"
        )
    mt, n_pad, splitk, k_per_split = _q8_plan(M, K, N, dev)
    ws = torch.empty((splitk, mt * 16, n_pad), dtype=torch.float32, device=dev)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
    fn = kernels.function(
        "int8_matmul", "q8_matmul_bf16",
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    )
    err = fn(
        x2.data_ptr(), w_q8.data_ptr(), scale.data_ptr(), ws.data_ptr(), out.data_ptr(),
        M, K, N, mt, splitk, k_per_split, kernels.stream_of(x2),
    )
    kernels.check_launch("int8_matmul", err)
    kernels.LAUNCHES["int8_matmul"] += 1
    return out.reshape(*x.shape[:-1], N)


def _quantize_activation_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row absmax int8 of [..., K] -> (int8 [M, K], f32 scale [M, 1])."""
    x2 = x.reshape(-1, x.shape[-1])
    # abs and max are exact in x's own type, so this is the f32 absmax
    absmax = x2.abs().amax(dim=-1, keepdim=True).float()
    x_scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    # x / x_scale promotes to f32: the same quotient as x.float() / x_scale
    x_q8 = torch.div(x2, x_scale).round_().clamp_(-127, 127).to(torch.int8)
    return x_q8, x_scale


def _w8a8_product(
    x: torch.Tensor, x_q8: torch.Tensor, x_scale: torch.Tensor,
    w_q8: torch.Tensor, w_scale: torch.Tensor,
) -> torch.Tensor:
    # int8 x int8 -> exact int32. torch._int_mm wants M > 16 on the card,
    # where cuBLAS takes its fast int8 kernel only for a column-major
    # weight, so the weight is transposed for the call (the stored layout
    # stays [K, N] row-major, as in JAX). The copy is redone on every call:
    # a known cost, queued in ROADMAP's speed work
    if x_q8.is_cuda:
        acc = torch._int_mm(x_q8, w_q8.t().contiguous().t())
    elif x_q8.shape[0] > 16:
        acc = torch._int_mm(x_q8, w_q8)
    else:
        acc = x_q8.int() @ w_q8.int()
    out = torch.mul(acc, x_scale)  # int32 -> f32 rounding as acc.float()
    out.mul_(w_scale)
    return out.to(x.dtype).reshape(*x.shape[:-1], w_q8.shape[-1])


def w8a8_matmul(x: torch.Tensor, w_q8: torch.Tensor, w_scale: torch.Tensor) -> torch.Tensor:
    """Dynamic-activation int8 matmul: per-row absmax quantize x, int8 x int8
    with int32 accumulation, rescale. Inference only (no gradient)."""
    x_q8, x_scale = _quantize_activation_rows(x)
    return _w8a8_product(x, x_q8, x_scale, w_q8, w_scale)


_W8A8: Optional[bool] = None


def set_w8a8(enabled: Optional[bool]) -> None:
    """Override the W8A8-prefill switch (None = back to the environment and
    the device default)."""
    global _W8A8
    _W8A8 = enabled


def _w8a8_enabled(device: torch.device) -> bool:
    """W8A8 prefill: set_w8a8, else REVISIONLLM_W8A8=0/1, else ON for CUDA
    tensors (serving numerics) and OFF on the CPU (exact parity), as JAX
    defaults it ON for the TPU and OFF on the CPU."""
    if _W8A8 is not None:
        return _W8A8
    env = os.environ.get("REVISIONLLM_W8A8")
    if env is not None:
        return env == "1"
    return device.type == "cuda"


def _is_q8(w) -> bool:
    return isinstance(w, dict) and "q8" in w


def q8_apply(x: torch.Tensor, w) -> torch.Tensor:
    """Matmul dispatch: w is a dense [K, N] tensor or a {'q8', 'scale'} dict."""
    if not _is_q8(w):
        return x @ w
    M = x.numel() // x.shape[-1]
    if M <= KERNEL_MAX_M:
        return int8_matmul(x, w["q8"], w["scale"])
    if _w8a8_enabled(x.device):
        return w8a8_matmul(x, w["q8"], w["scale"])
    return x @ dequantize_int8(w["q8"], w["scale"], x.dtype)


def q8_apply_multi(x: torch.Tensor, ws: Sequence):
    """Apply several matrices to the SAME activation, sharing one activation
    quantization on the W8A8 path (bit-exact vs separate w8a8_matmul calls);
    per-matrix q8_apply otherwise."""
    ws = tuple(ws)
    M = x.numel() // x.shape[-1]
    if not (
        len(ws) >= 2 and all(_is_q8(w) for w in ws)
        and M > KERNEL_MAX_M and _w8a8_enabled(x.device)
    ):
        return tuple(q8_apply(x, w) for w in ws)
    x_q8, x_scale = _quantize_activation_rows(x)
    return tuple(_w8a8_product(x, x_q8, x_scale, w["q8"], w["scale"]) for w in ws)


def quantize_llama_params(params, quantize_lm_head: bool = True):
    """Quantize all stacked layer matrices (and optionally lm_head) of a
    models/llama param tree to int8. Norms and embed keep their type."""
    out = dict(params)
    layers = {}
    for name, w in params["layers"].items():
        if name.endswith("_norm"):
            layers[name] = w
        else:
            q, s = quantize_int8(w)
            layers[name] = {"q8": q, "scale": s}
    out["layers"] = layers
    if quantize_lm_head:
        q, s = quantize_int8(params["lm_head"])
        out["lm_head"] = {"q8": q, "scale": s}
    return out
