"""Prefill attention: kernel K2 (csrc/flash_attention.cu), its plain version,
the einsum reference and the dispatcher.

Counterpart of revisionllm_tpu/ops/flash_attention.py (forward only). The
JAX dispatcher picks the einsum path below 512 tokens and by a 1 GB score
rule (:288-344); those cutovers were measured on a TPU v5e and are not
copied: on a CUDA tensor `attention` always launches K2. On the CPU it runs
`mha_reference`, as JAX does off the TPU.
"""

from __future__ import annotations

import ctypes
import math
import os
from typing import Optional

import torch

from revisionllm_tpu_torch.utils import kernels

NEG_INF = -2.0e30


def _kv_mask(B, T, S, kv_lens, causal, device) -> torch.Tensor:
    """[B, 1, T, S] bool: column < kv_lens[b] and, when causal, row >= column."""
    col = torch.arange(S, device=device)
    mask = torch.ones((B, 1, T, S), dtype=torch.bool, device=device)
    if kv_lens is not None:
        mask = mask & (col[None, None, None, :] < kv_lens.to(device)[:, None, None, None])
    if causal:
        row = torch.arange(T, device=device)
        mask = mask & (row[:, None] >= col[None, :])[None, None]
    return mask


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
    kv_lens: Optional[torch.Tensor] = None, sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """K2's maths step by step, in f32: scores, NEG_INF masking, softmax
    over the live columns, and 0 for a row that sees no key (l_safe)."""
    B, T, H, d = q.shape
    S, KH = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    group = H // KH
    kf = k.float().repeat_interleave(group, dim=2)
    vf = v.float().repeat_interleave(group, dim=2)
    s = torch.einsum("bthd,bshd->bhts", q.float(), kf) * sm_scale
    lens = None if kv_lens is None else kv_lens.clamp(max=S)
    mask = _kv_mask(B, T, S, lens, causal, q.device)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    o = torch.einsum("bhts,bshd->bthd", p / l_safe, vf)
    return o.to(q.dtype)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
    kv_lens: Optional[torch.Tensor] = None, sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """q: [B, T, H, d]; k/v: [B, S, KH, d] with H % KH == 0; kv_lens [B]
    masks padded kv columns (default: all S). Returns [B, T, H, d].

    A CPU tensor takes `flash_attention_plain`; a CUDA tensor launches K2
    (bf16, d = 128)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, kv_lens=kv_lens, sm_scale=sm_scale)
    B, T, H, d = q.shape
    S, KH = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if d != 128 or H % KH or k.shape != (B, S, KH, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention kernel: unsupported shapes q{tuple(q.shape)} k{tuple(k.shape)}")
    dev = q.device
    if not all(t.dtype == torch.bfloat16 and t.device == dev and t.is_contiguous()
               and t.data_ptr() % 16 == 0 for t in (q, k, v)):
        raise ValueError("flash_attention kernel takes contiguous 16-byte-aligned bf16 "
                         "q, k, v on one device")
    if kv_lens is None:
        lens = torch.full((B,), S, dtype=torch.int32, device=dev)
    else:
        lens = kv_lens.to(device=dev, dtype=torch.int32).clamp(max=S).contiguous()
    out = torch.empty_like(q)
    fn = kernels.function(
        "flash_attention", "flash_attn_fwd_bf16",
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    )
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(), out.data_ptr(),
        B, T, S, H, KH, d, float(sm_scale), int(causal), kernels.stream_of(q),
    )
    kernels.check_launch("flash_attention", err)
    kernels.LAUNCHES["flash_attention"] += 1
    return out


_ATTN_BF16: Optional[bool] = None


def set_attn_bf16(enabled: Optional[bool]) -> None:
    """Override the bf16-score switch (None = back to the environment and the
    device default)."""
    global _ATTN_BF16
    _ATTN_BF16 = enabled


def _attn_bf16_scores(device: torch.device) -> bool:
    """REVISIONLLM_ATTN_BF16=1: mha_reference keeps scores and softmax in
    bf16 for bf16 inputs. Default ON for CUDA tensors, OFF on the CPU (exact
    f32 scores), as JAX defaults it ON for the TPU only."""
    if _ATTN_BF16 is not None:
        return _ATTN_BF16
    env = os.environ.get("REVISIONLLM_ATTN_BF16")
    if env is not None:
        return env == "1"
    return device.type == "cuda"


def mha_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
    kv_lens: Optional[torch.Tensor] = None, sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain einsum attention, same contract as `flash_attention`, with the
    semantics of revisionllm_tpu's mha_reference (a fully masked row
    averages all columns, as a softmax over equal NEG_INF scores does)."""
    B, T, H, d = q.shape
    S, KH = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if KH != H:
        k = k.repeat_interleave(H // KH, dim=2)
        v = v.repeat_interleave(H // KH, dim=2)
    sdt = torch.bfloat16 if (_attn_bf16_scores(q.device) and q.dtype == torch.bfloat16) else torch.float32
    s = torch.einsum("bthd,bshd->bhts", q.to(sdt), k.to(sdt))
    s = s * torch.tensor(sm_scale, dtype=sdt)
    mask = _kv_mask(B, T, S, kv_lens, causal, q.device)
    s = torch.where(mask, s, torch.tensor(NEG_INF, dtype=sdt, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhts,bshd->bthd", p, v.to(sdt))
    return out.to(q.dtype)


def attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
    kv_lens: Optional[torch.Tensor] = None, sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """K2 on a CUDA tensor; `mha_reference` on the CPU."""
    if q.device.type == "cuda":
        return flash_attention(q, k, v, causal=causal, kv_lens=kv_lens, sm_scale=sm_scale)
    return mha_reference(q, k, v, causal=causal, kv_lens=kv_lens, sm_scale=sm_scale)
