"""Rotary position embeddings, as in revisionllm_tpu/ops/rope.py: the HF
LLaMA half-split convention, and ChatGLM2's, which rotates only the first
`rotary_dim` dims of a head in interleaved (even, odd) pairs. Angles are
computed and applied in f32 before casting back. DeepSeek-V2 adds YaRN's
frequencies (`yarn_inv_freq`, `yarn_mscale`) on interleaved pairs."""

from __future__ import annotations

import math

import torch


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float = 10000.0):
    """positions [*, T] (int) -> (cos, sin) each [*, T, head_dim//2] f32."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device)
    inv_freq = 1.0 / (theta ** (exponents / head_dim))
    ang = positions.float()[..., None] * inv_freq
    return torch.cos(ang), torch.sin(ang)


def rope_tables(cos: torch.Tensor, sin: torch.Tensor):
    """(cos, sin) [..., T, hd/2] -> full-width tables [..., T, 1, hd] for
    `apply_rope_tables`: (cos | cos) and (-sin | sin). Build once per
    forward; every layer's q and k reuse them."""
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([c, c], dim=-1), torch.cat([-s, s], dim=-1)


def rope_tables_interleaved(cos: torch.Tensor, sin: torch.Tensor, head_dim: int):
    """(cos, sin) [..., T, rotary_dim/2] -> full-width tables [..., T, 1,
    head_dim] for `apply_rope_tables(..., interleaved=True)`: each angle's
    cos twice and (-sin, sin) on its (even, odd) pair, then 1 and 0 on the
    dims past rotary_dim, which pass through."""
    c = cos[..., None, :]
    s = sin[..., None, :]
    rot = 2 * c.shape[-1]
    cos_full = torch.stack([c, c], dim=-1).flatten(-2)
    sin_full = torch.stack([-s, s], dim=-1).flatten(-2)
    pad = head_dim - rot
    if pad:
        cos_full = torch.cat([cos_full, torch.ones_like(cos_full[..., :1]).expand(
            *cos_full.shape[:-1], pad)], dim=-1)
        sin_full = torch.cat([sin_full, torch.zeros_like(sin_full[..., :1]).expand(
            *sin_full.shape[:-1], pad)], dim=-1)
    return cos_full, sin_full


def apply_rope_tables(x: torch.Tensor, cos_full: torch.Tensor, sin_full: torch.Tensor,
                      interleaved: bool = False) -> torch.Tensor:
    """x * (cos | cos) + (x2 | x1) * (-sin | sin) in f32: the same sums as
    (x1*cos - x2*sin, x2*cos + x1*sin), in 6 ops. interleaved=True swaps
    the (even, odd) pairs instead of the halves (tables from
    `rope_tables_interleaved`)."""
    xf = x.float()
    if interleaved:
        rot = torch.stack([xf[..., 1::2], xf[..., 0::2]], dim=-1).flatten(-2)
    else:
        half = x.shape[-1] // 2
        rot = torch.cat([xf[..., half:], xf[..., :half]], dim=-1)
    return (xf * cos_full + rot * sin_full).to(x.dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate q/k. x: [..., T, H, head_dim]; cos/sin: [..., T, hd/2].

    HF llama convention: the head dim is split in halves (x1, x2) and
    rotated as (x1*cos - x2*sin, x2*cos + x1*sin)."""
    return apply_rope_tables(x, *rope_tables(cos, sin))


def apply_rope_interleaved(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                           rotary_dim: int) -> torch.Tensor:
    """ChatGLM2's rotary: only the first `rotary_dim` head dims rotate, in
    interleaved (even, odd) pairs; the rest pass through. x [..., T, H,
    head_dim]; cos/sin [..., T, >= rotary_dim/2]."""
    tables = rope_tables_interleaved(cos[..., : rotary_dim // 2], sin[..., : rotary_dim // 2],
                                     x.shape[-1])
    return apply_rope_tables(x, *tables, interleaved=True)


def yarn_mscale(scale: float, mscale: float = 1.0) -> float:
    """DeepSeek-V2's yarn_get_mscale: 0.1 mscale ln(scale) + 1, or 1 for a
    scale of 1 or less."""
    if scale <= 1:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def yarn_inv_freq(dim: int, base: float, factor: float, original_max_position: int,
                  beta_fast: float = 32.0, beta_slow: float = 1.0, device=None) -> torch.Tensor:
    """YaRN's inverse frequencies of a rotary over `dim` dims [dim / 2] f32
    (DeepseekV2YarnRotaryEmbedding): the dims whose wavelengths fit fewer
    than beta_slow turns in the original context are interpolated (divided
    by `factor`), those with more than beta_fast turns kept, with a linear
    ramp between; factor 1 gives the plain frequencies."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    freq_extra = 1.0 / (base ** exps)
    if factor <= 1:
        return freq_extra
    freq_inter = 1.0 / (factor * base ** exps)

    def correction_dim(rotations):
        return (dim * math.log(original_max_position / (rotations * 2 * math.pi))
                ) / (2 * math.log(base))

    low = max(math.floor(correction_dim(beta_fast)), 0)
    high = min(math.ceil(correction_dim(beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
            / (high - low)).clamp(0, 1)
    extra_mask = 1.0 - ramp
    return freq_inter * (1 - extra_mask) + freq_extra * extra_mask


def rope_angles_freq(positions: torch.Tensor, inv_freq: torch.Tensor, mscale: float = 1.0):
    """rope_angles with given inverse frequencies [rot / 2], the cos and sin
    times `mscale` (YaRN's attention factor on the tables)."""
    ang = positions.float()[..., None] * inv_freq.to(positions.device)
    if mscale == 1.0:
        return torch.cos(ang), torch.sin(ang)
    return torch.cos(ang) * mscale, torch.sin(ang) * mscale
