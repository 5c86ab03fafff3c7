"""Rotary position embeddings, as in revisionllm_tpu/ops/rope.py: the HF
LLaMA half-split convention, and ChatGLM2's, which rotates only the first
`rotary_dim` dims of a head in interleaved (even, odd) pairs. Angles are
computed and applied in f32 before casting back."""

from __future__ import annotations

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
