"""Rotary position embeddings (HF LLaMA half-split convention), as in
revisionllm_tpu/ops/rope.py. Angles are computed and applied in f32 before
casting back."""

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


def apply_rope_tables(x: torch.Tensor, cos_full: torch.Tensor, sin_full: torch.Tensor) -> torch.Tensor:
    """x * (cos | cos) + (x2 | x1) * (-sin | sin) in f32: the same sums as
    (x1*cos - x2*sin, x2*cos + x1*sin), in 6 ops."""
    xf = x.float()
    half = x.shape[-1] // 2
    rot = torch.cat([xf[..., half:], xf[..., :half]], dim=-1)
    return (xf * cos_full + rot * sin_full).to(x.dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate q/k. x: [..., T, H, head_dim]; cos/sin: [..., T, hd/2].

    HF llama convention: the head dim is split in halves (x1, x2) and
    rotated as (x1*cos - x2*sin, x2*cos + x1*sin)."""
    return apply_rope_tables(x, *rope_tables(cos, sin))
