"""Normalization layers (functional), as in revisionllm_tpu/ops/norms.py.

RMSNorm matches HF LlamaRMSNorm: f32 mean-square, scale applied after the
cast back. LayerNorm serves the ClipEncoder adapter.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps), computed in f32 and cast back to x's type
    by one fused op, then times weight."""
    return F.rms_norm(x, (x.shape[-1],), eps=eps) * weight


def layer_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    xf = (xf - mean) * torch.rsqrt(var + eps)
    return (xf * weight.float() + bias.float()).to(dtype)
