"""Sub-quadratic self-attention variants for the adapter's cross encoder, in
PyTorch: the counterpart of revisionllm_tpu/ops/linear_attention.py.

The reference CrossLayer's `self_attn` options (model/adapter/
cross_attn.py:99-130) besides exact MHA:

- Performer: FAVOR+ positive random features (Choromanski et al. 2021,
  eq. 5), phi(x) = exp(W x - ||x||^2 / 2 - c) + eps with W orthogonal
  gaussian, giving softmax(q k^T) V ~= phi(q) [phi(k)^T V] /
  (phi(q) [phi(k)^T 1]). Not causal: the adapter attends over the frames
  both ways.
- Linformer (Wang et al. 2020): keys and values compressed along the
  sequence by a learned [L_max, k] projection before exact attention, with
  one kv head whose k and v share one projection (the reference call).

Plain PyTorch on both devices (JAX has no Pallas kernel here). Random
features come from an explicit torch.Generator; they cannot replay JAX's
PRNG, so parity tests carry JAX's `features` and `e_proj` across.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch


def orthogonal_gaussian(gen: torch.Generator, dim: int, m: int,
                        device: Optional[torch.device] = None) -> torch.Tensor:
    """[dim, m] f32 random features from `gen`: blocks of orthogonalised
    gaussians scaled to gaussian column norms (the performer_pytorch
    default, scaling=0)."""
    blocks = []
    remaining = m
    while remaining > 0:
        g = torch.randn((dim, dim), generator=gen, device=device)
        qmat, _ = torch.linalg.qr(g)
        blocks.append(qmat[:, : min(dim, remaining)])
        remaining -= dim
    w = torch.cat(blocks, dim=1)
    # chi(dim)-distributed column norms, as a gaussian matrix has
    norms = torch.randn((m, dim), generator=gen, device=device).pow(2).sum(dim=-1).sqrt()
    return w * norms[None, :]


def performer_features(x: torch.Tensor, proj: torch.Tensor, is_query: bool,
                       eps: float = 1e-6) -> torch.Tensor:
    """phi(x) [B, L, H, m] f32 for x [B, L, H, hd], proj [hd, m].

    The stabilisers of the FAVOR+ reference: a query subtracts its own max
    (it cancels between that query's numerator and denominator); the keys
    share one max over positions and features (axes 1 and 3), since a
    per-key offset would reweight that key everywhere."""
    xf = x.float()
    z = torch.einsum("...d,dm->...m", xf, proj.float()) - 0.5 * (xf * xf).sum(-1, keepdim=True)
    if is_query:
        z = z - z.amax(dim=-1, keepdim=True)
    else:
        z = z - z.amax(dim=(1, 3), keepdim=True)
    return torch.exp(z) + eps


def _lin(p, t):
    dt = torch.promote_types(t.dtype, p["w"].dtype)
    return t.to(dt) @ p["w"].to(dt) + p["b"].to(dt)


def performer_self_attention(
    layer: Dict[str, Dict[str, torch.Tensor]],
    x: torch.Tensor,
    num_heads: int,
    proj: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """FAVOR+ linear self-attention. x [B, L, d]; proj [hd, m] random
    features; valid [B, L] masks padded positions out of the kv sums."""
    B, L, d = x.shape
    hd = d // num_heads
    q = _lin(layer["wq"], x).reshape(B, L, num_heads, hd) * (hd ** -0.25)
    k = _lin(layer["wk"], x).reshape(B, L, num_heads, hd) * (hd ** -0.25)
    v = _lin(layer["wv"], x).reshape(B, L, num_heads, hd).float()
    phi_q = performer_features(q, proj, is_query=True)
    phi_k = performer_features(k, proj, is_query=False)
    if valid is not None:
        m = valid[:, :, None, None].float()
        phi_k = phi_k * m
        v = v * m
    kv = torch.einsum("blhm,blhe->bhme", phi_k, v)
    ksum = phi_k.sum(dim=1)
    num = torch.einsum("blhm,bhme->blhe", phi_q, kv)
    den = torch.einsum("blhm,bhm->blh", phi_q, ksum)[..., None]
    o = (num / den.clamp(min=1e-6)).reshape(B, L, d).to(x.dtype)
    return _lin(layer["wo"], o)


def linformer_self_attention(
    layer: Dict[str, Dict[str, torch.Tensor]],
    x: torch.Tensor,
    num_heads: int,
    e_proj: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Linformer self-attention with the reference call's semantics
    (cross_attn.py:114): |e_proj|'s k compressed positions, one kv head,
    k and v from one shared projection "wkv" (separate "wk" / "wv" also
    taken). x [B, L, d]; e_proj [L_max, k], sliced to the live L."""
    B, L, d = x.shape
    hd = d // num_heads
    q = _lin(layer["wq"], x).reshape(B, L, num_heads, hd)
    if "wkv" in layer:
        k = _lin(layer["wkv"], x).float()
        v = k
    else:
        k = _lin(layer["wk"], x).float()
        v = _lin(layer["wv"], x).float()
    e = e_proj[:L].float()
    if valid is not None:
        m = valid[:, :, None].float()
        k = k * m
        v = v * m
    kc = torch.einsum("bld,lk->bkd", k, e)
    vc = torch.einsum("bld,lk->bkd", v, e)
    s = torch.einsum("blhd,bkd->bhlk", q.float(), kc) / math.sqrt(hd)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhlk,bkd->blhd", p, vc).reshape(B, L, d).to(x.dtype)
    return _lin(layer["wo"], o)
