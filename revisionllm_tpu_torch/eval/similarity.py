"""CLIP-space proposal scoring, as in revisionllm_tpu/eval/similarity.py.

`proposal_cosine_scores` takes any leading proposal dims (JAX vmaps the
single-proposal function instead), so one call scores every proposal of a
query on the device.
"""

from __future__ import annotations

import os

import torch


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 0.0) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=dim, keepdim=True) + eps)


def proposal_cosine_scores(
    query_cls: torch.Tensor,
    frames: torch.Tensor,
    frame_valid: torch.Tensor,
    k: int = 3,
) -> torch.Tensor:
    """query_cls [d] (pre-L2-normalized); frames [..., max_len, d]
    (zero-padded); frame_valid [..., max_len] bool -> [...] cosine scores of
    the top-k-pooled proposal embeddings.

    The default normalizes each frame (masked to valid frames). With
    REVISIONLLM_EXACT_COSINE=1 it reproduces the reference's quirk of
    normalizing each feature across frames (`norm(dim=0)`); zero-padded rows
    change neither the norms nor the top-k sums."""
    if os.environ.get("REVISIONLLM_EXACT_COSINE", "0") == "1":
        colnorm = torch.sqrt((frames * frames).sum(dim=-2, keepdim=True))
        normed = frames / colnorm.clamp(min=1e-12)
    else:
        normed = l2_normalize(frames, dim=-1, eps=1e-8)
    sims = normed @ query_cls  # [..., max_len]
    sims = torch.where(frame_valid, sims, torch.full_like(sims, torch.finfo(sims.dtype).min))
    idx = torch.topk(sims, k, dim=-1).indices  # [..., k]
    picked = torch.gather(normed, -2, idx[..., None].expand(*idx.shape, normed.shape[-1]))
    valid_k = torch.gather(frame_valid, -1, idx)
    picked = torch.where(valid_k[..., None], picked, torch.zeros_like(picked))
    return picked.sum(dim=-2) @ query_cls
