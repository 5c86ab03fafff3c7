"""CLIP-space proposal scoring, as in revisionllm_tpu/eval/similarity.py.

`proposal_cosine_scores` takes any leading proposal dims (JAX vmaps the
single-proposal function instead), so one call scores every proposal of a
query on the device. `topk_pooling`, `attention_pooling` and
`span_cxw_to_xx` are the reference scorer's helpers (similarity.py:5-113).
"""

from __future__ import annotations

import os

import torch


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 0.0) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=dim, keepdim=True) + eps)


def topk_pooling(text_embeds: torch.Tensor, video_embeds: torch.Tensor, k: int) -> torch.Tensor:
    """The sum of the k frames most similar to each text: text_embeds
    [num_texts, d], video_embeds [num_vids, num_frames, d] ->
    [num_vids, num_texts, d]."""
    sims = torch.einsum("vfd,td->vtf", video_embeds, text_embeds)
    idx = torch.topk(sims, k, dim=-1).indices  # [v, t, k]
    v, t = idx.shape[:2]
    d = video_embeds.shape[-1]
    frames = video_embeds[:, None].expand(v, t, -1, d)
    return torch.gather(frames, 2, idx[..., None].expand(v, t, k, d)).sum(dim=2)


def attention_pooling(text_embeds: torch.Tensor, video_embeds: torch.Tensor,
                      temperature: float) -> torch.Tensor:
    """Frames pooled by softmax(similarity / temperature) over the frames:
    [num_vids, num_texts, d]."""
    sims = torch.einsum("vfd,td->vft", video_embeds, text_embeds)
    weights = torch.softmax(sims / temperature, dim=1)
    return torch.einsum("vfd,vft->vtd", video_embeds, weights)


def span_cxw_to_xx(cxw_spans: torch.Tensor) -> torch.Tensor:
    """(center, width) spans -> (start, end)."""
    x1 = cxw_spans[..., 0] - 0.5 * cxw_spans[..., 1]
    x2 = cxw_spans[..., 0] + 0.5 * cxw_spans[..., 1]
    return torch.stack([x1, x2], dim=-1)


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
