"""Decode-confidence statistics from per-step logits, in PyTorch.

Counterpart of revisionllm_tpu/eval/uncertainty.py (the reference's
funs_get_feature_X.py:5-146): torch functions over a [B, T, V] logits
buffer, computed in f32. `generate` computes the per-step entropy inline;
these score a logits buffer after the fact.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

_F32_MIN = torch.finfo(torch.float32).min


def token_entropy(logits: torch.Tensor) -> torch.Tensor:
    """Per-step softmax entropy, [..., V] -> [...]: -sum(p * log(p + 1e-10))
    in f32 (the 1e-10 inside the log is the reference's)."""
    probs = torch.softmax(logits.float(), dim=-1)
    return -(probs * torch.log(probs + 1e-10)).sum(dim=-1)


def _masked_stats(x: torch.Tensor, valid: torch.Tensor):
    """(max, min, mean, ddof-1 std) over axis 1 of the valid steps; the std
    of a single valid step is 0."""
    m = valid.float()
    n = m.sum(dim=1).clamp(min=1.0)
    x_max = torch.where(valid, x, torch.full_like(x, _F32_MIN)).amax(dim=1)
    x_min = torch.where(valid, x, torch.full_like(x, -_F32_MIN)).amin(dim=1)
    mean = (x * m).sum(dim=1) / n
    var = (m * (x - mean[:, None]) ** 2).sum(dim=1) / (n - 1.0).clamp(min=1.0)
    std = torch.where(n > 1, torch.sqrt(var), torch.zeros_like(var))
    return x_max, x_min, mean, std


def entropy_statistics(logits: torch.Tensor,
                       valid_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, T, V] logits -> [B, 4] (max, min, mean, std) of the per-step
    entropy (get_entropy_statistics); `valid_mask` [B, T] keeps the steps
    before each row's eos."""
    ent = token_entropy(logits)
    if valid_mask is None:
        n = ent.shape[1]
        std = ent.std(dim=1, correction=1) if n > 1 else torch.zeros_like(ent[:, 0])
        return torch.stack([ent.amax(dim=1), ent.amin(dim=1), ent.mean(dim=1), std], dim=1)
    return torch.stack(_masked_stats(ent, valid_mask.bool()), dim=1)


def token_prob_statistics(logits: torch.Tensor, tokens: torch.Tensor,
                          valid_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, T, V] logits and [B, T] chosen tokens -> [B, 6]: (-p max, -p min,
    -p mean, -p std, -log p mean, -log p std) of each step's chosen-token
    probability (get_prob_statistics)."""
    probs = torch.softmax(logits.float(), dim=-1)
    p = torch.gather(probs, -1, tokens.long()[..., None])[..., 0]
    logp = torch.log(p + 1e-10)
    valid = torch.ones_like(p, dtype=torch.bool) if valid_mask is None else valid_mask.bool()
    p_max, p_min, p_mean, p_std = _masked_stats(-p, valid)
    _, _, lp_mean, lp_std = _masked_stats(-logp, valid)
    return torch.stack([p_max, p_min, p_mean, p_std, lp_mean, lp_std], dim=1)


def average_hidden_states(hidden_states: torch.Tensor, layer_list: Sequence[int],
                          q_begin: int, q_end: int) -> torch.Tensor:
    """Mean hidden state of the selected layers over positions [q_begin,
    q_end) (get_average_hidden_states). hidden_states [L, B, T, D] ->
    [B, len(layer_list), D]; an empty range takes the position before q_end."""
    if q_begin == q_end:
        q_begin = q_end - 1
    picked = hidden_states[torch.as_tensor(list(layer_list), dtype=torch.long)]
    return picked[:, :, q_begin:q_end].mean(dim=2).transpose(0, 1)


def last_token_hidden_states(hidden_states: torch.Tensor, layer_list: Sequence[int],
                             q_end: int, num_last_tokens: int) -> torch.Tensor:
    """The last `num_last_tokens` hidden states before q_end of the selected
    layers (get_last_token_hidden_states): [B, len(layer_list), num_last, D]."""
    picked = hidden_states[torch.as_tensor(list(layer_list), dtype=torch.long)]
    return picked[:, :, q_end - num_last_tokens : q_end].transpose(0, 1)
