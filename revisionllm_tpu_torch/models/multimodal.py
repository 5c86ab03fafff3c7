"""Static-shape multimodal splicing.

Host planning (`build_splice_plan`, `stack_plans`) is a copy of
revisionllm_tpu/models/multimodal.py: walk the sentinel-carrying token ids
once and emit a fixed-length plan (per-position token id, source kind,
source index, label, position id). `splice_embeds` assembles the [B, L, D]
embeddings on the device with one gather and a select.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from revisionllm_tpu_torch.constants import (
    IGNORE_INDEX,
    IMAGE_TOKEN_INDEX,
    MEMORY_TOKEN_INDEX,
)

KIND_PAD = 0
KIND_TEXT = 1
KIND_VIDEO = 2
KIND_MEMORY = 3


@dataclasses.dataclass
class SplicePlan:
    """Fixed-length assembly plan for one sample (all int32 NumPy)."""

    text_ids: np.ndarray   # [L] token id at text positions, 0 elsewhere
    kind: np.ndarray       # [L] KIND_*
    src_idx: np.ndarray    # [L] index into the video / memory token block
    labels: np.ndarray     # [L] LM labels (-100 outside supervised text)
    positions: np.ndarray  # [L] position ids (0..len-1 then 0s)
    length: int            # valid prefix length

    @property
    def num_video_tokens(self) -> int:
        return int((self.kind == KIND_VIDEO).sum())


def build_splice_plan(
    input_ids: Sequence[int],
    num_video_tokens: int,
    max_len: int,
    labels: Optional[Sequence[int]] = None,
    num_memory_tokens: int = 0,
) -> SplicePlan:
    """Expand sentinel ids into a fixed-length layout: every
    IMAGE_TOKEN_INDEX becomes `num_video_tokens` video positions, a
    MEMORY_TOKEN_INDEX `num_memory_tokens` memory positions; truncates at
    max_len."""
    text_ids = np.zeros(max_len, np.int32)
    kind = np.zeros(max_len, np.int32)
    src_idx = np.zeros(max_len, np.int32)
    out_labels = np.full(max_len, IGNORE_INDEX, np.int32)
    pos = 0
    vid_cursor = 0
    mem_cursor = 0
    labels = list(labels) if labels is not None else None

    for i, tok in enumerate(input_ids):
        if pos >= max_len:
            break
        if tok == IMAGE_TOKEN_INDEX:
            n = min(num_video_tokens, max_len - pos)
            kind[pos : pos + n] = KIND_VIDEO
            src_idx[pos : pos + n] = np.arange(vid_cursor, vid_cursor + n)
            vid_cursor += n
            pos += n
        elif tok == MEMORY_TOKEN_INDEX:
            n = min(num_memory_tokens, max_len - pos)
            kind[pos : pos + n] = KIND_MEMORY
            src_idx[pos : pos + n] = np.arange(mem_cursor, mem_cursor + n)
            mem_cursor += n
            pos += n
        else:
            kind[pos] = KIND_TEXT
            text_ids[pos] = tok
            if labels is not None:
                out_labels[pos] = labels[i]
            pos += 1

    positions = np.zeros(max_len, np.int32)
    positions[:pos] = np.arange(pos)
    return SplicePlan(text_ids, kind, src_idx, out_labels, positions, pos)


def stack_plans(plans: List[SplicePlan]) -> Dict[str, np.ndarray]:
    """Batch plans into arrays ready for device transfer."""
    return {
        "text_ids": np.stack([p.text_ids for p in plans]),
        "kind": np.stack([p.kind for p in plans]),
        "src_idx": np.stack([p.src_idx for p in plans]),
        "labels": np.stack([p.labels for p in plans]),
        "positions": np.stack([p.positions for p in plans]),
        "lengths": np.asarray([p.length for p in plans], np.int32),
    }


def _gather_tokens(tokens: torch.Tensor, src_idx: torch.Tensor) -> torch.Tensor:
    idx = src_idx.long().clamp(0, tokens.shape[1] - 1)
    return torch.gather(tokens, 1, idx[..., None].expand(-1, -1, tokens.shape[-1]))


def splice_embeds(
    text_embeds: torch.Tensor,
    kind: torch.Tensor,
    src_idx: torch.Tensor,
    video_tokens: Optional[torch.Tensor] = None,
    memory_tokens: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """text_embeds [B, L, D] (embedding of plan.text_ids); kind/src_idx
    [B, L]; video_tokens [B, Nv, D]; memory_tokens [B, Nm, D] -> [B, L, D]."""
    out = text_embeds
    for tokens, k in ((video_tokens, KIND_VIDEO), (memory_tokens, KIND_MEMORY)):
        if tokens is not None:
            gathered = _gather_tokens(tokens, src_idx).to(out.dtype)
            out = torch.where((kind == k)[..., None], gathered, out)
    return out
