"""Streaming-memory training support: visual memory construction. A host
copy of revisionllm_tpu/data/stream.py.

Host-side (NumPy) rebuild of the memory pooling in the reference trainer
(revisionllm/train/vtimellm_trainer.py:78-121): from clip1's frames, build the
`visual_memory` tokens clip2 sees, per memory_type:

- mean_pool:    mean over all frames -> [B, 1, d]
- gt_mean_pool: mean over the GT frame window (negatives: a random 5-50 frame
                window) -> [B, 1, d]
- gt_multi:     5 linspace-sampled frames from the GT window (negatives:
                random 10-50 frame window) -> [B, 5, d]
- multi_pool:   5 segment means over the whole clip -> [B, 5, d]

plus the natural-language prefix (constants.PREFIX[neg]) tokenized to a fixed
length. The rng draws come in the JAX package's order, so one seed gives the
same memory in both.
"""

from __future__ import annotations

from typing import List

import numpy as np

from revisionllm_tpu_torch.constants import PREFIX


def build_visual_memory(
    images: np.ndarray,
    start_end_frame: np.ndarray,
    neg: np.ndarray,
    memory_type: str,
    rng: np.random.Generator,
) -> np.ndarray:
    """images: [B, T, d]; start_end_frame: [B, 2]; neg: [B] (0 = negative).

    Returns [B, M, d] with M = 1 (mean pools) or 5 (multi modes)."""
    B, T, d = images.shape
    out: List[np.ndarray] = []
    for i in range(B):
        img = images[i]
        if memory_type == "mean_pool":
            out.append(img.mean(0, keepdims=True))
        elif memory_type == "gt_mean_pool":
            if neg[i] == 0:
                window = int(rng.integers(5, 51))
                start = int(rng.integers(0, max(T - window, 1)))
                out.append(img[start : start + window].mean(0, keepdims=True))
            else:
                s, e = int(start_end_frame[i, 0]), int(start_end_frame[i, 1])
                out.append(img[s : e + 1].mean(0, keepdims=True))
        elif memory_type == "gt_multi":
            if neg[i] == 0:
                window = int(rng.integers(10, 51))
                start = int(rng.integers(0, max(T - window - 1, 1)))
                end = start + window
            else:
                start, end = int(start_end_frame[i, 0]), int(start_end_frame[i, 1])
            idx = np.linspace(start, end, 5, dtype=np.int32)
            out.append(img[np.clip(idx, 0, T - 1)])
        elif memory_type == "multi_pool":
            bounds = np.linspace(0, T, 6, dtype=np.int32)
            out.append(
                np.stack(
                    [img[bounds[j] : max(bounds[j + 1], bounds[j] + 1)].mean(0) for j in range(5)]
                )
            )
        else:
            raise ValueError(f"unknown memory_type {memory_type!r}")
    return np.stack(out, axis=0)


def build_prefix_ids(neg: np.ndarray, tokenizer, max_len: int = 24) -> np.ndarray:
    """PREFIX[neg] tokenized + right-padded to a fixed length [B, P]
    (reference vtimellm_trainer.py:117-121)."""
    rows = []
    for n in neg.tolist():
        ids = list(tokenizer(PREFIX[int(n)]).input_ids)[:max_len]
        rows.append(ids + [0] * (max_len - len(ids)))
    return np.asarray(rows, np.int32)
