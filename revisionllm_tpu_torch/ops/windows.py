"""Window slicing and frame subsampling over long feature tracks.

Host planning (NumPy) is a copy of revisionllm_tpu/ops/windows.py: the
stage-1 dense 50%-overlap windows, each linspace-resampled to a fixed frame
count. `gather_windows` is the torch gather that builds the whole window
batch on the device from the resident movie.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch


def linspace_indices(start: int, end: int, num: int) -> np.ndarray:
    """Integer linspace identical to np.linspace(..., dtype=int32) truncation."""
    return np.linspace(start, end, num, dtype=np.int32)


def num_windows_dense(ctx_l: int, clip_length: int) -> int:
    """Number of 50%-overlap windows."""
    return math.ceil(ctx_l / (clip_length // 2)) - 1


def dense_window_bounds(ctx_l: int, clip_length: int) -> List[Tuple[int, int]]:
    """(start, end) for each stage-1 dense window:
    start = i * clip_length//2 ; end = min(start + clip_length, ctx_l - 1)."""
    n = num_windows_dense(ctx_l, clip_length)
    bounds = []
    for i in range(n):
        start = max(i * (clip_length // 2), 0)
        end = min(i * (clip_length // 2) + clip_length, ctx_l - 1)
        bounds.append((start, end))
    return bounds


def window_frame_indices(
    bounds: List[Tuple[int, int]], num_frames: int
) -> np.ndarray:
    """[num_windows, num_frames] int32 gather plan: linspace inside each window."""
    if not bounds:
        return np.zeros((0, num_frames), dtype=np.int32)
    return np.stack([linspace_indices(s, e, num_frames) for s, e in bounds], axis=0)


def gather_windows(features: torch.Tensor, frame_indices) -> torch.Tensor:
    """features [ctx_l, d] on the device; frame_indices [num_windows,
    num_frames] -> [num_windows, num_frames, d], one gather on the device."""
    idx = torch.as_tensor(np.asarray(frame_indices), dtype=torch.long, device=features.device)
    return features[idx]


def timestamp_to_frame_token(duration: float, x: float, num_frames: int) -> str:
    """Timestamp (seconds within window) -> two-digit frame-index token string.

    Uses Python round() (banker's rounding) then clamps to num_frames-1 and
    left-pads to width 2 (reference revisionllm/train/dataset.py:806-811).
    """
    x = x / duration * num_frames
    s = str(min(round(x), num_frames - 1))
    if len(s) == 1:
        s = "0" + s
    return s
