"""Window slicing and frame subsampling over long feature tracks.

Host planning (NumPy) is a copy of revisionllm_tpu/ops/windows.py: the
stage-1 dense 50%-overlap windows and the stage-2 strided windows, each
linspace-resampled to a fixed frame count, and the stage-2 ground-truth
window ids. `gather_windows` is the torch gather that builds the whole
window batch on the device from the resident movie.
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


def num_windows_strided(ctx_l: int, clip_length: int, stride: int) -> int:
    """Number of stride-overlap windows (stage-2 retrieval)."""
    return math.ceil(ctx_l / (clip_length // stride)) - 1


def strided_window_bounds(ctx_l: int, clip_length: int, stride: int) -> List[Tuple[int, int]]:
    """(start, end) per stage-2 window: start = i * clip_length // stride,
    end = min(start + clip_length, ctx_l - 1), and a short tail window's
    start shifted back so it is full length."""
    n = num_windows_strided(ctx_l, clip_length, stride)
    bounds = []
    for i in range(n):
        start = max(i * (clip_length // stride), 0)
        end = min(i * (clip_length // stride) + clip_length, ctx_l - 1)
        if end - start < clip_length:
            start = end - clip_length
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
    """features [ctx_l, d] on the device; frame_indices of any shape, such
    as [num_windows, num_frames] or stage-2's [rows, windows, num_frames]
    -> that shape plus d, one gather on the device."""
    idx = torch.as_tensor(np.asarray(frame_indices), dtype=torch.long, device=features.device)
    return features[idx]


def get_ground_truth_windows(start: float, end: float, duration: float) -> Tuple[List[int], int]:
    """GT seconds -> coarse retrieval window ids and the window count (clip
    length 0.2 s and a slide window of 450 units: the MAD retrieval grid)."""
    clip_len = 0.2
    start = start / clip_len
    end = end / clip_len
    slide_window_size = int(900 / 2)
    matched = list(
        range(math.floor(start / slide_window_size), math.ceil(end / slide_window_size) + 1)
    )
    duration = duration / clip_len
    duration = math.ceil(duration / slide_window_size) + 1
    return matched, duration


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
