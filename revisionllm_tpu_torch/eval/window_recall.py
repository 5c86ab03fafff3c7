"""Coarse window-selection recall (CONE-style).

A copy of revisionllm_tpu/eval/window_recall.py.

Rebuild of the vestigial reference evaluator
(revisionllm/eval/evaluate_pre_filtered_window.py:31-87 — it imports a module
that does not exist in the repo): given per-query ranked window lists and GT
timestamps, report Rank@K recall of the GT window set. Useful for analyzing
the stage-2 retrieval pre-filter quality in isolation.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np


def ground_truth_window_ids(
    timestamps: Tuple[float, float], clip_length: float, max_v_l: int
) -> List[int]:
    start = timestamps[0] / clip_length
    end = timestamps[1] / clip_length
    slide = int(max_v_l / 2)
    return list(range(math.floor(start / slide), math.ceil(end / slide) + 1))


def window_selection_recall(
    query_id2windowidx: Dict[str, Sequence[int]],
    ground_truth: List[dict],
    topk: Sequence[int] = (1, 5, 10, 50),
    clip_length: float = 0.2,
    max_v_l: int = 900,
    match_number: bool = True,
) -> Dict[str, float]:
    """Rank@K: fraction of queries whose top-K ranked windows contain a GT
    window (parity: windows_selection, reference
    evaluate_pre_filtered_window.py:31-74)."""
    pred_qids = set(query_id2windowidx)
    gt_qids = {e["query_id"] for e in ground_truth}
    if match_number:
        if pred_qids != gt_qids:
            raise ValueError("qids in ground_truth and submission must match")
    else:
        shared = pred_qids & gt_qids
        query_id2windowidx = {k: v for k, v in query_id2windowidx.items() if k in shared}
        ground_truth = [e for e in ground_truth if e["query_id"] in shared]

    truth = {
        e["query_id"]: set(
            ground_truth_window_ids(tuple(e["timestamps"]), clip_length, max_v_l)
        )
        for e in ground_truth
    }
    max_k = max(topk)
    hits = np.zeros(len(topk))
    window_counts = []
    for qid, windows in query_id2windowidx.items():
        window_counts.append(len(windows))
        bools = [int(w in truth[qid]) for w in list(windows)[:max_k]]
        for i, k in enumerate(topk):
            hits[i] += int(any(bools[:k]))
    n = max(len(query_id2windowidx), 1)
    out = {f"Rank@{k}": float(hits[i] / n * 100) for i, k in enumerate(topk)}
    out["avg_windows"] = float(np.mean(window_counts)) if window_counts else 0.0
    out["median_windows"] = float(np.median(window_counts)) if window_counts else 0.0
    return out
