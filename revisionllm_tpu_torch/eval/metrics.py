"""Answer parsing, IoU computation, and final metric aggregation: a copy of
revisionllm_tpu/eval/metrics.py, which imports no JAX.

Host-side pure functions over prediction records. The JSONL schema and every
numeric rule matches the reference so its offline aggregator consumes our logs
unchanged, and vice versa.

Parity targets:
- stage-1 answer parse + IoU: reference revisionllm/eval/eval_nlq_negative.py:79-112
- stage-2 answer parse + window-hit: reference
  revisionllm/eval/eval_nlq_retrieval_e2e2.py:109-139
- ranked recall metrics: reference
  revisionllm/eval/metric_retrieval_forward.py:35-56
- retrieval->grounding fusion: reference metric_retrieval_forward.py:107-183
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

SPAN_RE = re.compile(r"(\d+) (to|and) (\d+)")
SINGLE_RE = re.compile(r"(\d+)")


def parse_span(text: str) -> Optional[Tuple[int, int]]:
    """Parse 'From X to Y' / 'X and Y' style answers
    (reference eval_nlq_negative.py:87)."""
    m = SPAN_RE.search(text)
    if not m:
        return None
    return int(m.group(1)), int(m.group(3))


def parse_single(text: str) -> Optional[int]:
    """Parse the first integer (stage-2 'In video N' answers,
    reference eval_nlq_retrieval_e2e2.py:114)."""
    m = SINGLE_RE.search(text)
    return int(m.group(1)) if m else None


def stage1_iou(
    outputs: Sequence[str],
    gt: Tuple[float, float],
    num_frames_clip: int,
    num_frames_video: int,
    scores: Sequence[float],
    plus_baseline: bool = False,
):
    """Map per-window 'From X to Y' answers to global frames and IoU vs GT.

    Exact parity with `iou` (reference eval_nlq_negative.py:79-112) including
    the (249,249) skip, the same-frame widening, and the i*num_frames//2
    window offset. Returns (clip_frames dict, ious, filtered_scores).
    """
    frames: List[Tuple[int, int]] = []
    filter_scores: List[float] = []
    clip_frames: Dict[int, Tuple[int, int]] = {}
    for i, output in enumerate(outputs):
        key = i
        if plus_baseline and i == len(outputs) - 1:
            i = 0
        m = SPAN_RE.search(output)
        if not m:
            continue
        from_number = float(m.group(1))
        to_number = float(m.group(3))
        if from_number == num_frames_clip - 1 and to_number == num_frames_clip - 1:
            continue
        if from_number == to_number:
            from_number = max(0, from_number - 1)
            to_number = min(num_frames_video, to_number + 1)
        clip_frames[key if plus_baseline else i] = (int(from_number), int(to_number))
        from_g = int(i * num_frames_clip // 2 + from_number)
        to_g = int(i * num_frames_clip // 2 + to_number)
        frames.append((from_g, to_g))
        if len(scores) > 0:
            filter_scores.append(scores[key if plus_baseline else i])

    s, e = gt
    ious = []
    for f_raw, t_raw in frames:
        f, t = f_raw / num_frames_video, t_raw / num_frames_video
        intersection = max(0, min(t, e) - max(f, s))
        union = max(t, e) - min(f, s)
        ious.append(round(intersection / union, 2))
    return clip_frames, ious, filter_scores


def stage2_window_hit(
    outputs: Sequence[str],
    gt_windows: Sequence[int],
    starts: Sequence[int],
    indexes: Sequence[Sequence[int]],
    hierarchy_zooms: Sequence[int],
    grounding_windows: Sequence[int],
    num_frames_video: int,
):
    """Un-permute stage-2 'In video N' answers and check GT window overlap.

    Parity: `iou` (reference eval_nlq_retrieval_e2e2.py:109-139): predicted
    index is divided by the zoom factor, mapped back through the per-call
    random permutation, offset by the batch start, clamped, mapped through the
    grounding-window pre-filter, then widened by ±1; the metric is binary
    (any predicted window overlapping GT).
    """
    frames: List[Tuple[int, int]] = []
    clip_frames: Dict[int, Tuple[int, int]] = {}
    for i, output in enumerate(outputs):
        m = SINGLE_RE.search(output)
        if not m:
            continue
        from_number = int(m.group(1))
        from_number = from_number // hierarchy_zooms[i]
        if from_number < len(indexes[i]):
            from_number = int(indexes[i][from_number])
        from_number = starts[i] + from_number
        from_number = max(0, from_number)
        from_number = min(len(grounding_windows) - 1, from_number)
        from_number = grounding_windows[from_number]
        to_number = from_number
        from_number = max(0, from_number - 1)
        to_number = min(num_frames_video, to_number + 1)
        clip_frames[i] = (int(from_number), int(to_number))
        frames.append((from_number, to_number))

    s, e = min(gt_windows), max(gt_windows)
    overlaps = []
    for f, t in frames:
        overlaps.append(max(0, min(t, e) - max(f, s)))
    return clip_frames, [1] if sum(overlaps) > 0 else [0]


def stage2_chosen_windows(
    outputs: Sequence[str],
    starts: Sequence[int],
    indexes: Sequence[Sequence[int]],
    hierarchy_zooms: Sequence[int],
    call_in_zoom: Sequence[int],
    grounding_windows: Sequence[int],
    num_videos,
) -> List[Optional[List[int]]]:
    """Which window(s) of each stage-2 pass get CLIP-cosine scored.

    Exact parity with the in-loop score_cos selection of reference
    eval_nlq_retrieval_e2e2.py:360-386, INCLUDING its quirk: the reference
    indexes the accumulating `starts`/`indexes`/`hierarchy_zooms` lists by the
    call counter `i` of the CURRENT zoom's inner loop (:339), so passes of
    later zooms resolve against the FIRST zoom's entries. `call_in_zoom[p]`
    carries that within-zoom counter for pass p.

    Per pass: None means no integer parsed (the reference emits a literal 0.0
    score, :366,386); otherwise the list of window indices n with
    feat[:, n] scored — range(max(0, gw-1), min(gw+1, num_videos-1)) after
    mapping the parsed index through zoom division, un-permutation, batch
    start offset, clamping, and the grounding-window pre-filter (:369-381).

    num_videos may be a single int or a per-pass sequence: the reference
    clamps with the CURRENT pass's len(feat[0]) (:377), which differs across
    passes when eval batch is not divisible by a zoom factor (ADVICE r2).
    """
    per_pass_nv = not isinstance(num_videos, int)
    chosen: List[Optional[List[int]]] = []
    for p, output in enumerate(outputs):
        m = SINGLE_RE.search(output)
        if not m:
            chosen.append(None)
            continue
        c = call_in_zoom[p]
        from_number = int(m.group(1)) // hierarchy_zooms[c]
        if from_number < len(indexes[c]):
            from_number = int(indexes[c][from_number])
        from_number = starts[c] + from_number
        from_number = max(0, from_number)
        from_number = min(len(grounding_windows) - 1, from_number)
        from_number = grounding_windows[from_number]
        to_number = from_number
        from_number = max(0, from_number - 1)
        nv = num_videos[p] if per_pass_nv else num_videos
        to_number = min(to_number + 1, nv - 1)
        chosen.append(list(range(from_number, to_number)))
    return chosen


def grounding_metrics_stream(all_logs: Iterable[dict]) -> Dict[str, float]:
    """Score-ranked R{1,5,10,50}@IoU{0.1..0.9} + mIoU over prediction logs.

    Parity: grounding_metrics_stream (reference
    metric_retrieval_forward.py:35-56). Proposals are sorted by descending
    score; mIoU uses the top-1 proposal.
    """
    ious = []
    for log in all_logs:
        try:
            scores = log["info"]["scores"]
            sorted_idx = sorted(range(len(scores)), key=lambda k: scores[k], reverse=True)
            ious.append(np.array([log["info"]["iou"][i] for i in sorted_idx]))
        except Exception:
            ious.append(np.array([log["info"]["iou"]]).reshape(-1))
    l = len(ious)
    if l == 0:
        return {}
    metrics: Dict[str, float] = {}
    metrics["mIoU"] = sum(u[0] for u in ious if len(u) >= 1) / l * 100
    for m in [0.1, 0.3, 0.5, 0.7, 0.9]:
        for r in [1, 5, 10, 50]:
            metrics[f"R{r}@{m}"] = 0.0
        for iou in ious:
            bools = iou > m
            for r in [1, 5, 10, 50]:
                metrics[f"R{r}@{m}"] += bools[:r].any() / l * 100
    return metrics


def grounding_metrics_simple(all_logs: Iterable[dict]) -> Dict[str, float]:
    """mIoU + R1@{0.1,0.3,0.5,0.7} over scalar-IoU logs
    (parity: calculate_result, reference eval_nlq_negative.py:344-368)."""
    logs = list(all_logs)
    ious = [x["info"]["iou"] for x in logs if x["task"] == "grounding" and x["info"]["iou"] != -1]
    flat = []
    for u in ious:
        flat.extend(u if isinstance(u, list) else [u])
    l = len(flat)
    if l == 0:
        return {}
    metrics = {"mIoU": sum(flat) / l * 100}
    for m in [0.1, 0.3, 0.5, 0.7]:
        metrics[f"R1@{m}"] = sum(iou >= m for iou in flat) / l * 100
    return metrics


def load_prediction_logs(path: str, distributed: int = 16) -> List[dict]:
    """Read sharded JSONL prediction logs, skipping malformed lines
    (parity: load_predictions, reference metric_retrieval_forward.py:59-79)."""
    paths = []
    if distributed > 0:
        for i in range(distributed):
            paths.append(os.path.join(path, f"predictions_streaming_{i}.txt"))
            paths.append(os.path.join(path, f"predictions_stream_{i}.txt"))
            paths.append(os.path.join(path, f"predictions_negative_{i}.txt"))
    else:
        paths.append(os.path.join(path, "predictions.txt"))
    logs = []
    for pp in paths:
        if os.path.isfile(pp):
            with open(pp) as f:
                for line in f:
                    try:
                        logs.append(json.loads(line))
                    except Exception:
                        pass
    return logs


def _json_default(o):
    # numpy scalars and arrays arrive from the engine's host reads
    if hasattr(o, "item") and getattr(o, "ndim", 1) == 0:
        return o.item()
    if hasattr(o, "tolist"):
        return o.tolist()
    raise TypeError(f"Object of type {type(o).__name__} is not JSON serializable")


def write_log(log_path: str, video_id, task: str, query_id, answer, info=None) -> None:
    """Append one prediction record — identical schema to the reference
    (eval_nlq_negative.py:115-125) so fusion tooling interoperates.
    NumPy/JAX scalars and arrays are coerced to plain JSON values."""
    log = {"video_id": video_id, "task": task, "query_id": query_id, "answer": answer}
    if info is not None:
        log["info"] = info
    with open(log_path, "a") as f:
        f.write(json.dumps(log, default=_json_default) + "\n")


def min_max_normalize(values: Sequence[float]) -> List[float]:
    """(v - min) / (max - min); identity when degenerate
    (reference metric_retrieval_forward.py:149-160)."""
    values = list(values)
    if not values:
        return values
    lo, hi = min(values), max(values)
    if lo == hi:
        return values
    return [(v - lo) / (hi - lo) for v in values]


def fuse_retrieval_grounding(
    grounding_logs: List[dict],
    retrieval_logs: List[dict],
    retrieval_logs2: Optional[List[dict]] = None,
    buffer: int = 0,
    stride_ratio: float = 0.4,
    single: bool = True,
) -> Tuple[List[dict], float]:
    """Intersect stage-1 grounding proposals with stage-2 retrieval hits.

    For each query: map every retrieval window hit (rl.info.frames values) to
    the grounding window index range via the stride ratio (0.4), keep only
    grounding answers inside the retrieved regions, min-max normalize the
    grounding scores, and override answer/iou/scores in place. Returns the
    fused logs plus the selected/total window ratio.

    Parity: the __main__ fusion loop of reference
    metric_retrieval_forward.py:107-186 (including the quirk that scores are
    normalized over ALL grounding scores before sub-selection, and that the
    override only happens when some kept answer is not 'Not Present').
    """
    retrieval_dict = {rl["query_id"]: rl for rl in retrieval_logs}
    retrieval_dict2 = {rl["query_id"]: rl for rl in (retrieval_logs2 or [])}

    fused: List[dict] = []
    total: List[int] = []
    selected: List[int] = []
    for gl in grounding_logs:
        if gl["query_id"] not in retrieval_dict:
            continue
        rl = retrieval_dict[gl["query_id"]]
        frames: List[int] = []
        gl_idx = [
            i for i, a in enumerate(gl["answer"]) if a != "Not Present" and a != "From 249 to 249."
        ]
        if len(gl["info"].get("iou", [])) != len(gl_idx):
            # malformed record: an answer that is neither 'Not Present' nor a
            # parseable span (an untrained model can emit these; a trained one
            # cannot). The reference crashes on the misaligned gl_idx lookup
            # (:145); we keep the record unfused instead.
            total.append(len(gl["answer"]))
            selected.append(len(gl["answer"]))
            fused.append(gl)
            continue
        if single:
            for output in list(rl["info"]["frames"].values()):
                frames.extend(
                    range(
                        max(0, int(stride_ratio * output[0]) - buffer),
                        min(int(stride_ratio * output[1]) + buffer, len(gl["answer"]) - 1),
                    )
                )
            present_idx1 = [i for i in gl_idx if i in frames]
            rl2 = retrieval_dict2.get(gl["query_id"])
            if rl2 is not None and "frames" in rl2["info"]:
                for output in list(rl2["info"]["frames"].values()):
                    frames.extend(
                        range(
                            max(0, int(stride_ratio * output[0]) - buffer),
                            min(int(stride_ratio * output[1]) + buffer, len(gl["answer"]) - 1),
                        )
                    )
        else:
            present_idx1 = []
            for output in rl["answer"]:
                span = parse_span(output)
                if span:
                    frames.extend(
                        range(max(0, span[0] - buffer), min(span[1] + buffer, len(gl["answer"]) - 1))
                    )
        frames = list(set(frames))
        total.append(len(gl["answer"]))
        present_idx = [i for i in gl_idx if i in frames]
        if len(present_idx1) > 0 and buffer != -1:
            answer = [gl["answer"][i] for i in present_idx]
            iou = [gl["info"]["iou"][gl_idx.index(i)] for i in present_idx]
            gl["info"]["scores"] = min_max_normalize(gl["info"]["scores"])
            if rl["info"].get("mean_entropy"):
                rl["info"]["mean_entropy"] = min_max_normalize(rl["info"]["mean_entropy"])
            scores = [gl["info"]["scores"][gl_idx.index(i)] for i in present_idx]
            for a in answer:
                if a != "Not Present":
                    gl["answer"] = answer
                    gl["info"]["iou"] = iou
                    gl["info"]["scores"] = scores
                    break
        selected.append(len(gl["answer"]))
        fused.append(gl)

    ratio = sum(selected) / sum(total) if total else 0.0
    return fused, ratio
