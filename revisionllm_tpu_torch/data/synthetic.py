"""Synthetic grounding corpus: a tiny world where grounding is LEARNABLE.

A host copy of `make_synthetic_corpus` from revisionllm_tpu/data/synthetic.py
(the stream corpus and the tiny HF checkpoint builder wait).

Purpose: prove the full train -> export -> load -> eval chain actually
*learns to ground events* (the system-level claim no real-checkpoint run can
witness in this environment). Event spans carry a class-specific feature
pattern; the query names the class; a model that learns must answer
"From <s> to <e>" at the right frames, well above chance.

The corpus is emitted in the SAME on-disk formats the real pipeline consumes
(MAD-style annotations, npy feature tracks, npz query features), so it flows
through the standard converter (`data.converters.mad_to_records`), dataset,
collator, trainer, exporter, loader, and eval CLIs unchanged.

No reference counterpart — this is a from-scratch verification harness
(VERDICT r3 item 1); the record/feature formats mirror
reference eval_nlq_negative.py:150-177 and train/dataset.py:453-528.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import numpy as np


def pattern_directions(n_classes: int, d: int, rng: np.random.Generator) -> np.ndarray:
    """[C, d] orthonormal class directions (QR of a fixed-seed Gaussian)."""
    g = rng.normal(size=(d, n_classes))
    q, _ = np.linalg.qr(g)
    return q.T[:n_classes].astype(np.float32)


def _place_events(
    rng: np.random.Generator,
    n_events: int,
    duration: float,
    ev_min: float,
    ev_max: float,
    margin: float = 1.0,
) -> List[Tuple[float, float]]:
    """Non-overlapping event spans (seconds), separated by >= margin."""
    spans: List[Tuple[float, float]] = []
    attempts = 0
    while len(spans) < n_events:
        attempts += 1
        if attempts > 1000:
            raise RuntimeError("cannot place events; lower n_events or ev_max")
        # integer-second spans: the annotation matches the feature placement
        # exactly (no sub-frame boundary ambiguity the model cannot resolve)
        length = float(round(rng.uniform(ev_min, ev_max)))
        s = float(round(rng.uniform(0.0, duration - length)))
        e = s + length
        if all(e + margin < s2 or s - margin > e2 for s2, e2 in spans):
            spans.append((s, e))
    return spans


def make_synthetic_corpus(
    out_dir: str,
    *,
    n_train_movies: int = 24,
    n_val_movies: int = 8,
    n_classes: int = 4,
    duration: float = 540.0,
    fps: float = 1.0,
    d: int = 16,
    ev_min: float = 28.0,
    ev_max: float = 45.0,
    margin: float = 8.0,
    amplitude: float = 2.0,
    noise: float = 0.3,
    background: float = 0.5,
    n_query_tokens: int = 4,
    seed: int = 0,
) -> Dict[str, str]:
    """Write features/, queries/, train.json (records), val.json (MAD format).

    Every movie contains exactly one event per class; the query sentence for
    class c is "pattern {c}" and its cls feature IS the class direction (so
    the stage-1 cosine re-scoring is meaningful too). Validation movies are
    freshly sampled — unseen noise AND unseen event placements.

    Default geometry mirrors MAD scaled down: 540 s movies over the pinned
    90 s retrieval-window grid (ops.windows.get_ground_truth_windows — 450
    clips x 0.2 s), so the stage-2 window-hit accounting is exercised
    unchanged; stage-1 grounds 90 s windows at 16 frames (5.6 s/frame).

    Returns paths: {features, queries, train_json, val_json, val_ann}.
    """
    rng = np.random.default_rng(seed)
    dirs = pattern_directions(n_classes, d, rng)

    feat_dir = os.path.join(out_dir, "features")
    query_dir = os.path.join(out_dir, "queries")
    os.makedirs(feat_dir, exist_ok=True)
    os.makedirs(query_dir, exist_ok=True)

    T = int(round(duration * fps))

    def build_movie(vid: str, rng: np.random.Generator) -> Dict[str, Tuple[float, float]]:
        feats = background * rng.normal(size=(T, d)).astype(np.float32)
        spans = _place_events(rng, n_classes, duration, ev_min, ev_max, margin)
        gt: Dict[str, Tuple[float, float]] = {}
        for c, (s, e) in enumerate(spans):
            fs, fe = int(round(s * fps)), int(round(e * fps))
            n = max(fe - fs, 1)
            feats[fs : fs + n] = (
                amplitude * dirs[c][None, :]
                + noise * rng.normal(size=(n, d)).astype(np.float32)
            )
            gt[str(c)] = (s, e)
        np.save(os.path.join(feat_dir, vid + ".npy"), feats)
        return gt

    def annotations(movies: List[str], split_tag: int) -> Dict[str, dict]:
        ann: Dict[str, dict] = {}
        for mi, vid in enumerate(movies):
            # per-movie child rng: query jitter is independent of how many
            # movies the OTHER split has (see the build loop below)
            rng = np.random.default_rng([seed, 2 + split_tag, mi])
            gt = movie_gt[vid]
            for c in range(n_classes):
                qid = f"{vid}_c{c}"
                s, e = gt[str(c)]
                ann[qid] = {
                    "movie": vid,
                    "movie_duration": duration,
                    "timestamps": [round(s, 2), round(e, 2)],
                    "sentence": f"pattern {c}.",
                }
                # query features: tokens = jittered class direction,
                # cls = the class direction itself
                tok = (
                    dirs[c][None, :]
                    + 0.1 * rng.normal(size=(n_query_tokens, d)).astype(np.float32)
                )
                np.savez(
                    os.path.join(query_dir, qid + ".npz"),
                    token_features=tok.astype(np.float32),
                    cls_features=dirs[c],
                )
        return ann

    movie_gt: Dict[str, Dict[str, Tuple[float, float]]] = {}
    train_movies = [f"syn_train_{i:03d}" for i in range(n_train_movies)]
    val_movies = [f"syn_val_{i:03d}" for i in range(n_val_movies)]
    # Each movie gets a CHILD rng derived from (seed, split, index): the
    # train stream is bit-identical no matter how many validation movies are
    # requested (a shared sequential rng made --val_movies silently perturb
    # the train corpus — and full-budget training proved fragile to that).
    for i, vid in enumerate(train_movies):
        movie_gt[vid] = build_movie(vid, np.random.default_rng([seed, 0, i]))
    for i, vid in enumerate(val_movies):
        movie_gt[vid] = build_movie(vid, np.random.default_rng([seed, 1, i]))

    train_ann = annotations(train_movies, 0)
    val_ann = annotations(val_movies, 1)

    from revisionllm_tpu_torch.data.converters import mad_to_records

    records = mad_to_records(train_ann)
    train_json = os.path.join(out_dir, "train.json")
    with open(train_json, "w") as f:
        json.dump(records, f)
    val_json = os.path.join(out_dir, "val.json")
    with open(val_json, "w") as f:
        json.dump(val_ann, f)

    return {
        "features": feat_dir,
        "queries": query_dir,
        "train_json": train_json,
        "val_json": val_json,
        "n_queries_val": str(len(val_ann)),
    }
