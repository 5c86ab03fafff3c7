"""Synthetic grounding corpus: a tiny world where grounding is LEARNABLE.

A host copy of `make_synthetic_corpus`, `make_stream_corpus` and
`build_tiny_hf_checkpoint` from revisionllm_tpu/data/synthetic.py.

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
from typing import Dict, List, Optional, Tuple

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


def make_stream_corpus(
    out_dir: str,
    *,
    n_train_movies: int = 48,
    n_val_movies: int = 16,
    n_classes: int = 4,
    duration: float = 540.0,
    fps: float = 1.0,
    d: int = 16,
    ev_len: float = 28.0,
    gap: float = 5.0,
    amplitude: float = 2.0,
    noise: float = 0.3,
    background: float = 0.5,
    seed: int = 0,
) -> Dict[str, str]:
    """Corpus where grounding is resolvable ONLY through clip-1 memory.

    Each movie has a TARGET event (class cT) flanked on BOTH sides by decoy
    events of a different class cD — the query sentence is the same generic
    "the pattern" for every record, so clip-2 alone shows 2-3 equally
    plausible events and nothing says which is asked about. The class
    identity lives ONLY in the visual memory pooled from clip 1 (whose crop
    contains the target; gt_mean_pool/mean_pool both carry cT's direction,
    reference vtimellm_trainer.py:78-121). A no-memory model's ceiling is
    ~1/2 (pick an event at random); a model that READS the memory matches
    its direction to the right span.

    Flanking decoys on both sides guarantee >=1 decoy inside (almost) any
    GT-containing debug_window crop, so the ambiguity survives the dataset's
    random cropping (dataset.py random crop, offset in [0, window-gt_len)).

    Writes the same on-disk formats as make_synthetic_corpus plus
    stream_eval.json (per-query target/decoy spans for the bespoke memory
    eval of the JAX package's scripts/stream_memory_demo.py).
    """
    rng = np.random.default_rng(seed)
    dirs = pattern_directions(n_classes, d, rng)

    feat_dir = os.path.join(out_dir, "features")
    os.makedirs(feat_dir, exist_ok=True)
    T = int(round(duration * fps))

    def build_movie(vid: str, rng: np.random.Generator):
        feats = background * rng.normal(size=(T, d)).astype(np.float32)
        cT = int(rng.integers(n_classes))
        cD = int((cT + 1 + rng.integers(n_classes - 1)) % n_classes)
        L = ev_len
        # target placed so both flanking decoys fit with margins
        lo = 8.0 + L + gap
        hi = duration - 8.0 - 2 * L - gap
        t0 = float(round(rng.uniform(lo, hi)))
        t1 = t0 + L
        spans = {
            "target": (t0, t1),
            "decoy_before": (t0 - gap - L, t0 - gap),
            "decoy_after": (t1 + gap, t1 + gap + L),
        }

        def paint(span, c):
            fs, fe = int(round(span[0] * fps)), int(round(span[1] * fps))
            n = max(fe - fs, 1)
            feats[fs : fs + n] = (
                amplitude * dirs[c][None, :]
                + noise * rng.normal(size=(n, d)).astype(np.float32)
            )

        paint(spans["target"], cT)
        paint(spans["decoy_before"], cD)
        paint(spans["decoy_after"], cD)
        np.save(os.path.join(feat_dir, vid + ".npy"), feats)
        return {"spans": {k: list(v) for k, v in spans.items()},
                "target_class": cT, "decoy_class": cD}

    def annotations(movies, info):
        ann = {}
        for vid in movies:
            s, e = info[vid]["spans"]["target"]
            ann[f"{vid}_q"] = {
                "movie": vid,
                "movie_duration": duration,
                "timestamps": [round(s, 2), round(e, 2)],
                "sentence": "the pattern.",  # generic: class is NOT named
            }
        return ann

    train_movies = [f"stream_train_{i:03d}" for i in range(n_train_movies)]
    val_movies = [f"stream_val_{i:03d}" for i in range(n_val_movies)]
    info: Dict[str, dict] = {}
    for i, vid in enumerate(train_movies):
        info[vid] = build_movie(vid, np.random.default_rng([seed, 0, i]))
    for i, vid in enumerate(val_movies):
        info[vid] = build_movie(vid, np.random.default_rng([seed, 1, i]))

    from revisionllm_tpu_torch.data.converters import mad_to_records

    train_json = os.path.join(out_dir, "train.json")
    with open(train_json, "w") as f:
        json.dump(mad_to_records(annotations(train_movies, info)), f)
    eval_json = os.path.join(out_dir, "stream_eval.json")
    with open(eval_json, "w") as f:
        json.dump({vid: info[vid] for vid in val_movies}, f)
    return {"features": feat_dir, "train_json": train_json,
            "eval_json": eval_json}


# ----------------------------------------------------------------- tokenizer

SYNTH_WORDS: List[str] = (
    ["<unk>", "<s>", "</s>", "<video>", "<memory>"]
    + [f"{i:02d}" for i in range(100)]      # two-digit frame tokens
    + [str(i) for i in range(10)]           # class digits in the question
    + "pattern from to not present in video during which frames can we see "
      "the happen does it when no yes A chat between a curious user and an "
      "artificial intelligence assistant . The gives helpful , detailed and "
      "polite answers questions USER ASSISTANT : ? ' s From To Not Present "
      "In Video".split()
)


def build_tiny_hf_checkpoint(
    out_dir: str,
    *,
    hidden_size: int = 128,
    num_layers: int = 2,
    num_heads: int = 4,
    intermediate_size: int = 256,
    extra_words: Optional[List[str]] = None,
    seed: int = 0,
) -> str:
    """Word-level-tokenizer tiny Llama checkpoint in HF format, the
    `--model_base` of synthetic runs (needs transformers and tokenizers,
    imported here: the GPU's machine may lack them)."""
    words = list(dict.fromkeys(SYNTH_WORDS + (extra_words or [])))
    vocab = {w: i for i, w in enumerate(words)}

    import torch
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import LlamaConfig as HFLlamaConfig
    from transformers import LlamaForCausalLM, PreTrainedTokenizerFast

    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    fast = PreTrainedTokenizerFast(
        tokenizer_object=tok, unk_token="<unk>", bos_token="<s>",
        eos_token="</s>",
    )
    fast.save_pretrained(out_dir)

    cfg = HFLlamaConfig(
        vocab_size=len(vocab), hidden_size=hidden_size,
        intermediate_size=intermediate_size, num_hidden_layers=num_layers,
        num_attention_heads=num_heads, num_key_value_heads=num_heads,
        max_position_embeddings=512, rms_norm_eps=1e-5,
    )
    torch.manual_seed(seed)
    model = LlamaForCausalLM(cfg)
    # random-init tiny bases only: the final RMSNorm bounds |h| ~ sqrt(D), so
    # with HF's 0.02-std lm_head the logit spread stays near 0.2 and a frozen
    # head never predicts confidently; pretrained heads have large rows
    with torch.no_grad():
        model.lm_head.weight.mul_(25.0)
    model.save_pretrained(out_dir)
    return out_dir
