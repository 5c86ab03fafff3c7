"""The one traffic generator: a mix's parameters (traffic/<mix>.json) and
the seed give the inputs of a run. Every seed gets the same sizes in
another order: the sentence lengths run through every length of the mix's
range once per cycle, shuffled by the seed, so each seed asks for the same
work."""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from benchlib.weights import generator, sub_seed


@dataclasses.dataclass
class Query:
    index: int
    movie: int
    sentence: str
    words: int
    query_feats: np.ndarray     # [tokens, d] f32
    query_cls: np.ndarray       # [d] f32, unit norm


def movie_features(mix, seed: int, movie: int, device) -> np.ndarray:
    """[movie_frames, feature_dim] f32 CLIP-like features of one movie,
    N(0, 1), drawn on `device` and returned on the host (the engine takes
    host features and keeps the movie resident by its key)."""
    g = generator(seed, f"movie{movie}", device)
    x = torch.randn((mix["movie_frames"], mix["feature_dim"]), generator=g, device=device)
    return x.cpu().numpy()


def queries(mix, seed: int, stream: str = "window") -> Iterator[Query]:
    """The endless query stream `stream` of a mix ("window", "warmup",
    "trace"): each query a sentence of seeded words, its T2V token
    features and CLS vector; the movie changes every queries_per_movie
    queries and cycles through the mix's movies."""
    rng = np.random.default_rng(sub_seed(seed, f"queries/{stream}"))
    lo, hi = mix["sentence_words"]
    lengths = []
    i = 0
    while True:
        if not lengths:
            lengths = list(rng.permutation(np.arange(lo, hi + 1)))
        n = int(lengths.pop())
        words = " ".join(f"w{int(k)}" for k in rng.integers(0, 5000, n))
        t = min(mix["query_tokens_max"], n + 2)
        qf = rng.standard_normal((t, mix["feature_dim"]), dtype=np.float32)
        qc = rng.standard_normal(mix["feature_dim"], dtype=np.float32)
        movie = (i // mix["queries_per_movie"]) % mix["movies"]
        yield Query(i, movie, words, n, qf, qc / np.linalg.norm(qc))
        i += 1


def warmup_queries(mix, seed: int):
    """The warm-up: one query of every sentence length of the mix, longest
    first, on movie 0: every shape the window will see, so that no kernel
    is chosen or loaded for the first time inside it."""
    lo, hi = mix["sentence_words"]
    gen = queries(mix, seed, "warmup")
    out = {}
    while len(out) < hi - lo + 1:
        q = next(gen)
        q.movie = 0
        out.setdefault(q.words, q)
    return [out[n] for n in range(hi, lo - 1, -1)]
