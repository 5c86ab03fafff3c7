"""Port parity for dense captioning: GroundingEngine.caption_windows
(revisionllm_tpu_torch/eval/engine.py) against the JAX engine's on one tiny
f32 tree (the tests/test_engine_batch.py engine in both packages), equal
captions; and the copied metrics (eval/captioning.py) against the JAX
package's on the strings of tests/test_captioning.py, equal to the last
bit (pure Python on both sides)."""

import numpy as np
import pytest
import torch

from revisionllm_tpu.eval import captioning as jcap
from revisionllm_tpu_torch.eval import captioning as tcap

from torch_parity import engines

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def engs():
    return engines()


@pytest.mark.parametrize("frames,prompt", [(230, None), (40, "What happens here?"), (10, None)],
                         ids=["tail_chunk", "one_window_custom_prompt", "shorter_than_a_window"])
def test_caption_windows_matches_jax(engs, frames, prompt):
    """Every dense window of the movie captioned; the last chunk padded
    (230 frames: 11 windows, chunks of 4); a movie shorter than one window
    gives no answers."""
    jeng, teng = engs
    movie = np.random.default_rng(frames).normal(size=(frames, 16)).astype(np.float32)
    kw = {} if prompt is None else {"prompt": prompt}
    want = jeng.caption_windows(movie, movie_key="m", **kw)
    got = teng.caption_windows(movie, movie_key="m", **kw)
    assert got == want
    assert len(got["answers"]) == {230: 11, 40: 1, 10: 0}[frames]


PAIRS = [
    ("the cat sat on the mat", ["the cat sat on the mat"]),
    ("aaa bbb ccc ddd", ["www xxx yyy zzz"]),
    ("the cat sat", ["the cat sat on the mat"]),
    ("a b c d", ["a b c d"]),
    ("a c", ["a b c"]),
    ("", ["a b"]),
    ("a dog jumps over the fence", ["a dog jumps over the fence"]),
    ("the dogs jumping", ["the dog jumped"]),
    ("d c b a", ["a b c d"]),
    ("xyz qrs", ["completely different words"]),
]


@pytest.mark.parametrize("metric", ["bleu", "rouge_l", "meteor"])
def test_sentence_metrics_match_jax(metric):
    for cand, refs in PAIRS:
        assert getattr(tcap, metric)(cand, refs) == getattr(jcap, metric)(cand, refs)


def test_cider_tiou_and_event_metrics_match_jax():
    cands = {"k1": "a man rides a horse", "k2": "a dog barks loudly",
             "k3": "completely unrelated words here"}
    refs = {"k1": ["a man rides a horse"], "k2": ["a dog barks loudly"],
            "k3": ["a man rides a horse"]}
    assert tcap.CiderScorer().compute(cands, refs) == jcap.CiderScorer().compute(cands, refs)
    for a, b in (((0, 10), (0, 10)), ((0, 10), (5, 15)), ((0, 1), (5, 6))):
        assert tcap.tiou(a, b) == jcap.tiou(a, b)
    story = [{"timestamp": [0, 10], "sentence": "intro scene"},
             {"timestamp": [10, 20], "sentence": "main action"}]
    cases = [
        ({"v1": [{"timestamp": [0, 10], "sentence": "a man walks"}]},
         {"v1": [{"timestamp": [0, 10], "sentence": "a man walks"}]}),
        ({"v1": [{"timestamp": [50, 60], "sentence": "a man walks"}]},
         {"v1": [{"timestamp": [0, 10], "sentence": "a man walks"}]}),
        ({"v": [{"timestamp": [0, 10], "sentence": "a dog jumps"}]},
         {"v": [{"timestamp": [0, 10], "sentence": "the dog jumped"}]}),
        ({"v1": story}, {"v1": story}),
        ({"v1": []}, {"v1": [{"timestamp": [0, 1], "sentence": "x"}]}),
    ]
    for preds, gts in cases:
        assert tcap.eval_dvc(preds, gts) == jcap.eval_dvc(preds, gts)
        assert tcap.eval_dvc(preds, gts, tious=(0.5,)) == jcap.eval_dvc(preds, gts, tious=(0.5,))
        assert tcap.eval_soda(preds, gts) == jcap.eval_soda(preds, gts)
