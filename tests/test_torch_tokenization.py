"""Port parity for the tokenization helpers of
revisionllm_tpu_torch/tokenization.py (split_at_sentinels, KeywordStopper,
get_model_name_from_path) against revisionllm_tpu/tokenization.py's, on
the same inputs: equal outputs."""

import pytest

from revisionllm_tpu import tokenization as jtok
from revisionllm_tpu.utils.testing import FakeTokenizer as JTok
from revisionllm_tpu_torch import tokenization as ttok
from revisionllm_tpu_torch.constants import IMAGE_TOKEN_INDEX, MEMORY_TOKEN_INDEX
from revisionllm_tpu_torch.utils.testing import FakeTokenizer as TTok

PROMPTS = ["<video>\nwhen does it happen?", "plain text only",
           "A <video> then <memory> and more", "<video>"]


@pytest.mark.parametrize("prompt", PROMPTS)
def test_split_at_sentinels_matches_jax(prompt):
    ids = ttok.tokenizer_image_token(prompt, TTok())
    assert ids == jtok.tokenizer_image_token(prompt, JTok())
    got = ttok.split_at_sentinels(ids)
    assert got == jtok.split_at_sentinels(ids)
    segments, kinds = got
    assert len(segments) == len(kinds) + 1
    assert kinds == ["image" if t == IMAGE_TOKEN_INDEX else "memory" for t in ids
                     if t in (IMAGE_TOKEN_INDEX, MEMORY_TOKEN_INDEX)]


@pytest.mark.parametrize("generated", [
    [], [5], ["stop", "here"], ["words", "</s>"], ["a", "b", "###"], ["x", "ASSISTANT:"],
])
def test_keyword_stopper_matches_jax(generated):
    """should_stop on token id runs (the words registered on both sides in
    the same order, so both tokenizers give the same ids)."""
    jt, tt = JTok(), TTok()
    kws = ["</s>", "###", "stop here"]
    js, ts = jtok.KeywordStopper(kws, jt), ttok.KeywordStopper(kws, tt)
    assert ts.keyword_ids == js.keyword_ids
    ids_j = [i for w in generated for i in (jt(w).input_ids[1:] if isinstance(w, str) else [w])]
    ids_t = [i for w in generated for i in (tt(w).input_ids[1:] if isinstance(w, str) else [w])]
    assert ids_t == ids_j
    assert ts.should_stop(ids_t) == js.should_stop(ids_j)


@pytest.mark.parametrize("path", ["/ckpt/vicuna-7b", "runs/stage1/checkpoint-500",
                                  "runs/stage1/checkpoint-500/", "model"])
def test_model_name_from_path_matches_jax(path):
    assert ttok.get_model_name_from_path(path) == jtok.get_model_name_from_path(path)
