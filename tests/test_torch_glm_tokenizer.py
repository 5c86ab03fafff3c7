"""Port parity: the port's own copies of the SentencePiece runtime
(utils/spm.py), the ChatGLM2 tokenizer (tokenization_glm.py) and
`preprocess_glm` (data/preprocess.py) against revisionllm_tpu's, on a
`build_test_model` vocabulary written here (no download): the same model
bytes, pieces, ids, decoded text, special commands, ids and labels."""

import numpy as np
import pytest

from revisionllm_tpu import tokenization_glm as jtok
from revisionllm_tpu.data import preprocess as jpre
from revisionllm_tpu.utils import spm as jspm
from revisionllm_tpu_torch import tokenization_glm as ttok
from revisionllm_tpu_torch.data import preprocess as tpre
from revisionllm_tpu_torch.utils import spm as tspm

WORDS = ["when", "does", "the", "dog", "jump", "from", "to", "10", "20", "video",
         "happen", "it", "a", "man", "opens", "door"]
TEXTS = ["the dog jump", "when does it happen", "From 10 to 20.", "dog  Ω  door",
         "a man opens the old door", "", "   video   "]
CONVS = [
    [{"from": "human", "value": "<video>\nwhen does the dog jump"},
     {"from": "gpt", "value": "From 10 to 20."}],
    [{"from": "human", "value": "when does it happen"}, {"from": "gpt", "value": "it Ω"},
     {"from": "human", "value": "a man opens the door"}, {"from": "gpt", "value": "from 20"}],
]


@pytest.fixture(scope="module")
def model_file(tmp_path_factory):
    blob = tspm.build_test_model(WORDS)
    assert blob == jspm.build_test_model(WORDS)
    path = tmp_path_factory.mktemp("spm") / "tokenizer.model"
    path.write_bytes(blob)
    return str(path)


@pytest.mark.parametrize("with_bytes", [True, False])
def test_spm_matches_jax(model_file, with_bytes, tmp_path):
    path = model_file
    if not with_bytes:
        path = str(tmp_path / "nobytes.model")
        with open(path, "wb") as f:
            f.write(tspm.build_test_model(WORDS, with_bytes=False))
    t, j = tspm.SentencePieceModel.load(path), jspm.SentencePieceModel.load(path)
    assert t.pieces == j.pieces and t.vocab_size() == j.vocab_size()
    assert (t.unk_id(), t.bos_id(), t.eos_id()) == (j.unk_id(), j.bos_id(), j.eos_id())
    for text in TEXTS:
        assert t.encode_as_pieces(text) == j.encode_as_pieces(text), text
        ids = t.encode(text)
        assert ids == j.encode(text), text
        assert t.decode(ids) == j.decode(ids), text
    pieces = [("<unk>", 0.0, tspm.TYPE_UNKNOWN), ("a", -1.5, tspm.TYPE_NORMAL),
              ("<0x41>", -2.0, tspm.TYPE_BYTE)]
    assert tspm.serialize_model_proto(pieces) == jspm.serialize_model_proto(pieces)
    assert tspm.parse_model_proto(tspm.serialize_model_proto(pieces)) == \
        jspm.parse_model_proto(jspm.serialize_model_proto(pieces))


def test_chatglm_tokenizer_matches_jax(model_file):
    t, j = ttok.ChatGLMTokenizer(model_file), jtok.ChatGLMTokenizer(model_file)
    assert t.n_words == j.n_words and t.special_tokens == j.special_tokens
    for name in ("<bos>", "<eos>", "<pad>", "[gMASK]", "sop", "<|user|>", "<|assistant|>"):
        assert t.get_command(name) == j.get_command(name)
    for text in TEXTS:
        ids = t(text).input_ids
        assert ids == j(text).input_ids and ids[:2] == t.get_prefix_tokens()
        mixed = ids + [t.get_command("<|user|>")] + t.encode("the dog")
        for skip in (False, True):
            assert t.decode(mixed, skip_special_tokens=skip) == \
                j.decode(mixed, skip_special_tokens=skip)
    for i in range(t.n_words):
        assert t.convert_id_to_token(i) == j.convert_id_to_token(i)
    assert t.build_single_message("user", "", "when does it happen") == \
        j.build_single_message("user", "", "when does it happen")


@pytest.mark.parametrize("conv", range(len(CONVS)))
def test_preprocess_glm_matches_jax(model_file, conv):
    """[gMASK] sop, role commands, the <video> sentinel, labels on the
    assistant's turns only, shifted one right."""
    t = tpre.preprocess_glm(CONVS[conv], ttok.ChatGLMTokenizer(model_file))
    j = jpre.preprocess_glm(CONVS[conv], jtok.ChatGLMTokenizer(model_file))
    assert set(t) == set(j)
    for k in j:
        assert t[k].dtype == j[k].dtype
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    assert (t["labels"] != -100).any() and (t["labels"][:3] == -100).all()
