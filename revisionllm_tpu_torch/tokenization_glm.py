"""ChatGLM2 tokenizer runtime: the port's own copy of
revisionllm_tpu/tokenization_glm.py.

Rebuild of reference revisionllm/model/chatglm/tokenization_chatglm.py
(SPTokenizer + ChatGLMTokenizer over a sentencepiece `tokenizer.model`) on the
from-scratch SentencePiece runtime in utils/spm.py — the build image ships no
`sentencepiece`, and the GLM path must run end-to-end (preprocess_glm ->
generate) from just the model file.

Interface consumed by the pipeline (data/preprocess.py::preprocess_glm and
tokenization.tokenizer_image_token): `get_command(name)`, `eos_token_id`,
`__call__(text).input_ids` (with the [gMASK] sop prefix the reference's
build_inputs_with_special_tokens adds, :233-237), `decode(ids)`.

Known divergence from real sentencepiece: the underlying runtime applies
remove_extra_whitespaces + add_dummy_prefix but an IDENTITY NFKC table, so
exotic Unicode (full-width forms, compatibility ligatures) may tokenize
differently from the reference tokenizer (utils/spm.py docstring).
"""

from __future__ import annotations

from typing import List, Sequence

from revisionllm_tpu_torch.utils.spm import SentencePieceModel

ROLE_SPECIAL_TOKENS = ["<|system|>", "<|user|>", "<|assistant|>", "<|observation|>"]
SPECIAL_TOKENS = ["[MASK]", "[gMASK]", "[sMASK]", "sop", "eop"] + ROLE_SPECIAL_TOKENS


class _Encoding:
    def __init__(self, input_ids: List[int]):
        self.input_ids = input_ids


class ChatGLMTokenizer:
    """GLM tokenizer over a sentencepiece model file (reference :11-89)."""

    def __init__(self, model_path: str):
        self.sp = SentencePieceModel.load(model_path)
        n = self.sp.vocab_size()
        # special tokens appended after the sp vocab (reference :25-31)
        self.special_tokens = {}
        self.index_special_tokens = {}
        for tok in SPECIAL_TOKENS:
            self.special_tokens[tok] = n
            self.index_special_tokens[n] = tok
            n += 1
        self.n_words = n
        self.bos_token_id = self.sp.bos_id()
        self.eos_token_id = self.sp.eos_id()
        self.pad_token_id = self.sp.unk_id()

    def get_command(self, token: str) -> int:
        if token == "<bos>":
            return self.bos_token_id
        if token == "<eos>":
            return self.eos_token_id
        if token == "<pad>":
            return self.pad_token_id
        assert token in self.special_tokens, f"{token} is not a special token"
        return self.special_tokens[token]

    def get_prefix_tokens(self) -> List[int]:
        """[gMASK] sop (reference :190-192)."""
        return [self.get_command("[gMASK]"), self.get_command("sop")]

    def encode(self, text: str) -> List[int]:
        return self.sp.encode(text)

    def __call__(self, text: str) -> _Encoding:
        """Matches `tokenizer(chunk).input_ids` with special tokens added
        (reference build_inputs_with_special_tokens :233-237: prefix + ids).
        preprocess_glm drops the 2 prefix tokens per chunk (dataset.py:139)."""
        return _Encoding(self.get_prefix_tokens() + self.sp.encode(text))

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = False) -> str:
        """Special ids render as their token text (reference SPTokenizer.decode
        :58-70 always renders '<|user|>' etc., so that is the default
        here); sp control ids are dropped by the sp decoder. Pass
        skip_special_tokens=True to strip them instead."""
        text, buffer = "", []
        for t in ids:
            t = int(t)
            if t in self.index_special_tokens:
                if buffer:
                    text += self.sp.decode(buffer)
                    buffer = []
                if not skip_special_tokens:
                    text += self.index_special_tokens[t]
            else:
                buffer.append(t)
        if buffer:
            text += self.sp.decode(buffer)
        return text

    def convert_token_to_id(self, token: str) -> int:
        if token in self.special_tokens:
            return self.special_tokens[token]
        return self.sp.piece_to_id_fn(token)

    def convert_id_to_token(self, index: int) -> str:
        if index in self.index_special_tokens:
            return self.index_special_tokens[index]
        if index in (self.bos_token_id, self.eos_token_id, self.pad_token_id) or index < 0:
            return ""
        return self.sp.IdToPiece(index)

    def build_single_message(self, role: str, metadata: str, message: str) -> List[int]:
        assert role in ("system", "user", "assistant", "observation"), role
        return (
            [self.get_command(f"<|{role}|>")]
            + self.sp.encode(f"{metadata}\n")
            + self.sp.encode(message)
        )
