"""Test doubles shipped with the package (no dependency on the test tree).

The smoke paths of the train/debug CLIs (`--model_base` absent) and the unit
tests both need a tokenizer stand-in; keeping it here means production code
never imports from `tests/`.
"""

from __future__ import annotations


class FakeTokenizer:
    """Word-level tokenizer with BOS=1 and EOS=2 ('</s>' split off like
    sentencepiece-llama does — the property preprocess_v1's label counting
    relies on)."""

    bos_token_id = 1
    eos_token_id = 2

    def __init__(self):
        self.vocab = {}
        self.inv = {}

    def _id(self, w):
        if w not in self.vocab:
            i = len(self.vocab) + 10
            self.vocab[w] = i
            self.inv[i] = w
        return self.vocab[w]

    def _word_ids(self, w):
        out = []
        while "</s>" in w:
            head, _, w = w.partition("</s>")
            if head:
                out.append(self._id(head))
            out.append(self.eos_token_id)
        if w:
            out.append(self._id(w))
        return out

    def __call__(self, text):
        class R:
            pass

        r = R()
        ids = [1]
        for w in text.split():
            ids.extend(self._word_ids(w))
        r.input_ids = ids
        return r

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(self.inv.get(i, "?") for i in ids if i > 2)
