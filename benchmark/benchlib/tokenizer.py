"""The benchmark's tokenizer, which the program and the plain reference
both use: words split on whitespace, each word's id a hash of it below
ID_SPACE (so it lies in any configuration's vocabulary), BOS 1 first, EOS
2. Decoding is not its inverse: it maps a third of the ids to "to" and the
rest to numbers below 250, so a random model's answers parse as frame
spans about as often as a trained one's, and stage 1's proposal scoring
runs."""

from __future__ import annotations

import hashlib

BOS, EOS = 1, 2
FIRST_ID = 3
ID_SPACE = 32000


def word_id(word: str) -> int:
    h = int.from_bytes(hashlib.blake2b(word.encode(), digest_size=8).digest(), "little")
    return FIRST_ID + h % (ID_SPACE - FIRST_ID)


class _Encoded:
    def __init__(self, ids):
        self.input_ids = ids


class Tokenizer:
    bos_token_id = BOS
    eos_token_id = EOS

    def __call__(self, text: str):
        return _Encoded([BOS] + [word_id(w) for w in text.split()])

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        words = []
        for i in ids:
            i = int(i)
            if i < FIRST_ID:
                if skip_special_tokens:
                    continue
                words.append("</s>" if i == EOS else "<s>")
            else:
                words.append("to" if i % 3 == 0 else str(i % 250))
        return " ".join(words)
