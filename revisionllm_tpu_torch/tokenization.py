"""Multimodal prompt tokenization: splicing sentinel indices into token ids.

Host-side copy of `revisionllm_tpu/tokenization.py::tokenizer_image_token`:
the prompt is split on ``<video>`` / ``<memory>`` markers, each chunk is
tokenized separately, and the chunks are re-joined with the IMAGE (-200) /
MEMORY (-300) sentinel ids in between. The leading BOS of every chunk after
the first is dropped. `split_at_sentinels`, `KeywordStopper` and
`get_model_name_from_path` are host copies of the JAX package's helpers.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from revisionllm_tpu_torch.constants import (
    DEFAULT_IMAGE_TOKEN,
    DEFAULT_MEMORY_TOKEN,
    IMAGE_TOKEN_INDEX,
    MEMORY_TOKEN_INDEX,
)


def tokenizer_image_token(
    prompt: str,
    tokenizer,
    image_token_index: int = IMAGE_TOKEN_INDEX,
    return_numpy: bool = False,
):
    """Tokenize `prompt`, replacing ``<video>`` with `image_token_index` and
    (when present after the video marker) ``<memory>`` with MEMORY_TOKEN_INDEX."""
    image_chunks = prompt.split(DEFAULT_IMAGE_TOKEN)
    has_memory = len(image_chunks) > 1 and DEFAULT_MEMORY_TOKEN in image_chunks[1]

    if has_memory:
        prompt_chunks = [list(tokenizer(image_chunks[0]).input_ids)]
        for mc in image_chunks[1].split(DEFAULT_MEMORY_TOKEN):
            prompt_chunks.append(list(tokenizer(mc).input_ids))
    else:
        prompt_chunks = [list(tokenizer(chunk).input_ids) for chunk in image_chunks]

    def insert_separator(chunks, sep):
        out = []
        for i, c in enumerate(chunks):
            out.append(c)
            if i != len(chunks) - 1:
                out.append(sep)
        return out

    input_ids: List[int] = []
    offset = 0
    if prompt_chunks and prompt_chunks[0] and prompt_chunks[0][0] == tokenizer.bos_token_id:
        offset = 1
        input_ids.append(prompt_chunks[0][0])

    if has_memory:
        for x in insert_separator(prompt_chunks[:2], [image_token_index] * (offset + 1)):
            input_ids.extend(x[offset:])
        input_ids.append(MEMORY_TOKEN_INDEX)
        input_ids.extend(prompt_chunks[2])
    else:
        for x in insert_separator(prompt_chunks, [image_token_index] * (offset + 1)):
            input_ids.extend(x[offset:])

    if return_numpy:
        return np.asarray(input_ids, dtype=np.int32)
    return input_ids


def split_at_sentinels(input_ids: Sequence[int]) -> tuple:
    """Split a sentinel-carrying token id sequence into text segments:
    (segments, sentinel_kinds), where sentinel_kinds[i] ('image' or
    'memory') separates segment i from segment i + 1."""
    segments: List[List[int]] = [[]]
    kinds: List[str] = []
    for tok in input_ids:
        if tok == IMAGE_TOKEN_INDEX:
            kinds.append("image")
            segments.append([])
        elif tok == MEMORY_TOKEN_INDEX:
            kinds.append("memory")
            segments.append([])
        else:
            segments[-1].append(int(tok))
    return segments, kinds


class KeywordStopper:
    """Host-side stop-string check for a host-driven decode loop (the
    reference's KeywordsStoppingCriteria, mm_utils.py:89-112). `generate`
    stops on the eos id instead; this keeps the API."""

    def __init__(self, keywords: List[str], tokenizer):
        self.keywords = keywords
        self.tokenizer = tokenizer
        self.keyword_ids = []
        for kw in keywords:
            ids = list(tokenizer(kw).input_ids)
            if len(ids) > 1 and ids[0] == tokenizer.bos_token_id:
                ids = ids[1:]
            self.keyword_ids.append(ids)

    def should_stop(self, generated_ids: Sequence[int]) -> bool:
        gen = list(generated_ids)
        for ids in self.keyword_ids:
            if len(gen) >= len(ids) and gen[-len(ids):] == ids:
                return True
        text = self.tokenizer.decode(gen[-3:], skip_special_tokens=True)
        return any(kw in text for kw in self.keywords)


def get_model_name_from_path(model_path: str) -> str:
    """Checkpoint directory -> display name; a 'checkpoint-N' directory
    carries its parent's name (mm_utils.py:78-84)."""
    model_path = model_path.strip("/")
    parts = model_path.split("/")
    if parts[-1].startswith("checkpoint-"):
        return parts[-2] + "_" + parts[-1]
    return parts[-1]
