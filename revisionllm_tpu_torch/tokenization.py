"""Multimodal prompt tokenization: splicing sentinel indices into token ids.

Host-side copy of `revisionllm_tpu/tokenization.py::tokenizer_image_token`:
the prompt is split on ``<video>`` / ``<memory>`` markers, each chunk is
tokenized separately, and the chunks are re-joined with the IMAGE (-200) /
MEMORY (-300) sentinel ids in between. The leading BOS of every chunk after
the first is dropped.
"""

from __future__ import annotations

from typing import List

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
