"""Conversation -> (input_ids, labels) preprocessing. A host copy of
revisionllm_tpu/data/preprocess.py: Vicuna v1 and ChatGLM2.

Parity target: preprocess_v1 (reference revisionllm/train/dataset.py:244-327):
conversations are rendered through the Vicuna v1 template, tokenized with
<video>/<memory> sentinel splicing, and human-turn tokens are masked to
IGNORE_INDEX so the LM loss covers only assistant answers. The reference
recovers instruction spans by re-splitting the rendered string and counting
tokens per piece (with its -2/+1 BOS adjustments); we reproduce that counting
exactly, including the mismatch warning that blanks the sample
(dataset.py:313-319).

`ignore_temporal` masks digit tokens out of the labels
(dataset.py:320-323).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from revisionllm_tpu_torch.constants import IGNORE_INDEX
from revisionllm_tpu_torch.conversation import CONV_VICUNA_V1
from revisionllm_tpu_torch.tokenization import tokenizer_image_token


def render_v1(conversations: Sequence[Dict[str, str]]) -> str:
    conv = CONV_VICUNA_V1
    roles = {"human": conv.roles[0], "gpt": conv.roles[1]}
    msgs = []
    source = list(conversations)
    if source and roles.get(source[0]["from"]) != conv.roles[0]:
        source = source[1:]
    for j, sentence in enumerate(source):
        role = roles[sentence["from"]]
        assert role == conv.roles[j % 2], "conversation roles must alternate"
        msgs.append((role, sentence["value"]))
    return conv.prompt(msgs)


def preprocess_v1(
    conversations: Sequence[Dict[str, str]],
    tokenizer,
    model_max_length: int = 2048,
    ignore_temporal: bool = False,
    has_image: bool = True,
) -> Dict[str, np.ndarray]:
    """Returns {"input_ids": [T] int32 (with -200/-300 sentinels),
    "labels": [T] int32}."""
    conv = CONV_VICUNA_V1
    prompt = render_v1(conversations)

    if has_image:
        ids = tokenizer_image_token(prompt, tokenizer)
    else:
        ids = list(tokenizer(prompt).input_ids)
    ids = ids[:model_max_length]
    input_ids = np.asarray(ids, np.int32)
    labels = input_ids.copy()

    # mask: everything except assistant responses
    sep = conv.sep + conv.roles[1] + ": "  # " ASSISTANT: "
    rounds = prompt.split(conv.sep2)
    cur = 1
    labels[:1] = IGNORE_INDEX
    total_len = len(input_ids)
    for rou in rounds:
        if rou == "":
            break
        parts = rou.split(sep)
        if len(parts) != 2:
            break
        parts[0] += sep
        if has_image:
            round_len = len(tokenizer_image_token(rou, tokenizer))
            instruction_len = len(tokenizer_image_token(parts[0], tokenizer)) - 2
        else:
            round_len = len(tokenizer(rou).input_ids)
            instruction_len = len(tokenizer(parts[0]).input_ids) - 2
        labels[cur : cur + instruction_len] = IGNORE_INDEX
        cur += round_len
    labels[cur:] = IGNORE_INDEX

    if cur < model_max_length and cur != total_len:
        # tokenization drift: drop supervision entirely (reference :313-319)
        labels[:] = IGNORE_INDEX

    if ignore_temporal:
        digit_ids = set()
        for i in range(10):
            toks = tokenizer(str(i)).input_ids
            digit_ids.add(toks[-1])
        mask = np.isin(input_ids, list(digit_ids))
        labels[mask] = IGNORE_INDEX

    return {"input_ids": input_ids, "labels": labels}


def preprocess_glm(
    conversations: Sequence[Dict[str, str]],
    tokenizer,
) -> Dict[str, np.ndarray]:
    """ChatGLM conversation preprocessing (parity: preprocess_glm,
    reference train/dataset.py:116-160): [gMASK] sop header, per-turn role
    command tokens, loss mask on assistant turns only, labels shifted one
    right by prepending False.

    `tokenizer` must expose `get_command(name)` and `eos_token_id` (the GLM
    tokenizer interface, tokenization_glm.ChatGLMTokenizer)."""
    tokens: list = [tokenizer.get_command("[gMASK]"), tokenizer.get_command("sop")]
    loss_masks: list = [0, 0]

    for conv in conversations:
        if conv["from"] == "human":
            role_token = tokenizer.get_command("<|user|>")
            loss = 0
        else:
            role_token = tokenizer.get_command("<|assistant|>")
            loss = 1
        # the GLM tokenizer prefixes 2 special tokens; drop them (reference :139)
        token_id = [role_token] + list(tokenizer_image_token(conv["value"], tokenizer))[2:]
        tokens.extend(token_id)
        loss_masks.extend([loss] * len(token_id))
    tokens.append(tokenizer.eos_token_id)
    loss_masks.append(0)

    loss_masks = [False] + loss_masks[:-1]
    labels = [(t if m else IGNORE_INDEX) for t, m in zip(tokens, loss_masks)]
    return {
        "input_ids": np.asarray(tokens, np.int32),
        "labels": np.asarray(labels, np.int32),
    }
