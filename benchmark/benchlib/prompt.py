"""The stage-1 prompt, worked out again for the plain reference: the
Vicuna v1 template with one user turn (a frozen copy of the layout of
revisionllm_tpu_torch/conversation.py:10-32, and of the question of
constants.py:25), tokenized by benchlib.tokenizer with the video marker
as one sentinel."""

from __future__ import annotations

from benchlib.tokenizer import BOS, word_id

SYSTEM = ("A chat between a curious user and an artificial intelligence assistant. "
          "The assistant gives helpful, detailed, and polite answers to the user's questions.")
QUESTIONS = {"mad_grounding": "During which frames can we see {}?"}
VIDEO = -200


def grounding_prompt_ids(sentence: str, question: str = "mad_grounding"):
    """Token ids with VIDEO where the window's frames go."""
    text = SYSTEM + " USER: <video>\n" + QUESTIONS[question].format(sentence) + " ASSISTANT:"
    ids = [BOS]
    for chunk_i, chunk in enumerate(text.split("<video>")):
        if chunk_i:
            ids.append(VIDEO)
        ids.extend(word_id(w) for w in chunk.split())
    return ids
