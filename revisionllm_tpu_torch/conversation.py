"""The Vicuna v1 prompt template, copied from revisionllm_tpu/conversation.py
(the SeparatorStyle.TWO layout every trained and evaluated config uses)."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Conversation:
    """``system + sep + role: msg + sep_i`` with alternating separators, and
    a bare ``role:`` (no trailing space) for an empty assistant slot."""

    system: str
    roles: Tuple[str, str]
    sep: str = " "
    sep2: str = "</s>"

    def prompt(self, messages: List[Tuple[str, Optional[str]]]) -> str:
        seps = [self.sep, self.sep2]
        ret = self.system + seps[0]
        for i, (role, message) in enumerate(messages):
            if message:
                ret += role + ": " + message + seps[i % 2]
            else:
                ret += role + ":"
        return ret

    def user_turn_prompt(self, query: str) -> str:
        """Single user turn awaiting an assistant answer."""
        return self.prompt([(self.roles[0], query), (self.roles[1], None)])

    @property
    def stop_str(self) -> str:
        """Generation stop string."""
        return self.sep2


CONV_VICUNA_V1 = Conversation(
    system=(
        "A chat between a curious user and an artificial intelligence assistant. "
        "The assistant gives helpful, detailed, and polite answers to the user's questions."
    ),
    roles=("USER", "ASSISTANT"),
)
