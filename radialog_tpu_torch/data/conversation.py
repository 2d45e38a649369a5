"""Vicuna conversation templating (port of radialog_tpu/data/conversation.py,
copied as it is: ``Conversation``, ``SeparatorStyle``, the two system
strings, ``single_turn_prompt``, ``extract_assistant_reply`` and
``extract_report``).

Prompt format (v1.3, SeparatorStyle.TWO):

    {system} USER: {msg} ASSISTANT: {reply}</s>USER: ... ASSISTANT:
"""
from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Tuple

RADIALOG_SYSTEM = (
    "A chat between a curious user and an artificial intelligence assistant "
    "acting as an experienced radiologist. The assistant gives professional, "
    "detailed, and polite answers to the user's questions."
)

# the demo's shorter system string (no space between the two sentences, as
# in the reference's string concatenation)
DEMO_SYSTEM = (
    "A chat between a curious user and an artificial intelligence assistant."
    "The assistant gives professional, detailed, and polite answers to the "
    "user's questions."
)


class SeparatorStyle(enum.Enum):
    SINGLE = "single"
    TWO = "two"


@dataclasses.dataclass
class Conversation:
    system: str = RADIALOG_SYSTEM
    roles: Tuple[str, str] = ("USER", "ASSISTANT")
    messages: List[List[Optional[str]]] = dataclasses.field(default_factory=list)
    sep_style: SeparatorStyle = SeparatorStyle.TWO
    sep: str = " "
    sep2: str = "</s>"

    def append(self, role: str, message: Optional[str]) -> "Conversation":
        self.messages.append([role, message])
        return self

    def append_user(self, message: str) -> "Conversation":
        return self.append(self.roles[0], message)

    def append_assistant(self, message: Optional[str] = None) -> "Conversation":
        return self.append(self.roles[1], message)

    def get_prompt(self) -> str:
        if self.sep_style is SeparatorStyle.SINGLE:
            out = self.system
            for role, message in self.messages:
                if message:
                    out += f"{self.sep} {role}: {message}"
                else:
                    out += f"{self.sep} {role}:"
            return out
        if self.sep_style is SeparatorStyle.TWO:
            seps = (self.sep, self.sep2)
            out = self.system + seps[0]
            for i, (role, message) in enumerate(self.messages):
                if message:
                    out += f"{role}: {message}{seps[i % 2]}"
                else:
                    out += f"{role}:"
            return out
        raise ValueError(f"unknown separator style {self.sep_style}")

    def copy(self) -> "Conversation":
        return Conversation(system=self.system, roles=self.roles,
                            messages=[list(m) for m in self.messages],
                            sep_style=self.sep_style, sep=self.sep, sep2=self.sep2)


def single_turn_prompt(user_text: str, system: str = RADIALOG_SYSTEM) -> str:
    """The standard report-generation prompt."""
    conv = Conversation(system=system)
    conv.append_user(user_text)
    conv.append_assistant(None)
    return conv.get_prompt()


def extract_assistant_reply(decoded: str) -> str:
    """Text after the last 'ASSISTANT:' (multi-turn flows)."""
    return decoded.split("ASSISTANT:")[-1]


def extract_report(decoded: str) -> str:
    """The first assistant turn, without an optional leading 'report:' marker."""
    pred = decoded.split("ASSISTANT:")[1]
    for marker in ("report:", "Report:", "REPORT:"):
        if marker in pred:
            return pred.split(marker)[1]
    return pred
