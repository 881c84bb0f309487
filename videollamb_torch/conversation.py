"""Conversation prompt templates.

Host-side prompt assembly, behaviorally matching the reference
(llava/conversation.py:19-119 ``get_prompt`` and the registry at :373).
The template *contents* (system strings, roles, separators) are data the
checkpoints were trained with and must match byte-for-byte; the code is a
fresh functional implementation. A copy of
``videollamb_tpu/conversation.py``, so both packages build the same prompts.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Tuple


class SeparatorStyle(enum.Enum):
    SINGLE = enum.auto()
    TWO = enum.auto()
    MPT = enum.auto()
    PLAIN = enum.auto()
    LLAMA_2 = enum.auto()


@dataclasses.dataclass
class Conversation:
    system: str
    roles: Tuple[str, str]
    messages: List[List[Optional[str]]]
    offset: int
    sep_style: SeparatorStyle = SeparatorStyle.SINGLE
    sep: str = "###"
    sep2: Optional[str] = None
    version: str = "Unknown"

    def get_prompt(self) -> str:
        messages = self.messages
        # Multimodal first message arrives as (text, images, mode); hoist the
        # <image> tag to the front (reference get_prompt:33-42).
        if messages and isinstance(messages[0][1], tuple):
            messages = [list(m) for m in self.messages]
            init_role, init_msg = messages[0]
            init_msg = init_msg[0].replace("<image>", "").strip()
            if "mmtag" in self.version:
                messages[0] = [init_role, init_msg]
                messages.insert(0, [self.roles[0], "<Image><image></Image>"])
                messages.insert(1, [self.roles[1], "Received."])
            else:
                messages[0] = [init_role, "<image>\n" + init_msg]

        def text_of(message):
            return message[0] if isinstance(message, tuple) else message

        style = self.sep_style
        if style == SeparatorStyle.SINGLE:
            out = self.system + self.sep
            for role, message in messages:
                if message:
                    out += role + ": " + text_of(message) + self.sep
                else:
                    out += role + ":"
            return out

        if style == SeparatorStyle.TWO:
            seps = (self.sep, self.sep2)
            out = self.system + seps[0]
            for i, (role, message) in enumerate(messages):
                if message:
                    out += role + ": " + text_of(message) + seps[i % 2]
                else:
                    out += role + ":"
            return out

        if style == SeparatorStyle.MPT:
            out = self.system + self.sep
            for role, message in messages:
                if message:
                    out += role + text_of(message) + self.sep
                else:
                    out += role
            return out

        if style == SeparatorStyle.LLAMA_2:
            def wrap_sys(msg):
                return f"<<SYS>>\n{msg}\n<</SYS>>\n\n" if msg else msg

            out = ""
            for i, (role, message) in enumerate(messages):
                if i == 0:
                    assert message, "first message should not be none"
                    assert role == self.roles[0], "first message should come from user"
                if message:
                    msg = text_of(message)
                    if i == 0:
                        msg = wrap_sys(self.system) + msg
                    if i % 2 == 0:
                        out += self.sep + f"[INST] {msg} [/INST]"
                    else:
                        out += " " + msg + " " + self.sep2
            return out.lstrip(self.sep)

        if style == SeparatorStyle.PLAIN:
            seps = (self.sep, self.sep2)
            out = self.system
            for i, (role, message) in enumerate(messages):
                if message:
                    out += text_of(message) + seps[i % 2]
            return out

        raise ValueError(f"Invalid style: {style}")

    def append_message(self, role: str, message: Optional[str]) -> None:
        self.messages.append([role, message])

    def copy(self) -> "Conversation":
        return Conversation(
            system=self.system,
            roles=tuple(self.roles),
            messages=[list(m) for m in self.messages],
            offset=self.offset,
            sep_style=self.sep_style,
            sep=self.sep,
            sep2=self.sep2,
            version=self.version,
        )

    def dict(self) -> dict:
        return {
            "system": self.system,
            "roles": self.roles,
            "messages": [
                [r, m[0] if isinstance(m, tuple) else m] for r, m in self.messages
            ],
            "offset": self.offset,
            "sep": self.sep,
            "sep2": self.sep2,
        }


def _conv(**kw) -> Conversation:
    kw.setdefault("messages", [])
    kw.setdefault("offset", 0)
    return Conversation(**kw)


conv_vicuna_v0 = _conv(
    system=(
        "A chat between a curious human and an artificial intelligence assistant. "
        "The assistant gives helpful, detailed, and polite answers to the human's questions."
    ),
    roles=("Human", "Assistant"),
    offset=2,
    sep_style=SeparatorStyle.SINGLE,
    sep="###",
)

conv_vicuna_v1 = _conv(
    system=(
        "A chat between a curious user and an artificial intelligence assistant. "
        "The assistant gives helpful, detailed, and polite answers to the user's questions."
    ),
    roles=("USER", "ASSISTANT"),
    version="v1",
    sep_style=SeparatorStyle.TWO,
    sep=" ",
    sep2="</s>",
)

conv_llama_2 = _conv(
    system=(
        "You are a helpful, respectful and honest assistant. Always answer as "
        "helpfully as possible, while being safe.  Your answers should not include "
        "any harmful, unethical, racist, sexist, toxic, dangerous, or illegal "
        "content. Please ensure that your responses are socially unbiased and "
        "positive in nature.\n\nIf a question does not make any sense, or is not "
        "factually coherent, explain why instead of answering something not "
        "correct. If you don't know the answer to a question, please don't share "
        "false information."
    ),
    roles=("USER", "ASSISTANT"),
    version="llama_v2",
    sep_style=SeparatorStyle.LLAMA_2,
    sep="<s>",
    sep2="</s>",
)

conv_llava_llama_2 = _conv(
    system=(
        "You are a helpful language and vision assistant. "
        "You are able to understand the visual content that the user provides, "
        "and assist the user with a variety of tasks using natural language."
    ),
    roles=("USER", "ASSISTANT"),
    version="llama_v2",
    sep_style=SeparatorStyle.LLAMA_2,
    sep="<s>",
    sep2="</s>",
)

conv_mpt = _conv(
    system=(
        "<|im_start|>system\nA conversation between a user and an LLM-based AI "
        "assistant. The assistant gives helpful and honest answers."
    ),
    roles=("<|im_start|>user\n", "<|im_start|>assistant\n"),
    version="mpt",
    sep_style=SeparatorStyle.MPT,
    sep="<|im_end|>",
)

conv_llava_plain = _conv(
    system="",
    roles=("", ""),
    sep_style=SeparatorStyle.PLAIN,
    sep="\n",
)

conv_llava_v0 = _conv(
    system=(
        "A chat between a curious human and an artificial intelligence assistant. "
        "The assistant gives helpful, detailed, and polite answers to the human's questions."
    ),
    roles=("Human", "Assistant"),
    sep_style=SeparatorStyle.SINGLE,
    sep="###",
)

conv_llava_v0_mmtag = _conv(
    system=(
        "A chat between a curious user and an artificial intelligence assistant. "
        "The assistant is able to understand the visual content that the user "
        "provides, and assist the user with a variety of tasks using natural "
        "language.The visual content will be provided with the following format: "
        "<Image>visual content</Image>."
    ),
    roles=("Human", "Assistant"),
    sep_style=SeparatorStyle.SINGLE,
    sep="###",
    version="v0_mmtag",
)

conv_llava_v1 = _conv(
    system=(
        "A chat between a curious human and an artificial intelligence assistant. "
        "The assistant gives helpful, detailed, and polite answers to the human's questions."
    ),
    roles=("USER", "ASSISTANT"),
    version="v1",
    sep_style=SeparatorStyle.TWO,
    sep=" ",
    sep2="</s>",
)

conv_llava_v1_mmtag = _conv(
    system=(
        "A chat between a curious user and an artificial intelligence assistant. "
        "The assistant is able to understand the visual content that the user "
        "provides, and assist the user with a variety of tasks using natural "
        "language.The visual content will be provided with the following format: "
        "<Image>visual content</Image>."
    ),
    roles=("USER", "ASSISTANT"),
    sep_style=SeparatorStyle.TWO,
    sep=" ",
    sep2="</s>",
    version="v1_mmtag",
)

conv_mistral_instruct = _conv(
    system="",
    roles=("USER", "ASSISTANT"),
    version="llama_v2",
    sep_style=SeparatorStyle.LLAMA_2,
    sep="",
    sep2="</s>",
)

conv_chatml_direct = _conv(
    system="<|im_start|>system\nAnswer the questions.",
    roles=("<|im_start|>user\n", "<|im_start|>assistant\n"),
    version="mpt",
    sep_style=SeparatorStyle.MPT,
    sep="<|im_end|>",
)

default_conversation = conv_vicuna_v1

conv_templates = {
    "default": conv_vicuna_v0,
    "v0": conv_vicuna_v0,
    "v1": conv_vicuna_v1,
    "vicuna_v1": conv_vicuna_v1,
    "llama_2": conv_llama_2,
    "mistral_instruct": conv_mistral_instruct,
    "chatml_direct": conv_chatml_direct,
    "mistral_direct": conv_chatml_direct,
    "plain": conv_llava_plain,
    "v0_plain": conv_llava_plain,
    "llava_v0": conv_llava_v0,
    "v0_mmtag": conv_llava_v0_mmtag,
    "llava_v1": conv_llava_v1,
    "v1_mmtag": conv_llava_v1_mmtag,
    "llava_llama_2": conv_llava_llama_2,
    "mpt": conv_mpt,
}
