"""Conversation -> (input_ids, labels) preprocessing for supervised training.

Port of ``videollamb_tpu/train/preprocess.py`` (reference
llava/train/train.py:346-677), host-side numpy: apply the conversation
template (v1, llama_2, mpt, plain, and the v0 "### " default), tokenize with
X-token splicing, and mask instruction spans with IGNORE_INDEX. The masking
arithmetic (the ``-2`` for the "ASSISTANT: " separator, the
legacy-tokenizer round-length adjustment, the mismatch warning that zeroes
the whole target) is kept exactly: it encodes what the released checkpoints
were trained on.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional

import numpy as np

from videollamb_torch import conversation as conversation_lib
from videollamb_torch.constants import (
    DEFAULT_X_TOKEN,
    DEFAULT_X_END_TOKEN,
    DEFAULT_X_START_TOKEN,
    IGNORE_INDEX,
    X_TOKEN_INDEX,
)
from videollamb_torch.mm_utils import tokenizer_x_token

try:
    import tokenizers as _tokenizers

    IS_TOKENIZER_GREATER_THAN_0_14 = tuple(
        int(x) for x in _tokenizers.__version__.split(".")[:2]
    ) >= (0, 14)
except Exception:  # pragma: no cover
    IS_TOKENIZER_GREATER_THAN_0_14 = True


def preprocess_multimodal(sources, *, is_multimodal: bool = True,
                          mm_use_x_start_end: bool = False,
                          version: str = "v1"):
    """Normalize X tokens: hoist to front with newline; optional start/end
    wrapping (reference train.py:317-343)."""
    if not is_multimodal:
        return sources
    for source in sources:
        for sentence in source:
            for default_token in DEFAULT_X_TOKEN.values():
                x = default_token[1:-1]
                if default_token in sentence["value"]:
                    sentence["value"] = sentence["value"].replace(default_token, "").strip()
                    sentence["value"] = default_token + "\n" + sentence["value"]
                    sentence["value"] = sentence["value"].strip()
                    if "mmtag" in version:
                        sentence["value"] = sentence["value"].replace(
                            default_token,
                            f"<{x.capitalize()}>" + default_token + f"<{x.capitalize()}>",
                        )
                    if mm_use_x_start_end:
                        wrapped = (DEFAULT_X_START_TOKEN[x.upper()] + default_token
                                   + DEFAULT_X_END_TOKEN[x.upper()])
                        sentence["value"] = sentence["value"].replace(default_token, wrapped)
    return sources


def _tokenize(prompt: str, tokenizer, x: Optional[str]) -> List[int]:
    if x is not None:
        return tokenizer_x_token(prompt, tokenizer, X_TOKEN_INDEX[x])
    return tokenizer(prompt).input_ids


def _apply_template(sources, conv) -> List[str]:
    roles = {"human": conv.roles[0], "gpt": conv.roles[1]}
    conversations = []
    for source in sources:
        if roles[source[0]["from"]] != conv.roles[0]:
            source = source[1:]
        conv.messages = []
        for j, sentence in enumerate(source):
            role = roles[sentence["from"]]
            assert role == conv.roles[j % 2]
            conv.append_message(role, sentence["value"])
        conversations.append(conv.get_prompt())
    return conversations


def _mask_rounds_two_style(
    conversations, input_ids, tokenizer, conv, x, model_max_length
) -> List[np.ndarray]:
    """Masking for TWO-style (vicuna v1) templates (train.py:466-511)."""
    targets = [ids.copy() for ids in input_ids]
    sep = conv.sep + conv.roles[1] + ": "
    for conversation, target in zip(conversations, targets):
        pad_id = tokenizer.pad_token_id if tokenizer.pad_token_id is not None else -1
        total_len = int(np.sum(target != pad_id))

        rounds = conversation.split(conv.sep2)
        cur_len = 1
        target[:cur_len] = IGNORE_INDEX
        for i, rou in enumerate(rounds):
            if rou == "":
                break
            parts = rou.split(sep)
            if len(parts) != 2:
                break
            parts[0] += sep
            round_len = len(_tokenize(rou, tokenizer, x))
            instruction_len = len(_tokenize(parts[0], tokenizer, x)) - 2
            if i != 0 and not getattr(tokenizer, "legacy", False) and IS_TOKENIZER_GREATER_THAN_0_14:
                round_len -= 1
                instruction_len -= 1
            target[cur_len: cur_len + instruction_len] = IGNORE_INDEX
            cur_len += round_len
        target[cur_len:] = IGNORE_INDEX

        if cur_len < model_max_length and cur_len != total_len:
            target[:] = IGNORE_INDEX
            print(f"WARNING: tokenization mismatch: {cur_len} vs. {total_len}. (ignored)")
    return targets


def preprocess_v1(sources, tokenizer, x: Optional[str] = None,
                  model_max_length: int = 2048) -> Dict[str, List[np.ndarray]]:
    conv = conversation_lib.default_conversation.copy()
    conversations = _apply_template(sources, conv)
    input_ids = [np.asarray(_tokenize(p, tokenizer, x), np.int32) for p in conversations]
    targets = _mask_rounds_two_style(
        conversations, input_ids, tokenizer, conv, x, model_max_length
    )
    return dict(input_ids=input_ids, labels=targets)


def preprocess_llama_2(sources, tokenizer, x: Optional[str] = None,
                       model_max_length: int = 2048) -> Dict[str, List[np.ndarray]]:
    conv = conversation_lib.default_conversation.copy()
    conversations = _apply_template(sources, conv)
    input_ids = [np.asarray(_tokenize(p, tokenizer, x), np.int32) for p in conversations]
    targets = [ids.copy() for ids in input_ids]
    sep = "[/INST] "
    for conversation, target in zip(conversations, targets):
        pad_id = tokenizer.pad_token_id if tokenizer.pad_token_id is not None else -1
        total_len = int(np.sum(target != pad_id))
        rounds = conversation.split(conv.sep2)
        cur_len = 1
        target[:cur_len] = IGNORE_INDEX
        for rou in rounds:
            if rou == "":
                break
            parts = rou.split(sep)
            if len(parts) != 2:
                break
            parts[0] += sep
            round_len = len(_tokenize(rou, tokenizer, x))
            instruction_len = len(_tokenize(parts[0], tokenizer, x)) - 2
            target[cur_len: cur_len + instruction_len] = IGNORE_INDEX
            cur_len += round_len
        target[cur_len:] = IGNORE_INDEX
        if cur_len < model_max_length and cur_len != total_len:
            target[:] = IGNORE_INDEX
            print(f"WARNING: tokenization mismatch: {cur_len} vs. {total_len}. (ignored)")
    return dict(input_ids=input_ids, labels=targets)


def preprocess_mpt(sources, tokenizer, x: Optional[str] = None,
                   model_max_length: int = 2048) -> Dict[str, List[np.ndarray]]:
    conv = conversation_lib.default_conversation.copy()
    conversations = _apply_template(sources, conv)
    input_ids = [np.asarray(_tokenize(p, tokenizer, x), np.int32) for p in conversations]
    targets = [ids.copy() for ids in input_ids]
    sep = conv.sep + conv.roles[1]
    for conversation, target in zip(conversations, targets):
        pad_id = tokenizer.pad_token_id if tokenizer.pad_token_id is not None else -1
        total_len = int(np.sum(target != pad_id))
        rounds = conversation.split(conv.sep)
        re_rounds = [conv.sep.join(rounds[:3])]
        for conv_idx in range(3, len(rounds), 2):
            re_rounds.append(conv.sep.join(rounds[conv_idx: conv_idx + 2]))
        cur_len = 0
        for i, rou in enumerate(re_rounds):
            if rou == "":
                break
            parts = rou.split(sep)
            if len(parts) != 2:
                break
            parts[0] += sep
            round_len = len(_tokenize(rou, tokenizer, x))
            instruction_len = len(_tokenize(parts[0], tokenizer, x)) - 1
            if i != 0 and getattr(tokenizer, "legacy", False) and IS_TOKENIZER_GREATER_THAN_0_14:
                round_len += 1
                instruction_len += 1
            target[cur_len: cur_len + instruction_len] = IGNORE_INDEX
            cur_len += round_len
        target[cur_len:] = IGNORE_INDEX
        if cur_len < model_max_length and cur_len != total_len:
            target[:] = IGNORE_INDEX
            print(f"WARNING: tokenization mismatch: {cur_len} vs. {total_len}. (ignored)")
    return dict(input_ids=input_ids, labels=targets)


def preprocess_plain(sources, tokenizer, x: Optional[str] = None) -> Dict[str, List[np.ndarray]]:
    default_token = DEFAULT_X_TOKEN[x]
    conversations = []
    for source in sources:
        assert len(source) == 2
        assert default_token in source[0]["value"]
        source[0]["value"] = default_token
        conversations.append(
            source[0]["value"] + source[1]["value"]
            + conversation_lib.default_conversation.sep
        )
    input_ids = [np.asarray(_tokenize(p, tokenizer, x), np.int32) for p in conversations]
    targets = [ids.copy() for ids in input_ids]
    for target, source in zip(targets, sources):
        tokenized_len = len(_tokenize(source[0]["value"], tokenizer, x))
        target[:tokenized_len] = IGNORE_INDEX
    return dict(input_ids=input_ids, labels=targets)


def _add_speaker_and_signal(header, source, get_conversation=True):
    BEGIN_SIGNAL = "### "
    END_SIGNAL = "\n"
    conversation = header
    for sentence in source:
        from_str = sentence["from"]
        if from_str.lower() == "human":
            from_str = conversation_lib.default_conversation.roles[0]
        elif from_str.lower() == "gpt":
            from_str = conversation_lib.default_conversation.roles[1]
        else:
            from_str = "unknown"
        sentence["value"] = BEGIN_SIGNAL + from_str + ": " + sentence["value"] + END_SIGNAL
        if get_conversation:
            conversation += sentence["value"]
    conversation += BEGIN_SIGNAL
    return conversation


def _mask_targets(target, tokenized_lens, speakers):
    cur_idx = tokenized_lens[0]
    tokenized_lens = tokenized_lens[1:]
    target[:cur_idx] = IGNORE_INDEX
    for tokenized_len, speaker in zip(tokenized_lens, speakers):
        if speaker == "human":
            target[cur_idx + 2: cur_idx + tokenized_len] = IGNORE_INDEX
        cur_idx += tokenized_len


def preprocess(sources, tokenizer, x: Optional[str] = None,
               model_max_length: int = 2048) -> Dict[str, List[np.ndarray]]:
    """Template dispatcher (reference train.py:632-677)."""
    conv = conversation_lib.default_conversation
    if conv.sep_style == conversation_lib.SeparatorStyle.PLAIN:
        return preprocess_plain(sources, tokenizer, x)
    if conv.sep_style == conversation_lib.SeparatorStyle.LLAMA_2:
        return preprocess_llama_2(sources, tokenizer, x, model_max_length)
    if conv.version.startswith("v1"):
        return preprocess_v1(sources, tokenizer, x, model_max_length)
    if conv.version == "mpt":
        return preprocess_mpt(sources, tokenizer, x, model_max_length)

    # Default (v0 "### " signal style).
    conversations = []
    srcs = copy.deepcopy(sources)
    for source in srcs:
        header = f"{conv.system}\n\n"
        conversations.append(_add_speaker_and_signal(header, source))
    input_ids = [np.asarray(_tokenize(p, tokenizer, x), np.int32) for p in conversations]
    targets = [ids.copy() for ids in input_ids]
    for target, source in zip(targets, srcs):
        tokenized_lens = [
            len(_tokenize(s, tokenizer, x))
            for s in [f"{conv.system}\n\n"] + [sent["value"] for sent in source]
        ]
        speakers = [sentence["from"] for sentence in source]
        _mask_targets(target, tokenized_lens, speakers)
    return dict(input_ids=input_ids, labels=targets)


def set_default_conversation(version: str) -> None:
    conversation_lib.default_conversation = conversation_lib.conv_templates[version]
