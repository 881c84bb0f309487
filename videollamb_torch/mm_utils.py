"""Host-side multimodal text utilities: tokenization with X-token splicing
and stop-keyword trimming.

A copy of the parts of ``videollamb_tpu/mm_utils.py`` that ``Chat`` and
the batch CLI use (reference llava/mm_utils.py: tokenizer_x_token
:185-204, KeywordsStoppingCriteria :236-268), with
``tokenizer_multi_x_token`` for mixed-modality prompts. The anyres helpers
stay with the JAX package (ROADMAP.md section A, item 7).
"""

from __future__ import annotations

import re
from typing import List, Optional, Sequence, Tuple

import numpy as np

from videollamb_torch.constants import DEFAULT_X_TOKEN, X_INDEX_TOKEN, X_TOKEN_INDEX


def tokenizer_x_token(
    prompt: str,
    tokenizer,
    x_token_index: int,
    return_tensors: Optional[str] = None,
):
    """Split the prompt on the modality token (``<image>``/``<video>``) and
    splice the negative sentinel index between the tokenized chunks, keeping
    a single BOS at the front (reference mm_utils.py:185-204)."""
    tag = f"<{X_INDEX_TOKEN[x_token_index].lower()}>"
    prompt_chunks = [tokenizer(chunk).input_ids for chunk in prompt.split(tag)]

    def insert_separator(chunks, sep):
        return [ele for pair in zip(chunks, [sep] * len(chunks)) for ele in pair][:-1]

    input_ids: List[int] = []
    offset = 0
    if prompt_chunks and prompt_chunks[0] and prompt_chunks[0][0] == tokenizer.bos_token_id:
        offset = 1
        input_ids.append(prompt_chunks[0][0])

    for chunk in insert_separator(prompt_chunks, [x_token_index] * (offset + 1)):
        input_ids.extend(chunk[offset:])

    if return_tensors is not None:
        if return_tensors == "np":
            return np.asarray(input_ids, dtype=np.int32)
        raise ValueError(f"Unsupported tensor type: {return_tensors}")
    return input_ids


def tokenizer_multi_x_token(
    prompt: str,
    tokenizer,
    return_tensors: Optional[str] = None,
) -> Tuple[object, List[str]]:
    """Mixed-modality prompt tokenization: split on every modality tag
    (``<image>`` / ``<video>`` / ``<audio>``) in order of appearance and
    splice each tag's own sentinel index, keeping one BOS at the front. The
    k-th sentinel binds visual block k in the splice (``models/splice.py``).

    Returns (input_ids, modalities), ``modalities`` the tag names (e.g.
    ["VIDEO", "IMAGE"]) in prompt order."""
    pat = re.compile("(" + "|".join(re.escape(t) for t in DEFAULT_X_TOKEN.values()) + ")")
    parts = pat.split(prompt)
    texts, tags = parts[0::2], parts[1::2]
    tag_to_mod = {v: k for k, v in DEFAULT_X_TOKEN.items()}
    modalities = [tag_to_mod[t] for t in tags]

    tok_chunks = [tokenizer(c).input_ids for c in texts]
    input_ids: List[int] = []
    offset = 0
    if tok_chunks and tok_chunks[0] and tok_chunks[0][0] == tokenizer.bos_token_id:
        offset = 1
        input_ids.append(tok_chunks[0][0])
    for i, chunk in enumerate(tok_chunks):
        input_ids.extend(chunk[offset:])
        if i < len(modalities):
            input_ids.append(X_TOKEN_INDEX[modalities[i]])

    if return_tensors is not None:
        if return_tensors == "np":
            return np.asarray(input_ids, dtype=np.int32), modalities
        raise ValueError(f"Unsupported tensor type: {return_tensors}")
    return input_ids, modalities


class KeywordStopper:
    """Host-side equivalent of the reference KeywordsStoppingCriteria
    (mm_utils.py:236-268): detect/trim stop keywords in decoded text."""

    def __init__(self, keywords: Sequence[str], tokenizer):
        self.keywords = list(keywords)
        self.tokenizer = tokenizer
        self.keyword_ids = []
        for keyword in keywords:
            ids = tokenizer(keyword).input_ids
            if len(ids) > 1 and ids[0] == tokenizer.bos_token_id:
                ids = ids[1:]
            self.keyword_ids.append(ids)

    def stop_token_ids(self) -> List[int]:
        """Single-token keywords usable as extra EOS ids."""
        return [ids[0] for ids in self.keyword_ids if len(ids) == 1]

    def trim(self, text: str) -> str:
        for keyword in self.keywords:
            idx = text.find(keyword)
            if idx >= 0:
                text = text[:idx]
        return text.strip()
