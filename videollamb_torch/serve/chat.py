"""High-level chat wrapper: load once, answer questions about a video.

Port of ``Chat.generate_text`` and ``Chat.ask_about_video`` of
``videollamb_tpu/serve/chat.py`` (reference llava/serve/cli.py:25-111):
conversation template -> ``tokenizer_x_token`` -> multimodal generate ->
stop-string trim, and of ``Chat.generate_speculative`` (prompt-lookup or
draft-model speculation, greedy-exact). Text lengths are padded to bucket
multiples, as in the JAX package. KV reuse across turns, streaming and
mixed-modality turns are not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from videollamb_torch.config import ModelConfig
from videollamb_torch.constants import DEFAULT_X_TOKEN, X_TOKEN_INDEX
from videollamb_torch.conversation import SeparatorStyle, conv_templates
from videollamb_torch.models.assembly import MultimodalBatch, VideoLLaMB
from videollamb_torch.mm_utils import KeywordStopper, tokenizer_x_token
from videollamb_torch.models.engine import generate


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class Chat:
    def __init__(self, tokenizer, model: VideoLLaMB, cfg: ModelConfig,
                 processors: Dict[str, Any], conv_mode: str = "llava_v1",
                 text_bucket: int = 64):
        self.tokenizer = tokenizer
        self.model = model
        self.cfg = cfg
        self.processors = processors
        self.conv_mode = conv_mode
        self.text_bucket = text_bucket
        self.conv = conv_templates[conv_mode].copy()

    def reset(self) -> None:
        self.conv = conv_templates[self.conv_mode].copy()

    def stop_str(self) -> str:
        return (self.conv.sep if self.conv.sep_style != SeparatorStyle.TWO
                else self.conv.sep2)

    @property
    def device(self) -> torch.device:
        return next(self.model.lm.parameters()).device

    @property
    def dtype(self) -> torch.dtype:
        return next(self.model.lm.parameters()).dtype

    def _prepare_ids(self, prompt: str, modality: str):
        ids = tokenizer_x_token(prompt, self.tokenizer, X_TOKEN_INDEX[modality],
                                return_tensors="np")
        t = _round_up(len(ids), self.text_bucket)
        out = np.zeros((1, t), np.int64)
        mask = np.zeros((1, t), np.int64)
        out[0, : len(ids)] = ids
        mask[0, : len(ids)] = 1
        return out, mask

    def generate_text(self, prompt: str, *, videos: Optional[np.ndarray] = None,
                      max_new_tokens: int = 512, temperature: float = 0.2,
                      do_sample: bool = True, seed: int = 0) -> str:
        """One answer to ``prompt``; ``videos`` is a processed (T, C, H, W) clip."""
        ids, mask = self._prepare_ids(prompt, "VIDEO")
        dev = self.device
        batch = MultimodalBatch(
            input_ids=torch.from_numpy(ids).to(dev),
            attention_mask=torch.from_numpy(mask).to(dev),
            videos=(torch.from_numpy(np.asarray(videos)[None]).to(dev, self.dtype)
                    if videos is not None else None))
        stopper = KeywordStopper([self.stop_str()], self.tokenizer)
        eos = int(self.tokenizer.eos_token_id or 2)
        gen = torch.Generator(device=dev).manual_seed(seed)
        result = generate(
            self.model, self.cfg, batch, gen, max_new_tokens=max_new_tokens,
            do_sample=do_sample, temperature=temperature, eos_token_id=eos,
            pad_token_id=int(self.tokenizer.pad_token_id or 0),
            max_seq_len=self.cfg.max_length + _round_up(max_new_tokens, 64))
        n = int(result.lengths[0])
        tokens = result.tokens[0, :n].tolist()
        if tokens and tokens[-1] == eos:
            tokens = tokens[:-1]
        text = self.tokenizer.decode(tokens, skip_special_tokens=True).strip()
        return stopper.trim(text)

    @torch.no_grad()
    def generate_speculative(self, prompt: str, *, videos: Optional[np.ndarray] = None,
                             max_new_tokens: int = 512, ngram: int = 3, k: int = 8,
                             draft_params=None, draft_cfg=None):
        """Greedy generation with speculative decoding (``models/speculative.py``):
        the text of greedy ``generate_text``, in fewer forward passes of the
        target. Prompt lookup by default; with ``draft_params`` (a whole model
        or an LM of the same hidden size, for instance an int8 copy of this
        one) the draft proposes and shares this model's spliced embeddings.
        Returns (text, stats)."""
        from videollamb_torch.models.assembly import prepare_multimodal_embeds
        from videollamb_torch.models.lm.llama import init_kv_cache, llama_prefill
        from videollamb_torch.models.speculative import (
            speculative_decode,
            speculative_decode_draft,
        )

        ids, mask = self._prepare_ids(prompt, "VIDEO")
        dev = self.device
        batch = MultimodalBatch(
            input_ids=torch.from_numpy(ids).to(dev),
            attention_mask=torch.from_numpy(mask).to(dev),
            videos=(torch.from_numpy(np.asarray(videos)[None]).to(dev, self.dtype)
                    if videos is not None else None))
        spliced = prepare_multimodal_embeds(self.model, self.cfg, batch)
        max_len = self.cfg.max_length + _round_up(max_new_tokens, 64)
        cache = init_kv_cache(self.cfg.lm, 1, max_len, dtype=self.dtype, device=dev)
        logits, cache = llama_prefill(self.model.lm, self.cfg.lm, spliced.embeds,
                                      spliced.attention_mask, cache)
        stopper = KeywordStopper([self.stop_str()], self.tokenizer)
        common = dict(max_new_tokens=max_new_tokens,
                      eos_token_id=int(self.tokenizer.eos_token_id or 2),
                      stop_ids=set(stopper.stop_token_ids()), k=k)
        if draft_params is not None:
            d_cfg = draft_cfg or self.cfg.lm
            d_lm = getattr(draft_params, "lm", draft_params)
            d_cache = init_kv_cache(d_cfg, 1, max_len, dtype=self.dtype, device=dev)
            _, d_cache = llama_prefill(d_lm, d_cfg, spliced.embeds, spliced.attention_mask,
                                       d_cache)
            toks, _, _, stats = speculative_decode_draft(
                self.model, self.cfg.lm, cache, logits, draft_params=d_lm, draft_cfg=d_cfg,
                draft_cache=d_cache, **common)
        else:
            prompt_tokens = tokenizer_x_token(prompt, self.tokenizer, X_TOKEN_INDEX["VIDEO"],
                                              return_tensors="np")
            ctx = [int(t) for t in prompt_tokens if int(t) >= 0]
            toks, _, _, stats = speculative_decode(
                self.model, self.cfg.lm, cache, logits, ctx, ngram=ngram, **common)
        text = self.tokenizer.decode(toks, skip_special_tokens=True).strip()
        return stopper.trim(text), stats

    def ask_about_video(self, question: str, frames: np.ndarray, first_turn: bool = True,
                        speculative: Optional[str] = None, draft_params=None, draft_cfg=None,
                        **gen_kwargs) -> str:
        """frames: processed (T, C, H, W). Keeps the conversation across turns.

        ``speculative``: None (plain greedy or sampled generate), 'lookup'
        (prompt-lookup speculation) or 'draft' (draft-model speculation with
        ``draft_params``); both are greedy-exact."""
        if first_turn:
            question = DEFAULT_X_TOKEN["VIDEO"] + "\n" + question
        self.conv.append_message(self.conv.roles[0], question)
        self.conv.append_message(self.conv.roles[1], None)
        prompt = self.conv.get_prompt()
        if speculative:
            answer, _ = self.generate_speculative(
                prompt, videos=frames, max_new_tokens=gen_kwargs.get("max_new_tokens", 512),
                draft_params=draft_params if speculative == "draft" else None,
                draft_cfg=draft_cfg)
        else:
            answer = self.generate_text(prompt, videos=frames, **gen_kwargs)
        self.conv.messages[-1][1] = answer
        return answer
