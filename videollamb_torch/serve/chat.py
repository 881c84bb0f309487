"""High-level chat wrapper: load once, answer questions about a video.

Port of ``Chat.generate_text`` and ``Chat.ask_about_video`` of
``videollamb_tpu/serve/chat.py`` (reference llava/serve/cli.py:25-111):
conversation template -> ``tokenizer_x_token`` -> multimodal generate ->
stop-string trim, for a video or an image, of ``Chat.stream_text`` (the
gradio demo's per-token stream), of ``Chat.generate_speculative``
(prompt-lookup or draft-model speculation, greedy-exact) and of
``Chat.ask_mixed`` (video, image and audio blocks in one prompt, one
sentinel per tag in prompt order). Text lengths are padded to bucket
multiples, as in the JAX package. :class:`KVChatSession` ports the
multi-turn chat with KV reuse (``--kv-reuse``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from videollamb_torch.config import ModelConfig
from videollamb_torch.constants import DEFAULT_X_TOKEN, X_TOKEN_INDEX
from videollamb_torch.conversation import SeparatorStyle, conv_templates
from videollamb_torch.models.assembly import (
    MultimodalBatch,
    VideoLLaMB,
    prepare_multimodal_embeds,
)
from videollamb_torch.mm_utils import KeywordStopper, tokenizer_multi_x_token, tokenizer_x_token
from videollamb_torch.models.engine import generate, generate_spliced


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def media_batch(pixels, device, dtype) -> torch.Tensor:
    """A processed (T, C, H, W) clip or (C, H, W) image, a numpy array or a
    tensor (the device processor's), as a batch of one on ``device``."""
    return torch.as_tensor(pixels)[None].to(device, dtype)


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

    def _padded(self, ids):
        t = _round_up(len(ids), self.text_bucket)
        out = np.zeros((1, t), np.int64)
        mask = np.zeros((1, t), np.int64)
        out[0, : len(ids)] = ids
        mask[0, : len(ids)] = 1
        return out, mask

    def _prepare_ids(self, prompt: str, modality: str):
        return self._padded(tokenizer_x_token(prompt, self.tokenizer, X_TOKEN_INDEX[modality],
                                              return_tensors="np"))

    def _prepare_multi_ids(self, prompt: str):
        """Mixed-modality prompt -> (ids, mask, modalities): every
        <image> / <video> / <audio> tag becomes its own sentinel, in prompt
        order (``mm_utils.tokenizer_multi_x_token``)."""
        ids, modalities = tokenizer_multi_x_token(prompt, self.tokenizer, return_tensors="np")
        return (*self._padded(ids), modalities)

    def _batch(self, prompt: str, videos, images) -> MultimodalBatch:
        """The B = 1 batch of a prompt with a processed (T, C, H, W) clip or a
        (C, H, W) image; the prompt's tag is <video> when a clip is given."""
        ids, mask = self._prepare_ids(prompt, "VIDEO" if videos is not None else "IMAGE")
        dev = self.device
        return MultimodalBatch(
            input_ids=torch.from_numpy(ids).to(dev),
            attention_mask=torch.from_numpy(mask).to(dev),
            videos=media_batch(videos, dev, self.dtype) if videos is not None else None,
            images=media_batch(images, dev, self.dtype) if images is not None else None)

    def _answer(self, result, eos: int) -> str:
        n = int(result.lengths[0])
        tokens = result.tokens[0, :n].tolist()
        if tokens and tokens[-1] == eos:
            tokens = tokens[:-1]
        text = self.tokenizer.decode(tokens, skip_special_tokens=True).strip()
        return KeywordStopper([self.stop_str()], self.tokenizer).trim(text)

    def generate_text(self, prompt: str, *, videos: Optional[np.ndarray] = None,
                      images: Optional[np.ndarray] = None, max_new_tokens: int = 512,
                      temperature: float = 0.2, do_sample: bool = True, seed: int = 0) -> str:
        """One answer to ``prompt``; ``videos`` is a processed (T, C, H, W)
        clip, ``images`` a processed (C, H, W) image."""
        eos = int(self.tokenizer.eos_token_id or 2)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        result = generate(
            self.model, self.cfg, self._batch(prompt, videos, images), gen,
            max_new_tokens=max_new_tokens, do_sample=do_sample, temperature=temperature,
            eos_token_id=eos, pad_token_id=int(self.tokenizer.pad_token_id or 0),
            max_seq_len=self.cfg.max_length + _round_up(max_new_tokens, 64))
        return self._answer(result, eos)

    @torch.no_grad()
    def stream_text(self, prompt: str, *, videos=None, images=None,
                    max_new_tokens: int = 512, temperature: float = 0.2,
                    do_sample: bool = True, seed: int = 0):
        """Incremental generation: yields the partial decoded text after every
        token (the reference's TextIteratorStreamer path, gradio_demo.py:33-110).
        The same prefill and cached decode steps as ``generate_text``, with the
        loop on the host so a UI can render tokens as they arrive."""
        from videollamb_torch.models.engine import sample_token
        from videollamb_torch.models.lm.llama import (
            embed_tokens,
            init_kv_cache,
            llama_decode_step,
            llama_prefill,
        )

        dev = self.device
        spliced = prepare_multimodal_embeds(self.model, self.cfg,
                                            self._batch(prompt, videos, images))
        cache = init_kv_cache(self.cfg.lm, 1, self.cfg.max_length + _round_up(max_new_tokens, 64),
                              dtype=self.dtype, device=dev)
        lm = self.model.lm
        logits, cache = llama_prefill(lm, self.cfg.lm, spliced.embeds, spliced.attention_mask,
                                      cache)
        stopper = KeywordStopper([self.stop_str()], self.tokenizer)
        stop_ids = set(stopper.stop_token_ids())
        eos = int(self.tokenizer.eos_token_id or 2)
        gen = torch.Generator(device=dev).manual_seed(seed)
        toks = []
        for _ in range(max_new_tokens):
            nxt = int(sample_token(logits[:1].float(), gen, do_sample=do_sample,
                                   temperature=temperature, top_p=1.0)[0])
            if nxt == eos or nxt in stop_ids:
                break
            toks.append(nxt)
            text = self.tokenizer.decode(toks, skip_special_tokens=True)
            trimmed = stopper.trim(text)
            yield trimmed
            if trimmed != text.strip():
                break
            ids_t = torch.tensor([[nxt]], dtype=torch.long, device=dev)
            logits, cache = llama_decode_step(lm, self.cfg.lm,
                                              embed_tokens(lm, ids_t).to(cache.k.dtype), cache)

    @torch.no_grad()
    def generate_speculative(self, prompt: str, *, videos: Optional[np.ndarray] = None,
                             images: Optional[np.ndarray] = None,
                             max_new_tokens: int = 512, ngram: int = 3, k: int = 8,
                             draft_params=None, draft_cfg=None):
        """Greedy generation with speculative decoding (``models/speculative.py``):
        the text of greedy ``generate_text``, in fewer forward passes of the
        target. Prompt lookup by default; with ``draft_params`` (a whole model
        or an LM of the same hidden size, for instance an int8 copy of this
        one) the draft proposes and shares this model's spliced embeddings.
        Returns (text, stats)."""
        from videollamb_torch.models.lm.llama import init_kv_cache, llama_prefill
        from videollamb_torch.models.speculative import (
            speculative_decode,
            speculative_decode_draft,
        )

        dev = self.device
        modality = "VIDEO" if videos is not None else "IMAGE"
        spliced = prepare_multimodal_embeds(self.model, self.cfg,
                                            self._batch(prompt, videos, images))
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
            prompt_tokens = tokenizer_x_token(prompt, self.tokenizer, X_TOKEN_INDEX[modality],
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

    @torch.no_grad()
    def ask_mixed(self, question: str, blocks, first_turn: bool = True,
                  max_new_tokens: int = 512, temperature: float = 0.0,
                  do_sample: bool = False, seed: int = 0) -> str:
        """A mixed-modality turn. ``blocks`` is an ordered list of
        ("VIDEO"|"IMAGE"|"AUDIO", processed pixels): a video (T, C, H, W), an
        image or an audio mel image (C, H, W). On the first turn one tag per
        block is prepended to the question, beyond those it already places;
        the k-th tag binds the k-th block of its modality through the
        K-block splice (``models/assembly.encode_mixed``). Reference protocol:
        llava/eval/model_videoqa_act.py:117-120's (X, X_modalities)."""
        if first_turn:
            need: Dict[str, int] = {}
            for modality, _ in blocks:
                need[modality] = need.get(modality, 0) + 1
            for modality, _ in reversed(blocks):
                if question.count(DEFAULT_X_TOKEN[modality]) < need[modality]:
                    question = DEFAULT_X_TOKEN[modality] + "\n" + question
        self.conv.append_message(self.conv.roles[0], question)
        self.conv.append_message(self.conv.roles[1], None)
        ids, mask, tag_order = self._prepare_multi_ids(self.conv.get_prompt())
        if sorted(tag_order) != sorted(m for m, _ in blocks):
            raise ValueError(
                f"prompt tags {tag_order} do not match the supplied blocks "
                f"{[m for m, _ in blocks]}: every <image>/<video>/<audio> tag needs "
                "exactly one block of that modality")
        by_mod: Dict[str, list] = {}
        for modality, px in blocks:
            by_mod.setdefault(modality, []).append(px)
        dev = self.device
        ordered = tuple((m, torch.as_tensor(by_mod[m].pop(0)).to(dev, self.dtype))
                        for m in tag_order)
        batch = MultimodalBatch(input_ids=torch.from_numpy(ids).to(dev),
                                attention_mask=torch.from_numpy(mask).to(dev), blocks=ordered)
        eos = int(self.tokenizer.eos_token_id or 2)
        spliced = prepare_multimodal_embeds(self.model, self.cfg, batch)
        result = generate_spliced(
            self.model, self.cfg, spliced, torch.Generator(device=dev).manual_seed(seed),
            max_new_tokens=max_new_tokens, do_sample=do_sample, temperature=temperature,
            eos_token_id=eos, pad_token_id=int(self.tokenizer.pad_token_id or 0),
            max_seq_len=self.cfg.max_length + _round_up(max_new_tokens, 64))
        answer = self._answer(result, eos)
        self.conv.messages[-1][1] = answer
        return answer


class KVChatSession:
    """Multi-turn greedy video chat with KV reuse.

    ``Chat.ask_about_video`` re-encodes the video and re-prefills the whole
    conversation every turn. Here the first turn prefills once (tower, bridge
    and the prefill: kernels K1, K2 and K3 on the card) and each later turn
    extends the running cache with the new tokens only (``llama_extend``, as
    the streaming engine does).

    The session tracks the token ids whose K/V are in the cache. Each turn
    tokenizes the whole prompt again; when the cached ids are not a prefix of
    it (a tokenizer may merge across the answer / separator boundary), it
    prefills from scratch, so the answers are always those of a full
    re-prefill.
    """

    def __init__(self, chat: Chat, max_new_tokens: int = 512):
        self.chat = chat
        self.max_new_tokens = max_new_tokens
        self.cache = None
        self.logits = None
        self.cached_ids: list = []
        self.frames: Optional[np.ndarray] = None
        self.full_prefills = 0  # how often the full prefill ran
        self.extends = 0

    def _ids(self, prompt: str) -> list:
        return [int(t) for t in tokenizer_x_token(
            prompt, self.chat.tokenizer, X_TOKEN_INDEX["VIDEO"], return_tensors="np")]

    def _padded(self, ids: list):
        t = _round_up(len(ids), self.chat.text_bucket)
        arr = torch.zeros((1, t), dtype=torch.long)
        mask = torch.zeros((1, t), dtype=torch.long)
        arr[0, : len(ids)] = torch.tensor(ids, dtype=torch.long)
        mask[0, : len(ids)] = 1
        dev = self.chat.device
        return arr.to(dev), mask.to(dev)

    def _full_prefill(self, ids: list) -> None:
        from videollamb_torch.models.lm.llama import init_kv_cache, llama_prefill

        chat = self.chat
        arr, mask = self._padded(ids)
        batch = MultimodalBatch(
            input_ids=arr, attention_mask=mask,
            videos=media_batch(self.frames, chat.device, chat.dtype))
        spliced = prepare_multimodal_embeds(chat.model, chat.cfg, batch)
        self.cache = init_kv_cache(
            chat.cfg.lm, 1, chat.cfg.max_length + _round_up(self.max_new_tokens, 64),
            dtype=chat.dtype, device=chat.device)
        self.logits, self.cache = llama_prefill(chat.model.lm, chat.cfg.lm, spliced.embeds,
                                                spliced.attention_mask, self.cache)
        self.cached_ids = list(ids)
        self.full_prefills += 1

    def _extend(self, delta: list) -> None:
        from videollamb_torch.models.lm.llama import embed_tokens, llama_extend

        lm = self.chat.model.lm
        arr, mask = self._padded(delta)
        self.logits, self.cache = llama_extend(
            lm, self.chat.cfg.lm, embed_tokens(lm, arr).to(self.cache.k.dtype), mask,
            self.cache)
        self.cached_ids.extend(delta)
        self.extends += 1

    @torch.no_grad()
    def ask(self, question: str, frames: Optional[np.ndarray] = None,
            max_new_tokens: Optional[int] = None, speculative: bool = False) -> str:
        """One greedy turn. ``frames`` (processed (T, C, H, W)) are needed on
        the first call; later turns reuse the cached video K/V.

        ``speculative=True`` decodes by prompt-lookup speculation over the same
        session cache (``models/speculative.py``): a rollback shrinks
        ``cache.length``, and only committed tokens join ``cached_ids``."""
        from videollamb_torch.models.lm.llama import embed_tokens, llama_decode_step

        chat = self.chat
        if frames is not None:
            self.frames = frames
        first = self.cache is None
        if first:
            if self.frames is None:
                raise ValueError("the first turn of a KVChatSession needs frames")
            question = DEFAULT_X_TOKEN["VIDEO"] + "\n" + question
        chat.conv.append_message(chat.conv.roles[0], question)
        chat.conv.append_message(chat.conv.roles[1], None)
        ids = self._ids(chat.conv.get_prompt())

        if (not first and len(ids) > len(self.cached_ids)
                and ids[: len(self.cached_ids)] == self.cached_ids):
            self._extend(ids[len(self.cached_ids):])
        else:
            self._full_prefill(ids)

        stopper = KeywordStopper([chat.stop_str()], chat.tokenizer)
        stop_ids = set(stopper.stop_token_ids())
        eos = int(chat.tokenizer.eos_token_id or 2)
        budget = max_new_tokens or self.max_new_tokens
        lm = chat.model.lm

        if speculative:
            from videollamb_torch.models.speculative import speculative_decode

            toks, self.cache, self.logits, _ = speculative_decode(
                lm, chat.cfg.lm, self.cache, self.logits,
                [t for t in self.cached_ids if t >= 0],
                max_new_tokens=budget, eos_token_id=eos, stop_ids=stop_ids)
            self.cached_ids.extend(toks)
        else:
            toks = []
            logits = self.logits
            for _ in range(budget):
                nxt = int(torch.argmax(logits[0]))
                if nxt == eos or nxt in stop_ids:
                    break
                toks.append(nxt)
                # The fed token's K/V joins the cache: cached context for the
                # next turn's diff.
                ids_t = torch.tensor([[nxt]], dtype=torch.long, device=chat.device)
                logits, self.cache = llama_decode_step(
                    lm, chat.cfg.lm, embed_tokens(lm, ids_t).to(self.cache.k.dtype),
                    self.cache)
                self.cached_ids.append(nxt)
            self.logits = logits
        answer = stopper.trim(chat.tokenizer.decode(toks, skip_special_tokens=True).strip())
        chat.conv.messages[-1][1] = answer
        return answer
