"""Slot-based continuous-batching serving engine over a dense KV cache.

Port of the dense engine of ``videollamb_tpu/serve/server.py``: a fixed set
of cache slots decodes in lock-step while new requests prefill on their own
and take free slots.

- admission splices the request (tower, SceneTilling, bridge), prefills it
  at B=1 in 256-token chunks up to its real length and copies the rows into
  a free slot;
- one step advances every active slot by ``k`` tokens (greedy rows by
  argmax; sampled rows by temperature and nucleus sampling) and syncs with
  the host once per ``k`` tokens;
- finished slots free at once, and their rows are reused;
- with ``speculative="lookup"`` or ``"draft"`` an all-greedy batch advances
  by speculation rounds instead (``models/speculative.py``): each slot's
  proposals (prompt lookup on the host, or ``spec_k`` steps of a draft LM
  that keeps a second cache) are verified in one ragged cache-extend, and
  the tokens are the target's greedy chain.

:class:`ServingEngine` is also the base class of the paged engine
(``serve/paged.py``). Sampling draws from a ``torch.Generator``, so sampled
tokens differ from the JAX package's (``jax.random``); greedy tokens are
the same. Not ported yet, and refused by the batch CLI: prefix caching,
grammar and choice constraints, logit bias, penalties, min_tokens and
top_k, logprobs, multi-LoRA adapters, image, audio and mixed-modality rows.
"""

from __future__ import annotations

import dataclasses
import queue
from typing import Any, List, Optional

import numpy as np
import torch

from videollamb_torch.config import ModelConfig
from videollamb_torch.models.assembly import MultimodalBatch, VideoLLaMB, prepare_multimodal_embeds
from videollamb_torch.models.lm.llama import (
    KVCache,
    chunked_prefill,
    embed_tokens,
    init_kv_cache,
    llama_decode_step,
)


@dataclasses.dataclass
class Request:
    uid: Any
    batch: MultimodalBatch  # B=1
    max_new_tokens: int = 128
    temperature: float = 0.0
    top_p: float = 1.0
    # filled by the engine
    tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # Set when the engine drops the request without decoding it (e.g. a
    # prompt over the paged engine's per-sequence budget).
    error: Optional[str] = None
    # Called with (request, token) as each token is committed on the host.
    on_token: Any = None
    cancelled: bool = False
    # Engine-internal: (spliced batch, prompt length) kept while admission
    # waits for pages, so backpressure does not encode the video again.
    _spliced: Any = None


def insert_into_cache(batch_cache: KVCache, single: KVCache, slot: int) -> None:
    """Copy a prefilled B=1 cache into row ``slot`` of the batch cache (in
    place); the rest of the row is zeroed."""
    s_single = single.k.shape[2]
    for buf, row in ((batch_cache.k, single.k), (batch_cache.v, single.v)):
        buf[:, slot] = 0
        buf[:, slot, :s_single] = row[:, 0].to(buf.dtype)
    batch_cache.length[slot] = single.length[0]


def sample_rows(logits: torch.Tensor, generator: Optional[torch.Generator],
                temps: np.ndarray, top_ps: np.ndarray) -> torch.Tensor:
    """Next token per row: argmax where the temperature is 0, else a draw
    from the temperature-scaled logits restricted to the row's nucleus
    (top_p, HF semantics). ``temps`` and ``top_ps`` are host vectors."""
    nxt = torch.argmax(logits, dim=-1)
    hot = np.flatnonzero(temps > 0)
    if hot.size == 0:
        return nxt
    rows = torch.as_tensor(hot, device=logits.device)
    temp = torch.as_tensor(temps[hot], dtype=torch.float32, device=logits.device)
    top_p = torch.as_tensor(top_ps[hot], dtype=torch.float32, device=logits.device)
    scaled = logits[rows].float() / temp.clamp_min(1e-6)[:, None]
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    probs = torch.softmax(sorted_desc, dim=-1)
    keep_sorted = (torch.cumsum(probs, dim=-1) - probs) < top_p[:, None]
    threshold = torch.where(keep_sorted, sorted_desc, torch.inf).amin(dim=-1, keepdim=True)
    scaled = torch.where(scaled >= threshold, scaled, -torch.inf)
    draw = torch.multinomial(torch.softmax(scaled, dim=-1), 1, generator=generator)[:, 0]
    nxt[rows] = draw
    return nxt


def slot_sampling_vectors(slots):
    """(temps, top_ps) host vectors from the slot list; empty slots greedy."""
    temps = np.asarray([(r.temperature if r is not None else 0.0) for r in slots], np.float32)
    top_ps = np.asarray([(r.top_p if r is not None else 1.0) for r in slots], np.float32)
    return temps, top_ps


@torch.no_grad()
def greedy_decode_steps(model: VideoLLaMB, cfg: ModelConfig, logits: torch.Tensor,
                        cache: KVCache, k: int):
    """k greedy decode steps -> (tokens (B, k), logits, cache). Rows past
    their EOS decode garbage that the host discards."""
    toks = []
    for _ in range(k):
        nxt = torch.argmax(logits, dim=-1)
        toks.append(nxt)
        tok_embeds = embed_tokens(model.lm, nxt[:, None]).to(cache.k.dtype)
        logits, cache = llama_decode_step(model.lm, cfg.lm, tok_embeds, cache)
    return torch.stack(toks, dim=1), logits, cache


@torch.no_grad()
def sampled_decode_steps(model: VideoLLaMB, cfg: ModelConfig, logits: torch.Tensor,
                         cache: KVCache, k: int, generator: Optional[torch.Generator],
                         temps: np.ndarray, top_ps: np.ndarray):
    """k sampled steps (temperature-0 rows by argmax) -> (tokens, logits, cache)."""
    toks = []
    for _ in range(k):
        nxt = sample_rows(logits, generator, temps, top_ps)
        toks.append(nxt)
        tok_embeds = embed_tokens(model.lm, nxt[:, None]).to(cache.k.dtype)
        logits, cache = llama_decode_step(model.lm, cfg.lm, tok_embeds, cache)
    return torch.stack(toks, dim=1), logits, cache


class ServingEngine:
    def __init__(self, model: VideoLLaMB, cfg: ModelConfig, *, num_slots: int = 4,
                 eos_token_id: int = 2, seed: int = 0, speculative: Optional[str] = None,
                 spec_k: int = 8, draft_params=None, draft_cfg=None):
        # Batched speculation: an all-greedy batch verifies up to spec_k tokens
        # per slot in ONE ragged cache-extend (verify_chunks_batched).
        # - 'lookup': prompt-lookup proposals, matched on the host;
        # - 'draft': a draft LM (a module; same tokenizer AND hidden size, as
        #   the spliced prompt embeds feed its prefill too; for instance an
        #   int8 copy of the target) proposes on the device.
        if speculative not in (None, "lookup", "draft"):
            raise ValueError(f"speculative={speculative!r}: 'lookup' or 'draft'")
        if speculative == "draft":
            if draft_params is None or draft_cfg is None:
                raise ValueError("speculative='draft' needs draft_params and draft_cfg")
            if draft_cfg.hidden_size != cfg.lm.hidden_size:
                raise ValueError(
                    "draft hidden_size must match the target's "
                    f"({draft_cfg.hidden_size} != {cfg.lm.hidden_size}): "
                    "the spliced prompt embeds feed the draft prefill")
        self._init_slots(model, cfg, num_slots, eos_token_id, seed)
        self.speculative = speculative
        self.spec_k = spec_k
        self.max_seq_len = cfg.max_length + 512
        self.cache = init_kv_cache(cfg.lm, num_slots, self.max_seq_len, dtype=self._dtype,
                                   device=self.device)
        if speculative == "draft":
            self.draft_lm = getattr(draft_params, "lm", draft_params)
            self.draft_cfg = draft_cfg
            self.draft_cache = init_kv_cache(draft_cfg, num_slots, self.max_seq_len,
                                             dtype=self._dtype, device=self.device)

    def _init_slots(self, model: VideoLLaMB, cfg: ModelConfig, num_slots: int,
                    eos_token_id: int, seed: int) -> None:
        """State every engine shares; the cache runs in the LM's device and dtype."""
        self.model = model
        self.cfg = cfg
        self.num_slots = num_slots
        self.eos = eos_token_id
        weight = model.lm.model.embed_tokens.weight
        self.device, self._dtype = weight.device, weight.dtype
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.speculative: Optional[str] = None  # the dense engine may set it
        self.spec_rounds = 0
        self.spec_committed = 0
        self._spec_nxt0: Optional[np.ndarray] = None
        self.slots: List[Optional[Request]] = [None] * num_slots
        # Last logits per slot (B, V); rows of empty slots are garbage.
        self.logits = torch.zeros((num_slots, cfg.lm.vocab_size), dtype=torch.float32,
                                  device=self.device)
        self.pending: "queue.Queue[Request]" = queue.Queue()
        # Requests dropped at admission (cancelled or rejected); step()
        # returns them with the finished ones.
        self._dropped: List[Request] = []

    # ------------------------------------------------------------------
    def submit(self, request: Request) -> None:
        self.pending.put(request)

    def _free_slot(self) -> Optional[int]:
        for i, r in enumerate(self.slots):
            if r is None:
                return i
        return None

    def _splice(self, req: Request):
        """(spliced batch, prompt length) of a request, kept on it until admitted."""
        if req._spliced is None:
            spliced = prepare_multimodal_embeds(self.model, self.cfg, req.batch)
            req._spliced = (spliced, int(spliced.attention_mask.sum()))
        return req._spliced

    def _drop(self, req: Request, error: Optional[str] = None) -> None:
        req.done = True
        req.error = error
        req._spliced = None
        self._dropped.append(req)

    def _admit(self) -> None:
        while not self.pending.empty():
            slot = self._free_slot()
            if slot is None:
                return
            req = self.pending.get()
            if req.cancelled:
                self._drop(req)
                continue
            spliced, prompt_len = self._splice(req)
            req._spliced = None
            single = init_kv_cache(self.cfg.lm, 1, self.cfg.max_length, dtype=self._dtype,
                                   device=self.device)
            logits, single = chunked_prefill(
                self.model.lm, self.cfg.lm, spliced.embeds.to(self._dtype),
                spliced.attention_mask, single, lengths=[prompt_len])
            insert_into_cache(self.cache, single, slot)
            if self.speculative == "draft":
                # The draft tracks the same context from the same spliced embeds.
                dsingle = init_kv_cache(self.draft_cfg, 1, self.cfg.max_length,
                                        dtype=self._dtype, device=self.device)
                _, dsingle = chunked_prefill(
                    self.draft_lm, self.draft_cfg, spliced.embeds.to(self._dtype),
                    spliced.attention_mask, dsingle, lengths=[prompt_len])
                insert_into_cache(self.draft_cache, dsingle, slot)
            self.logits[slot] = logits[0]
            self.slots[slot] = req
            # Admission rewrote a logits row: the next-argmax carried between
            # speculation rounds is stale.
            self._spec_nxt0 = None

    def _active_mask(self) -> np.ndarray:
        return np.asarray([r is not None for r in self.slots])

    def has_work(self) -> bool:
        return any(r is not None for r in self.slots) or not self.pending.empty()

    def _drain_dropped(self) -> List[Request]:
        dropped, self._dropped = self._dropped, []
        return dropped

    def _commit_k_tokens(self, toks_host: np.ndarray, k: int,
                         finished: List[Request]) -> List[Request]:
        """Append each slot's tokens up to EOS or its budget, fire the
        streaming hooks and release finished slots."""
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            if req.cancelled:
                req.done = True
                finished.append(req)
                self._release(i)
                continue
            for t in range(k):
                tok = int(toks_host[i, t])
                req.tokens.append(tok)
                if req.on_token is not None:
                    req.on_token(req, tok)
                if tok == self.eos or len(req.tokens) >= req.max_new_tokens:
                    req.done = True
                    finished.append(req)
                    self._release(i)
                    break
        return finished

    def _release(self, slot: int) -> None:
        """Free a slot. Its cache row restarts at length 0: a free row keeps
        stepping with the batch, and the JAX package's out-of-range cache
        writes (dropped there) would be index errors here."""
        self.slots[slot] = None
        self.cache.length[slot] = 0
        if self.speculative == "draft":
            self.draft_cache.length[slot] = 0

    def _spec_context(self, req: Request) -> List[int]:
        """Token context for prompt-lookup proposals: the VALID text prompt ids
        (media sentinels included: they never collide with generated ids)
        plus everything generated so far. The bucket padding is cut off by the
        attention mask, so a tail n-gram near the end of the prompt proposes
        the real continuation, not pad zeros."""
        ctx = getattr(req, "_spec_prompt_ids", None)
        if ctx is None:
            n_valid = int(req.batch.attention_mask[0].sum())
            ctx = [int(t) for t in req.batch.input_ids[0, :n_valid].tolist()]
            req._spec_prompt_ids = ctx
        return ctx + req.tokens

    @torch.no_grad()
    def _step_speculative(self, dropped: List[Request]) -> List[Request]:
        """One speculation round: propose up to spec_k - 1 continuations per
        slot, verify all slots in ONE ragged cache-extend, commit each row's
        accepted prefix. The tokens are those of plain greedy decoding."""
        from videollamb_torch.models.speculative import (
            draft_propose_batched,
            propose_lookup,
            roll_draft_cache,
            verify_chunks_batched,
        )

        b, kk = self.num_slots, self.spec_k
        mask = np.zeros((b, kk), np.int64)
        if self.speculative == "draft":
            # Chunk column 0 is each row's committed-next token: the draft
            # loop embeds it first and emits it back.
            chunks_dev, self.draft_cache = draft_propose_batched(
                self.draft_lm, self.draft_cfg, torch.argmax(self.logits, dim=-1),
                self.draft_cache, kk)
            for i, r in enumerate(self.slots):
                if r is not None:
                    mask[i, :max(1, min(kk, r.max_new_tokens - len(r.tokens)))] = 1
            accepted, self.logits, _, self.cache = verify_chunks_batched(
                self.model, self.cfg, chunks_dev, torch.from_numpy(mask).to(self.device),
                self.cache)
            self.draft_cache = roll_draft_cache(self.draft_cache, accepted, kk)
            self.spec_rounds += 1
            return self._spec_commit(chunks_dev.cpu().numpy(), accepted.cpu().numpy(), dropped)

        # One host sync per round: nxt0 rides the PREVIOUS verify's readback,
        # unless an admission or a plain step rewrote the logits rows.
        nxt0 = self._spec_nxt0
        if nxt0 is None:
            nxt0 = torch.argmax(self.logits, dim=-1).cpu().numpy()
        chunks = np.zeros((b, kk), np.int64)
        for i, r in enumerate(self.slots):
            if r is None:
                continue
            chunks[i, 0] = nxt0[i]
            mask[i, 0] = 1
            room = min(kk - 1, r.max_new_tokens - len(r.tokens) - 1)
            if room > 0 and nxt0[i] != self.eos:
                prop = propose_lookup(self._spec_context(r) + [int(nxt0[i])], k=room)
                chunks[i, 1:1 + len(prop)] = prop
                mask[i, 1:1 + len(prop)] = 1
        accepted, self.logits, next_argmax, self.cache = verify_chunks_batched(
            self.model, self.cfg, torch.from_numpy(chunks).to(self.device),
            torch.from_numpy(mask).to(self.device), self.cache)
        acc_host = accepted.cpu().numpy()
        self._spec_nxt0 = next_argmax.cpu().numpy()
        self.spec_rounds += 1
        return self._spec_commit(chunks, acc_host, dropped)

    def _spec_commit(self, chunks: np.ndarray, acc_host: np.ndarray,
                     finished: List[Request]) -> List[Request]:
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            if req.cancelled:
                req.done = True
                finished.append(req)
                self._release(i)
                continue
            for t in range(int(acc_host[i])):
                tok = int(chunks[i, t])
                req.tokens.append(tok)
                # Count only the tokens DELIVERED: acceptance past an EOS or
                # the budget would overstate the statistics.
                self.spec_committed += 1
                if req.on_token is not None:
                    req.on_token(req, tok)
                if tok == self.eos or len(req.tokens) >= req.max_new_tokens:
                    req.done = True
                    finished.append(req)
                    self._release(i)
                    break
        return finished

    def _decode(self, k: int) -> torch.Tensor:
        """k decode steps of every slot -> tokens (B, k); updates logits and cache."""
        temps, top_ps = slot_sampling_vectors(self.slots)
        if (temps > 0).any():
            toks, self.logits, self.cache = sampled_decode_steps(
                self.model, self.cfg, self.logits, self.cache, k, self.generator, temps, top_ps)
        else:
            toks, self.logits, self.cache = greedy_decode_steps(
                self.model, self.cfg, self.logits, self.cache, k)
        return toks

    def step(self, k: int = 1) -> List[Request]:
        """Admit pending requests, advance every active slot by ``k`` tokens.
        Returns the requests finished (or dropped) in this step."""
        self._admit()
        dropped = self._drain_dropped()
        if not any(self._active_mask()):
            return dropped
        all_greedy = all(r is None or r.temperature == 0.0 for r in self.slots)
        if self.speculative in ("lookup", "draft") and all_greedy:
            return self._step_speculative(dropped)
        # A plain step rewrites the logits rows: the carried next-argmax is stale.
        self._spec_nxt0 = None
        toks = self._decode(k)
        return self._commit_k_tokens(toks.cpu().numpy(), k, dropped)

    def cancel(self, uid) -> bool:
        """Cancel a pending or running request by uid; it is dropped at
        admission or releases its slot at the next step boundary."""
        hit = False
        for r in list(self.pending.queue) + [r for r in self.slots if r is not None]:
            if r.uid == uid:
                r.cancelled = True
                hit = True
        return hit

    def run_until_drained(self, max_steps: int = 100000, k: int = 1) -> List[Request]:
        """Step until the queue and every slot are empty."""
        done: List[Request] = []
        for _ in range(max_steps):
            done += self.step(k)
            if not self.has_work():
                break
        return done
