"""Continuous-batching serving engine over a paged KV cache.

Port of ``videollamb_tpu/serve/paged.py``: the slot protocol of
:class:`~videollamb_torch.serve.server.ServingEngine`, with context memory
allocated in pages from one shared pool (``models/lm/paged.py``):

- admission splices the request, allocates ceil(prompt_len / page) pages and
  prefills straight into them (``fused_admit``); when the pool is short the
  request waits in the queue;
- before every k-step decode the engine allocates the pages that the next k
  tokens of each active slot need (``_ensure_pages``);
- when page growth exhausts the pool, the youngest active request is swapped
  out: its pages go to host memory as raw bytes (int8 pages with their
  scales, so the round trip is exact) and it resumes, first in line, once a
  slot and its pages fit again;
- finished slots return their pages at once.

``quantize_kv=True`` keeps int8 token-major pages (kernels K4 and K5 on the
card), otherwise the model's dtype in head-major pages (kernel K6). Prefix
caching, grammar and choice constraints, sampling controls, logprobs and
multi-LoRA adapters are not ported yet. The paged engine does not speculate
(``speculative`` stays None), as in the JAX package.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from videollamb_torch.config import ModelConfig
from videollamb_torch.models.assembly import VideoLLaMB
from videollamb_torch.models.lm.llama import embed_tokens
from videollamb_torch.models.lm.paged import (
    TRASH_PAGE,
    PageAllocator,
    PagedKVCache,
    fused_admit,
    gather_slot_pages,
    init_paged_cache,
    insert_raw_pages,
    paged_decode_step,
)
from videollamb_torch.serve.server import Request, ServingEngine, sample_rows, slot_sampling_vectors


@torch.no_grad()
def paged_greedy_decode_steps(model: VideoLLaMB, cfg: ModelConfig, logits: torch.Tensor,
                              cache: PagedKVCache, k: int):
    """k greedy steps over the pool (the pages for positions len..len+k-1
    are allocated) -> (tokens (B, k), logits); the cache advances in place."""
    toks = []
    for _ in range(k):
        nxt = torch.argmax(logits, dim=-1)
        toks.append(nxt)
        # The embedding table keeps the compute dtype: no cast (an int8 pool
        # dtype would round the embeddings to integers).
        logits = paged_decode_step(model.lm, cfg.lm, embed_tokens(model.lm, nxt[:, None]), cache)
    return torch.stack(toks, dim=1), logits


@torch.no_grad()
def paged_sampled_decode_steps(model: VideoLLaMB, cfg: ModelConfig, logits: torch.Tensor,
                               cache: PagedKVCache, k: int,
                               generator: Optional[torch.Generator], temps: np.ndarray,
                               top_ps: np.ndarray):
    """k sampled steps over the pool (temperature-0 rows by argmax)."""
    toks = []
    for _ in range(k):
        nxt = sample_rows(logits, generator, temps, top_ps)
        toks.append(nxt)
        logits = paged_decode_step(model.lm, cfg.lm, embed_tokens(model.lm, nxt[:, None]), cache)
    return torch.stack(toks, dim=1), logits


class PagedServingEngine(ServingEngine):
    def __init__(self, model: VideoLLaMB, cfg: ModelConfig, *, num_slots: int = 4,
                 page_size: int = 64, total_pages: Optional[int] = None,
                 pages_per_seq: Optional[int] = None, eos_token_id: int = 2, seed: int = 0,
                 quantize_kv: bool = False):
        self._init_slots(model, cfg, num_slots, eos_token_id, seed)
        self.page_size = page_size
        # Default pool: every slot can hold max_length + 512 tokens, rounded
        # up to a multiple of 8 pages (VideoLLaMB-7B: 40 pages of 64 per
        # slot, 321 pages at 8 slots).
        per_slot = -(-(cfg.max_length + 512) // page_size)
        per_slot = (per_slot + 7) // 8 * 8
        self.total_pages = total_pages or (1 + num_slots * per_slot)
        self.pages_per_seq = pages_per_seq or per_slot
        self.max_seq_len = self.pages_per_seq * page_size
        self.cache = init_paged_cache(cfg.lm, num_slots, self.total_pages, page_size,
                                      self.pages_per_seq, self._dtype, quantize=quantize_kv,
                                      device=self.device)
        self.allocator = PageAllocator(self.total_pages)
        self.slot_pages: List[List[int]] = [[] for _ in range(num_slots)]
        # Host mirrors of the lengths and the page table. Host-side changes
        # (page growth, release) mark the table dirty and _sync_table uploads
        # it once before the next decode.
        self._host_len = np.zeros((num_slots,), np.int64)
        self._table_host = np.full((num_slots, self.pages_per_seq), TRASH_PAGE, np.int32)
        self._table_dirty = False
        self.preempted = 0  # swap-outs
        self.resumed = 0  # swap-ins
        self._swapped: List[dict] = []  # resume order (FIFO)
        self._admit_seq = 0  # admission order; the youngest has the largest
        self._slot_seq = np.zeros((num_slots,), np.int64)

    # ------------------------------------------------------------------
    def _mark_admitted(self, slot: int) -> None:
        self._slot_seq[slot] = self._admit_seq
        self._admit_seq += 1

    def _sync_table(self) -> None:
        if not self._table_dirty:
            return
        self.cache.page_table.copy_(torch.from_numpy(self._table_host))
        self.cache.lengths.copy_(torch.from_numpy(self._host_len.astype(np.int32)))
        self._table_dirty = False

    def _release(self, slot: int) -> None:
        self.slots[slot] = None
        self.allocator.free(self.slot_pages[slot])
        self.slot_pages[slot] = []
        self._host_len[slot] = 0
        # The freed pages may be reallocated by the next admission, so the
        # trash row must reach the card before the next decode (_sync_table).
        self._table_host[slot] = TRASH_PAGE
        self._table_dirty = True

    def _admit(self) -> None:
        # Swapped requests resume first: they predate everything pending.
        self._readmit_swapped()
        while not self.pending.empty():
            slot = self._free_slot()
            if slot is None:
                return
            req = self.pending.queue[0]  # peek: pop only once pages fit
            if req.cancelled:
                self._drop(self.pending.get())
                continue
            spliced, prompt_len = self._splice(req)
            n_pages = self.allocator.pages_needed(prompt_len, self.page_size)
            if n_pages > self.pages_per_seq:
                self._drop(self.pending.get(),
                           f"rejected: prompt needs {n_pages} pages, per-sequence budget is "
                           f"{self.pages_per_seq}")
                continue
            pages = self.allocator.alloc(n_pages)
            if pages is None:
                return  # pool exhausted: backpressure until slots free
            self.pending.get()
            req._spliced = None
            page_ids = np.full((self.pages_per_seq,), TRASH_PAGE, np.int32)
            page_ids[:len(pages)] = pages
            fused_admit(self.model.lm, self.cfg.lm, spliced.embeds.to(self._dtype),
                        spliced.attention_mask, prompt_len, self.cache, self.logits, slot,
                        page_ids.tolist())
            self.slot_pages[slot] = pages
            self._host_len[slot] = prompt_len
            self._table_host[slot] = page_ids  # the card's row was set in place
            self.slots[slot] = req
            self._mark_admitted(slot)

    # ------------------------------------------------------------------
    # Swap preemption: the youngest request's pages go to host memory.
    def has_work(self) -> bool:
        return super().has_work() or bool(self._swapped)

    def cancel(self, uid) -> bool:
        """Also reaches swapped-out requests, which are dropped on resume."""
        hit = super().cancel(uid)
        for ent in self._swapped:
            if ent["req"].uid == uid:
                ent["req"].cancelled = True
                hit = True
        return hit

    def _pick_victim(self) -> Optional[int]:
        """The youngest active slot: older requests keep their pages (FCFS)."""
        victim, best = None, -1
        for i, r in enumerate(self.slots):
            if r is not None and self._slot_seq[i] > best:
                victim, best = i, self._slot_seq[i]
        return victim

    def _swap_out(self, slot: int) -> None:
        """Copy a slot's resident pages to host memory and free them. Growth
        pages allocated ahead hold no token and are not saved."""
        length = int(self._host_len[slot])
        n_data = min(self.allocator.pages_needed(length, self.page_size),
                     len(self.slot_pages[slot]))
        k, v, ks, vs = gather_slot_pages(self.cache, self.slot_pages[slot][:n_data])
        self._swapped.append({
            "req": self.slots[slot], "len": length, "n": n_data,
            "k": k.cpu(), "v": v.cpu(),
            "ks": None if ks is None else ks.cpu(), "vs": None if vs is None else vs.cpu(),
            "logits": self.logits[slot].clone(),
        })
        self.preempted += 1
        self._release(slot)

    def _readmit_swapped(self) -> None:
        """Resume swapped requests in order once a slot and their pages, plus
        one token of headroom, fit again."""
        while self._swapped:
            ent = self._swapped[0]
            if ent["req"].cancelled:
                self._swapped.pop(0)
                self._drop(ent["req"])
                continue
            slot = self._free_slot()
            if slot is None:
                return
            pages = self.allocator.alloc(
                self.allocator.pages_needed(ent["len"] + 1, self.page_size))
            if pages is None:
                return  # still tight: retry next step
            self._swapped.pop(0)
            insert_raw_pages(self.cache, ent["k"], ent["v"], pages[:ent["n"]],
                             ent["ks"], ent["vs"])
            row = np.full((self.pages_per_seq,), TRASH_PAGE, np.int32)
            row[:len(pages)] = pages
            self.cache.page_table[slot] = torch.from_numpy(row)
            self.cache.lengths[slot] = ent["len"]
            self.logits[slot] = ent["logits"]
            self.slot_pages[slot] = pages
            self._host_len[slot] = ent["len"]
            self._table_host[slot] = row
            self.slots[slot] = ent["req"]
            self._mark_admitted(slot)
            self.resumed += 1

    def _ensure_pages(self, k: int) -> None:
        """Allocate pages so every active slot can write k more tokens,
        swapping out the youngest request when the pool runs dry. A pool
        that cannot hold the one active request raises."""
        for i in range(self.num_slots):
            if self.slots[i] is None:
                continue
            need = self.allocator.pages_needed(int(self._host_len[i]) + k, self.page_size)
            while (self.slots[i] is not None
                   and len(self.slot_pages[i]) < min(need, self.pages_per_seq)):
                got = self.allocator.alloc(1)
                if got is None:
                    victim = self._pick_victim()
                    if victim == i and sum(r is not None for r in self.slots) == 1:
                        raise RuntimeError(
                            "page pool exhausted mid-decode and no request can be "
                            "preempted; size the pool for at least one full sequence "
                            "plus headroom")
                    self._swap_out(victim)
                    continue  # retry (slot i itself may have been swapped out)
                self._table_host[i, len(self.slot_pages[i])] = got[0]
                self.slot_pages[i].append(got[0])
                self._table_dirty = True

    def _decode(self, k: int) -> torch.Tensor:
        temps, top_ps = slot_sampling_vectors(self.slots)
        if (temps > 0).any():
            toks, self.logits = paged_sampled_decode_steps(
                self.model, self.cfg, self.logits, self.cache, k, self.generator, temps, top_ps)
        else:
            toks, self.logits = paged_greedy_decode_steps(
                self.model, self.cfg, self.logits, self.cache, k)
        self._host_len += k  # finished rows are zeroed by _release at commit
        return toks

    def step(self, k: int = 1) -> List[Request]:
        # Releases of the previous commit reach the card before admission,
        # which may reuse their pages.
        self._sync_table()
        self._admit()
        dropped = self._drain_dropped()
        if not any(self._active_mask()):
            return dropped
        self._ensure_pages(max(k, 1))
        self._sync_table()
        toks = self._decode(k)
        return self._commit_k_tokens(toks.cpu().numpy(), k, dropped)
