"""Continuous-batching serving engine over a paged KV cache.

Port of ``videollamb_tpu/serve/paged.py``: the slot protocol and decode of
:class:`~videollamb_torch.serve.server.ServingEngine` (sampling controls,
choice and grammar constraints on device tables, logprobs, multi-LoRA), with
context memory allocated in pages from one shared pool
(``models/lm/paged.py``):

- admission splices the request, allocates ceil(prompt_len / page) pages and
  prefills straight into them (``fused_admit``); when the pool is short the
  request waits in the queue; the pending requests that fit the free slots
  are spliced together first, their prompt lengths read back in one copy
  (``_prefetch_admissions``);
- before every decode the engine allocates the pages that the next k tokens
  of each active slot need (``_ensure_pages``);
- when page growth exhausts the pool, an idle cached prefix is evicted
  first, else the youngest active request is swapped out: its pages go to
  host memory as raw bytes (int8 pages with their scales, so the round trip
  is exact) and it resumes, first in line, once a slot and its pages fit;
- finished slots return their pages at once.

On the card the decode forward (``embed_tokens``, then
``paged_decode_step``) replays as one CUDA graph where
:func:`decode_graph_route` allows: the engine's first forward runs eagerly
(it loads cuBLAS and the kernel library), the second is captured and
replayed, and every later one is a copy of the tokens into the graph's input
and a replay. The pools, the page table and the lengths are allocated once
and only updated in place, and B is always ``num_slots``, so one graph
serves the engine's life; it is captured again if any of those tensors is
ever reallocated, and the route is decided again when ``set_adapters``
loads or drops a multi-LoRA stack. Each replay's logits are cloned out of the graph's output,
so no caller holds memory the next replay overwrites. Sampling, controls,
grammar and the commit around the forward stay eager.

Spans (``utils/profiling.py``), besides the base engine's: the convoy is
``admit.prefetch``, its splices ``admit.splice`` and its stacked readback
``admit.readback``; page table uploads and resumes are ``engine.pages``,
with ``pages.swap_out`` / ``pages.swap_in`` per request moved. Every decode
forward leaves a ``decode.graph`` mark (a replay) or a ``decode.eager`` one;
a capture is a ``decode.capture`` span.

Prefix caching: ``register_prefix`` prefills a shared prompt prefix (system
and video) once; its whole pages go into the pool, refcounted, and are
mapped into the table row of every slot that consumes it
(``Request.prefix_id``); each admission prefills only the request's suffix
over a copy of the prefix's dense cache and inserts the pages past the
shared ones. Decode never writes a shared page: its writes land past the
prefix, in the slot's private pages. With ``Request.prefix_batch`` the engine
keys prefixes by content (:func:`batch_signature`), reuses a cached one on a
hit and registers on a miss; cached prefixes are refcounted by their live
slots and evicted least-recently-used past ``prefix_cache_size`` or when
pages run out.

``quantize_kv=True`` keeps int8 token-major pages (kernels K4 and K5 on the
card), otherwise the model's dtype in head-major pages (kernel K6). The
paged engine does not speculate (``speculative`` stays None), as in the JAX
package.

Two LM families are served: the Llama decoder (``models/lm/llama.py``) and
the DeepSeek-V3 family (``models/lm/mla.py``: latent attention, routed
experts), whose pool holds one latent row per token and layer
(``paged.PagedLatentCache``) and whose decode runs attention absorbed. The
second family is served over whole bf16 (or f32) weights only: int8 pages,
multi-LoRA stacks, int8 / int4 weights and tensor- or FSDP-sharded weights
are refused with an error. Its MoE blocks count, on the device, the tokens
routed to each expert (:meth:`PagedServingEngine.expert_load`), which
``http_server``'s ``/metrics`` exports.

A sliding-window LM (Mistral) is served when a slot's context limit
(``pages_per_seq * page_size``) is at most the window, where the window
cannot bite; otherwise the engine refuses it. Its decode (K4 / K6) has no
window term, as in the JAX package, whose paged decode therefore reads keys
past the window that its admission and its dense decode mask.
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import List, NamedTuple, Optional

import numpy as np
import torch
from torch import nn
from torch.distributed.fsdp import FSDPModule
from torch.distributed.tensor import DTensor

from videollamb_torch.config import ModelConfig, is_mla
from videollamb_torch.kernels import build as kb
from videollamb_torch.models.assembly import VideoLLaMB, prepare_multimodal_embeds
from videollamb_torch.models.lm import mla
from videollamb_torch.models.lm.family import dense_ops
from videollamb_torch.models.lm.llama import embed_tokens
from videollamb_torch.models.lm.mlora import adapter_rows
from videollamb_torch.models.lm.paged import (
    TRASH_PAGE,
    PageAllocator,
    fused_admit,
    gather_slot_pages,
    init_paged_cache,
    insert_raw_pages,
    paged_decode_step,
    paged_insert,
    pool_bytes_per_token,
    scatter_pages,
)
from videollamb_torch.serve.server import Request, ServingEngine, _shared_consume
from videollamb_torch.utils.profiling import mark, span


def _projections(lm: nn.Module) -> list:
    """Every projection of either LM family: the head and each ``*_proj``
    (``kv_a_proj_with_mqa`` too; the routed experts' and shared experts')."""
    return [m for name, m in lm.named_modules()
            if name == "lm_head" or name.endswith("_proj") or name.endswith("_proj_with_mqa")]


def _sharded(lm: nn.Module) -> bool:
    return (any(isinstance(m, FSDPModule) for m in lm.modules())
            or any(isinstance(p, DTensor) for p in lm.parameters()))


def decode_graph_route(lm: nn.Module, device: torch.device) -> bool:
    """Whether the paged decode forward replays as one CUDA graph: on a CUDA
    device, over an LM of either family whose weights are whole on this rank
    (no DTensor, no FSDP unit: gathers and collectives stay eager), with no
    multi-LoRA stack (its row index changes from call to call) and every
    projection a plain ``nn.Linear`` (quantised and adapter projections stay
    eager). The DeepSeek-V3 family's routed experts run in bf16 as grouped
    products over their stacked weights with every count on the device, so
    they replay too; in f32 they loop on the host and stay eager."""
    if device.type != "cuda" or getattr(lm, "mlora_rows", None) is not None:
        return False
    if _sharded(lm):
        return False
    if isinstance(lm, mla.MLAForCausalLM) and lm.lm_head.weight.dtype != torch.bfloat16:
        return False  # the experts' loop (f32) reads row counts on the host
    return all(type(m) is nn.Linear for m in _projections(lm))


def mla_refusal(lm: nn.Module, quantize_kv: bool, adapter_registry) -> Optional[str]:
    """Why the paged engine cannot serve this DeepSeek-V3-family LM (None: it can)."""
    if quantize_kv:
        return "int8 KV pages (--quantize-kv)"
    if adapter_registry is not None or getattr(lm, "mlora_rows", None) is not None:
        return "multi-LoRA adapter stacks"
    if _sharded(lm):
        return "tensor- or FSDP-sharded weights"
    odd = sorted({type(m).__name__ for m in _projections(lm) if type(m) is not nn.Linear})
    if odd:
        return f"quantised or adapter projections ({', '.join(odd)}: int8 / int4 weights, LoRA)"
    return None


class DecodeGraph(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    tokens: torch.Tensor  # (B,) int64, copied in before each replay
    logits: torch.Tensor  # (B, V) f32, overwritten by each replay
    ptrs: tuple           # the pools', table's and lengths' storage at capture
    launches: dict        # kernel wrapper -> its launches in one replay (kb.counted)


def _cache_ptrs(cache) -> tuple:
    """The storage of every tensor of the pool (either layout), its table and lengths."""
    return tuple(0 if t is None else t.data_ptr()
                 for t in (getattr(cache, f.name) for f in dataclasses.fields(cache)))


def batch_signature(batch) -> bytes:
    """Content hash of a MultimodalBatch, the automatic prefix cache key:
    splicing is deterministic, so equal token ids, masks and media bytes
    (videos, images, anyres grid specs and every mixed block with its
    modality) mean equal prefill KV."""
    h = hashlib.sha256()

    def put(t) -> None:
        if t is None:
            h.update(b"\x00")
            return
        t = t.detach().contiguous().cpu()
        h.update(f"{t.dtype}{tuple(t.shape)}".encode())
        h.update(t.view(torch.uint8).numpy().tobytes())

    for t in (batch.input_ids, batch.attention_mask, batch.videos, batch.images,
              batch.image_specs):
        put(t)
    if batch.blocks is None:
        h.update(b"\x00")
    else:
        for modality, pixels in batch.blocks:
            h.update(modality.encode())
            put(pixels)
    return h.digest()


class PagedServingEngine(ServingEngine):
    def __init__(self, model: VideoLLaMB, cfg: ModelConfig, *, num_slots: int = 4,
                 page_size: int = 64, total_pages: Optional[int] = None,
                 pages_per_seq: Optional[int] = None, eos_token_id: int = 2, seed: int = 0,
                 quantize_kv: bool = False, adapter_registry=None, prefix_cache_size: int = 8):
        if is_mla(cfg.lm):
            why = mla_refusal(model.lm, quantize_kv, adapter_registry)
            if why is not None:
                raise ValueError(f"the DeepSeek-V3 family (latent attention, routed experts) "
                                 f"is served over whole bf16 / f32 weights with latent pages; "
                                 f"{why} are for the Llama family")
        self._init_slots(model, cfg, num_slots, eos_token_id, seed, adapter_registry)
        self._dense = dense_ops(cfg.lm)
        self.page_size = page_size
        # Default pool: every slot can hold max_length + 512 tokens, rounded
        # up to a multiple of 8 pages (VideoLLaMB-7B: 40 pages of 64 per
        # slot, 321 pages at 8 slots).
        per_slot = -(-(cfg.max_length + 512) // page_size)
        per_slot = (per_slot + 7) // 8 * 8
        self.total_pages = total_pages or (1 + num_slots * per_slot)
        self.pages_per_seq = pages_per_seq or per_slot
        self.max_seq_len = self.pages_per_seq * page_size
        window = getattr(cfg.lm, "sliding_window", None)  # the DeepSeek-V3 family has none
        if window is not None and self.max_seq_len > window:
            raise ValueError(
                f"the paged decode has no sliding-window term: a slot's context limit "
                f"({self.pages_per_seq} pages x {page_size} = {self.max_seq_len} tokens) "
                f"must be at most the LM's window ({window}); pass pages_per_seq <= "
                f"{window // page_size}")
        self.cache = init_paged_cache(cfg.lm, num_slots, self.total_pages, page_size,
                                      self.pages_per_seq, self._dtype, quantize=quantize_kv,
                                      device=self.device, lm=model.lm)
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
        # Prefix cache: pid -> dict(pages, dense, logits, len); auto-cached
        # prefixes by signature in LRU -> MRU order, refcounted by their live
        # slots. Each holds its shared pages and a dense B=1 cache of its
        # tokens for the suffix prefills.
        self._prefixes: dict = {}
        self._next_prefix_id = 0
        self.prefix_cache_size = max(1, prefix_cache_size)
        self._auto_prefix: "OrderedDict[bytes, int]" = OrderedDict()
        self._prefix_refs: dict = {}
        self._slot_prefix: List[Optional[int]] = [None] * num_slots
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_evictions = 0
        self.peak_pages_in_use = 0
        self.kv_bytes_per_token = pool_bytes_per_token(self.cache)
        self._graph_route = decode_graph_route(model.lm, self.device)
        self._graph: Optional[DecodeGraph] = None
        self.decode_replays = 0
        self.decode_eager = 0
        self.decode_captures = 0

    # ------------------------------------------------------------------
    # Prefix caching.
    def register_prefix(self, batch) -> Optional[int]:
        """Prefill a shared prompt prefix once; returns its id for
        ``Request.prefix_id``, or None when the pool cannot hold its pages.
        Only whole pages are shared; the prefix's dense cache is kept so each
        admission prefills only the request's suffix."""
        spliced = prepare_multimodal_embeds(self.model, self.cfg, batch)
        prefix_len = int(spliced.attention_mask.sum())
        n_full = prefix_len // self.page_size
        pages = self.allocator.alloc(n_full) if n_full else []
        if pages is None:
            return None
        dense = self._dense.init_cache(self.cfg.lm, 1, self.cfg.max_length, dtype=self._dtype,
                                       device=self.device, lm=self.model.lm)
        logits, dense = self._dense.chunked_prefill(self.model.lm, self.cfg.lm,
                                                    spliced.embeds.to(self._dtype),
                                                    spliced.attention_mask, dense,
                                                    lengths=[prefix_len])
        if pages:
            scatter_pages(self.cache, dense, pages)
        pid = self._next_prefix_id
        self._next_prefix_id += 1
        # Keep only the prefix's rows of the dense cache (k and v, or the latent rows).
        self._prefixes[pid] = {
            "pages": pages, "len": prefix_len, "logits": logits, "kind": type(dense),
            "rows": tuple(t[:, :, :prefix_len].clone() for t in dense[:-1])}
        self._prefix_refs[pid] = 0
        self._note_pages()
        return pid

    def release_prefix(self, pid: int) -> None:
        info = self._prefixes.pop(pid)
        self._prefix_refs.pop(pid, None)
        self.allocator.free(info["pages"])

    def _evict_idle_prefix(self, exclude=None) -> bool:
        """Drop the least-recently-used auto-cached prefix without a live slot
        (not ``exclude``, the one being admitted against), freeing its pages.
        False when every cached prefix is in use."""
        for sig, pid in self._auto_prefix.items():
            if pid != exclude and self._prefix_refs.get(pid, 0) == 0:
                del self._auto_prefix[sig]
                self.release_prefix(pid)
                self.prefix_evictions += 1
                return True
        return False

    def _pool_idle(self) -> bool:
        return not any(r is not None for r in self.slots) and not self._swapped

    def _resolve_auto_prefix(self, req: Request) -> str:
        """Map ``req.prefix_batch`` to a cached prefix id, registering on a
        miss: 'ok' (req.prefix_id set), 'wait' (the pool is too tight now)
        or 'reject' (the prefix cannot fit even with the pool idle and every
        idle prefix evicted)."""
        sig = batch_signature(req.prefix_batch)
        pid = self._auto_prefix.get(sig)
        if pid is not None:
            self._auto_prefix.move_to_end(sig)
            self.prefix_hits += 1
            req.prefix_id = pid
            return "ok"
        self.prefix_misses += 1
        while len(self._auto_prefix) >= self.prefix_cache_size:
            if not self._evict_idle_prefix():
                break  # every entry in use: overshoot until slots release
        pid = self.register_prefix(req.prefix_batch)
        while pid is None and self._evict_idle_prefix():
            pid = self.register_prefix(req.prefix_batch)
        if pid is None:
            return "reject" if self._pool_idle() and not self._prefixes else "wait"
        self._auto_prefix[sig] = pid
        req.prefix_id = pid
        return "ok"

    def _admit_prefix(self, req: Request, slot: int) -> bool:
        """Admission of a prefix-cached request: the suffix prefilled over a
        copy of the prefix's dense rows, the shared pages mapped by refcount.
        False on backpressure (the request stays queued)."""
        info = self._prefixes[req.prefix_id]
        spliced, suffix_len = self._splice(req)
        total_len = info["len"] + suffix_len
        n_pages = self.allocator.pages_needed(total_len, self.page_size)
        n_full = len(info["pages"])
        if n_pages > self.pages_per_seq:
            self._drop(self.pending.get(), f"rejected: prefix+suffix needs {n_pages} pages, "
                       f"per-sequence budget is {self.pages_per_seq}")
            return True
        private = self.allocator.alloc(n_pages - n_full)
        if private is None and req.prefix_batch is not None:
            # An auto-cached prefix: reclaim OTHER idle prefixes first; if the
            # pool is otherwise idle and the suffix still does not fit beside
            # the prefix, no release will ever help.
            while private is None and self._evict_idle_prefix(exclude=req.prefix_id):
                private = self.allocator.alloc(n_pages - n_full)
            if private is None and self._pool_idle():
                self._drop(self.pending.get(), f"rejected: prefix+suffix needs {n_pages} "
                           "pages and cannot fit the page pool even with the cache empty")
                return True
        if private is None:
            return False  # pool exhausted: backpressure
        self.pending.get()
        req._spliced_cache = None
        self.allocator.retain(info["pages"])
        pages = list(info["pages"]) + private
        page_ids = np.full((self.pages_per_seq,), TRASH_PAGE, np.int32)
        page_ids[:len(pages)] = pages
        with span("admit.prefill", req.uid):
            # Suffix-only prefill of the suffix's own tokens (not the splice
            # buffer's padding) over a copy of the prefix's rows, in a dense
            # cache as long as the slot's pages (the last one partly filled).
            parts = []
            for rows in info["rows"]:
                part = rows.new_zeros((rows.shape[0], 1, n_pages * self.page_size,
                                       *rows.shape[3:]))
                part[:, :, :info["len"]] = rows
                parts.append(part)
            dense = info["kind"](*parts, torch.tensor([info["len"]], device=self.device))
            logits, dense = self._dense.extend(self.model.lm, self.cfg.lm,
                                               spliced.embeds[:, :suffix_len].to(self._dtype),
                                               spliced.attention_mask[:, :suffix_len], dense)
            paged_insert(self.cache, dense, slot, page_ids.tolist(), skip_pages=n_full)
            self.logits[slot] = logits[0]
        self._install_constraint(req)
        self._occupy(slot, req, pages, total_len, page_ids)
        self._slot_prefix[slot] = req.prefix_id
        self._prefix_refs[req.prefix_id] += 1
        _shared_consume(req)
        return True

    # ------------------------------------------------------------------
    @property
    def pages_in_use(self) -> int:
        """Pages held by slots and cached prefixes (the trash page aside)."""
        return self.total_pages - 1 - self.allocator.free_pages

    def _note_pages(self) -> None:
        self.peak_pages_in_use = max(self.peak_pages_in_use, self.pages_in_use)

    def _occupy(self, slot: int, req: Request, pages: List[int], length: int,
                row: np.ndarray) -> None:
        """Host bookkeeping of an admitted or resumed slot (its card row is set)."""
        self.slot_pages[slot] = pages
        self._host_len[slot] = length
        self._table_host[slot] = row
        self.slots[slot] = req
        self._slot_seq[slot] = self._admit_seq
        self._admit_seq += 1
        self._note_pages()

    def _sync_table(self) -> None:
        if not self._table_dirty:
            return
        self.cache.page_table.copy_(torch.from_numpy(self._table_host))
        self.cache.lengths.copy_(torch.from_numpy(self._host_len.astype(np.int32)))
        self._table_dirty = False

    def _free_cache_row(self, slot: int) -> None:
        pid = self._slot_prefix[slot]
        if pid is not None:
            self._slot_prefix[slot] = None
            if pid in self._prefix_refs:
                self._prefix_refs[pid] -= 1
        self.allocator.free(self.slot_pages[slot])
        self.slot_pages[slot] = []
        self._host_len[slot] = 0
        # The freed pages may be reallocated by the next admission, so the
        # trash row must reach the card before the next decode (_sync_table).
        self._table_host[slot] = TRASH_PAGE
        self._table_dirty = True

    def _prefix_refusal(self, req: Request) -> Optional[str]:
        if req.adapter is not None:
            # A shared prefix's KV comes from the base model.
            return ("rejected: adapter requests cannot reuse a shared prefix "
                    "(prefix KV is base-model)")
        return None

    def _prefetch_admissions(self) -> None:
        """Batch the admission readbacks of one convoy: every plain pending
        request (no prefix, no share_prefill group) that fits the free slots
        is spliced here, and the splices whose length the host does not know
        share ONE device-to-host readback of their stacked mask sums. The
        results ride ``req._spliced_cache`` into :meth:`_admit`."""
        free = sum(r is None for r in self.slots)
        if free <= 1 or self.pending.empty():
            return
        with span("admit.prefetch"):
            todo = []
            for req in list(self.pending.queue)[:free]:
                if (req.cancelled or req.prefix_id is not None or req.prefix_batch is not None
                        or req._shared_prefill is not None or req._spliced_cache is not None):
                    continue
                self._admission_starts(req)
                with span("admit.splice", req.uid):
                    spliced = prepare_multimodal_embeds(self.model, self.cfg, req.batch)
                trusted = self._trusted_prompt_len(req)
                if trusted is not None:
                    req._spliced_cache = (spliced, trusted)
                else:
                    todo.append((req, spliced))
            if not todo:
                return
            with span("admit.readback"):
                sums = self._readback(torch.stack([s.attention_mask.sum() for _, s in todo]))
            for (req, spliced), val in zip(todo, sums):
                self._check_prompt_len(req, int(val))
                req._spliced_cache = (spliced, int(val))

    def _admit(self) -> None:
        # Releases of the previous commit reach the card first: admission may
        # reuse their pages. Swapped requests resume before anything pending.
        with span("engine.pages"):
            self._sync_table()
            self._readmit_swapped()
        self._prefetch_admissions()
        while not self.pending.empty():
            slot = self._free_slot()
            if slot is None:
                return
            req = self.pending.queue[0]  # peek: pop only once pages fit
            if req.cancelled:
                self._drop(self.pending.get())
                continue
            refusal = self._refusal(req)
            if refusal is not None:
                self._drop(self.pending.get(), refusal)
                continue
            if (req.prefix_batch is not None and req.prefix_id is not None
                    and req.prefix_id not in self._prefixes):
                req.prefix_id = None  # evicted while this request waited: resolve again
            if req.prefix_batch is not None and req.prefix_id is None:
                state = self._resolve_auto_prefix(req)
                if state == "wait":
                    return
                if state == "reject":
                    self._drop(self.pending.get(), "rejected: prefix exceeds the page pool "
                               "even with the cache empty")
                    continue
            if req.prefix_id is not None:
                if not self._admit_prefix(req, slot):
                    return
                continue
            shared = req._shared_prefill
            if shared is not None and shared["data"] is not None:
                prompt_len = int(shared["data"][1].length[0])
            else:
                prompt_len = self._splice(req)[1]
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
            self._admission_starts(req)
            aidx1 = self._set_adapter(slot, req)
            page_ids = np.full((self.pages_per_seq,), TRASH_PAGE, np.int32)
            page_ids[:len(pages)] = pages
            if shared is None:
                spliced, _ = self._splice(req)
                req._spliced_cache = None
                with span("admit.prefill", req.uid), adapter_rows(self.model.lm, aidx1):
                    fused_admit(self.model.lm, self.cfg.lm, spliced.embeds.to(self._dtype),
                                spliced.attention_mask, prompt_len, self.cache, self.logits,
                                slot, page_ids.tolist())
            else:
                # A share_prefill group: the dense single-row prefill is kept
                # for the siblings.
                logits, single, _ = self._prefill(req, aidx1)
                paged_insert(self.cache, single, slot, page_ids.tolist())
                self.logits[slot] = logits[0]
            _shared_consume(req)
            self._install_constraint(req)
            self._occupy(slot, req, pages, prompt_len, page_ids)

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
        """Copy a slot's resident pages (shared prefix pages included) to host
        memory and release its references. Growth pages allocated ahead hold
        no token and are not saved. The request keeps its host state (tokens,
        constraint cursor) and its adapter index rides along."""
        with span("pages.swap_out", self.slots[slot].uid):
            length = int(self._host_len[slot])
            n_data = min(self.allocator.pages_needed(length, self.page_size),
                         len(self.slot_pages[slot]))
            k, v, ks, vs = gather_slot_pages(self.cache, self.slot_pages[slot][:n_data])
            self._swapped.append({
                "req": self.slots[slot], "len": length, "n": n_data,
                "k": k.cpu(), "v": None if v is None else v.cpu(),
                "ks": None if ks is None else ks.cpu(), "vs": None if vs is None else vs.cpu(),
                "logits": self.logits[slot].clone(), "adapter": int(self._adapter_host[slot]),
            })
            self.preempted += 1
            self._release(slot)

    def _readmit_swapped(self) -> None:
        """Resume swapped requests in order once a slot and their pages, plus
        one token of headroom, fit again. A resumed prefix request holds its
        pages privately."""
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
            with span("pages.swap_in", ent["req"].uid):
                insert_raw_pages(self.cache, ent["k"], ent["v"], pages[:ent["n"]],
                                 ent["ks"], ent["vs"])
                row = np.full((self.pages_per_seq,), TRASH_PAGE, np.int32)
                row[:len(pages)] = pages
                self.cache.page_table[slot] = torch.from_numpy(row).to(self.device)
                self.cache.lengths[slot] = ent["len"]
                self.logits[slot] = ent["logits"]
                if ent["adapter"] >= 0:
                    self._adapter_host[slot] = ent["adapter"]
                    self.adapter_idx[slot] = ent["adapter"]
                self._occupy(slot, ent["req"], pages, ent["len"], row)
            self.resumed += 1

    def _ensure_pages(self, k: int) -> None:
        """Allocate pages so every active slot can write k more tokens. When
        the pool runs dry an idle cached prefix is evicted, else the youngest
        request swapped out; a pool that cannot hold the one active request
        raises."""
        for i in range(self.num_slots):
            if self.slots[i] is None:
                continue
            need = self.allocator.pages_needed(int(self._host_len[i]) + k, self.page_size)
            while (self.slots[i] is not None
                   and len(self.slot_pages[i]) < min(need, self.pages_per_seq)):
                got = self.allocator.alloc(1)
                if got is None:
                    if self._evict_idle_prefix():
                        continue
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
        self._note_pages()

    # ------------------------------------------------------------------
    # Decode hooks.
    def expert_load(self) -> Optional[np.ndarray]:
        """(2, MoE layers, experts) int64 of a DeepSeek-V3-family LM, read from
        the device between steps: the tokens of requests routed to each
        expert (admissions and decode forwards), and the forwards in which
        the expert had any. None for the Llama family."""
        if not is_mla(self.cfg.lm):
            return None
        return mla.expert_load(self.model.lm).cpu().numpy()

    def set_adapters(self, model: VideoLLaMB, registry) -> None:
        """As the base engine's; a stack loaded or dropped at run time changes
        the LM's projections, so the decode route is decided again and a
        captured graph (over the projections it had) is dropped."""
        if is_mla(self.cfg.lm) and (registry is not None
                                    or getattr(model.lm, "mlora_rows", None) is not None):
            raise ValueError("multi-LoRA adapter stacks are for the Llama family; the "
                             "DeepSeek-V3 family is served without them")
        super().set_adapters(model, registry)
        self._graph_route = decode_graph_route(model.lm, self.device)
        self._graph = None

    def _forward(self, nxt: torch.Tensor) -> torch.Tensor:
        g = self._graph
        if g is not None and g.ptrs != _cache_ptrs(self.cache):
            g = self._graph = None  # the pool or the table was reallocated
        # On the graph route the first forward runs eagerly: it loads cuBLAS and the kernels.
        if g is None and not (self._graph_route and self.decode_eager):
            mark("decode.eager")
            self.decode_eager += 1
            return self._decode(nxt)
        if g is None:
            g = self._graph = self._capture()
        mark("decode.graph")
        g.tokens.copy_(nxt)
        g.graph.replay()
        self.decode_replays += 1
        for fn, n in g.launches.items():  # the wrappers count launches that ran
            fn.launches += n
        return g.logits.clone()

    def _decode(self, nxt: torch.Tensor) -> torch.Tensor:
        # The embedding table keeps the compute dtype: no cast (an int8 pool
        # dtype would round the embeddings to integers).
        return paged_decode_step(self.model.lm, self.cfg.lm,
                                 embed_tokens(self.model.lm, nxt[:, None]), self.cache)

    def _capture(self) -> DecodeGraph:
        """Capture one decode forward; capture runs nothing, so the cache
        advances only at the replay that follows."""
        before = kb.launch_counts()
        with span("decode.capture"):
            tokens = torch.zeros((self.num_slots,), dtype=torch.long, device=self.device)
            graph = torch.cuda.CUDAGraph()
            # Thread-local: the HTTP server's handler threads may use the device meanwhile.
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                logits = self._decode(tokens)
        launches = kb.launches_since(before)
        for fn, n in launches.items():  # captured, not run: each replay counts them
            fn.launches -= n
        self.decode_captures += 1
        return DecodeGraph(graph, tokens, logits, _cache_ptrs(self.cache), launches)

    def _advanced(self, k: int) -> None:
        self._host_len += k  # finished rows are zeroed by _release at commit

    def _rewind(self, frozen: np.ndarray, garbage: np.ndarray) -> None:
        """Frozen rows' lengths come back over their garbage steps: the next
        steps write (K5 on int8 pages) over those rows, in pages already
        allocated, and attention (K4, K6) reads up to the rewound length."""
        self._host_len -= garbage
        self.cache.lengths -= torch.as_tensor(garbage, dtype=torch.int32, device=self.device)

    def _prepare_decode(self, k: int) -> None:
        self._ensure_pages(k)
        self._sync_table()
