"""Paged KV cache: one page pool shared by all slots, and the paged decode step.

Port of ``videollamb_tpu/models/lm/paged.py``. Every slot holds a page
table into one pool, so context memory is allocated in ``page_size``-token
pages on demand instead of a dense (L, S_max, H_kv, Dh) strip per slot.
Logical page 0 is the trash page: unused table entries point at it, so
writes of padding and of released slots land there harmlessly.

Two pool layouts, as in the JAX package:

- bf16 (or f32) pools are HEAD-MAJOR, (L, H_kv, P, page, Dh): kernel K6
  (``ops/paged_attention_stats.paged_attention_with_stats``) reads them;
- int8 pools are TOKEN-MAJOR, (L, P, page, H_kv * Dh) with per-token absmax
  scales (L, P, page, H_kv): kernel K4
  (``ops/gathered_paged_attention.gathered_paged_attention_int8``) reads
  them and kernel K5 (``ops/paged_fresh_write``) installs each step's rows.

:func:`paged_decode_step` attends BEFORE it writes: each layer attends over
the already-resident tokens only and folds the current token in exactly
through the softmax statistics (``merge_one_token``); the fresh K/V rows of
all layers are written once after the layer loop. Unlike the JAX package,
the port updates the pools, tables and lengths in place.

A third layout holds the latent rows of the DeepSeek-V3 family
(``models/lm/mla.py``): :class:`PagedLatentCache`, (L, P, page, 576), one
row of the normed kv latent and the roped shared key per token and layer,
with no heads, under the same page table, trash page, allocator and prefix
pages. Its decode step, :func:`paged_latent_decode_step`, runs attention
absorbed. Every function here takes either pool.

Prefix caching: a prefix's whole pages are written once
(:func:`scatter_pages`) and mapped into the table row of every slot
that consumes it (:func:`paged_insert` with ``skip_pages``); the
:class:`PageAllocator` refcounts them. Decode never writes a shared page:
writes land at positions past the prefix, in the slot's private pages.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from videollamb_torch.config import LlamaConfig, is_mla
from videollamb_torch.models.lm.llama import (
    PREFILL_CHUNK,
    KVCache,
    LlamaForCausalLM,
    _final,
    _mlp,
    _qkv,
    _rms_norm as llama_rms_norm,
    chunked_prefill,
    init_kv_cache,
    local_kv_heads,
    proj,
)
from videollamb_torch.models.lm import mla
from videollamb_torch.models.lm.rope import rope_cos_sin_cfg
from videollamb_torch.ops.gathered_paged_attention import (
    _pick_ppb,
    attend_token_major_int8_stats,
    gathered_paged_attention_int8,
)
from videollamb_torch.ops.paged_attention_stats import (
    attend_paged_with_stats_xla,
    merge_one_token,
    paged_attention_with_stats,
)
from videollamb_torch.ops.paged_fresh_write import paged_fresh_write, paged_fresh_write_xla
from videollamb_torch.ops.quantization import get_quantization_scales, to_int8
from videollamb_torch.parallel.sharding import gathered

TRASH_PAGE = 0


@dataclasses.dataclass
class PagedKVCache:
    k_pages: torch.Tensor     # (L, H_kv, P, page, Dh) or int8 (L, P, page, H_kv * Dh)
    v_pages: torch.Tensor
    page_table: torch.Tensor  # (B_slots, pages_per_seq) int32 logical page ids
    lengths: torch.Tensor     # (B_slots,) int32 tokens written per slot
    k_scales: Optional[torch.Tensor] = None  # (L, P, page, H_kv) f32, int8 pools only
    v_scales: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.k_scales is not None

    @property
    def token_major(self) -> bool:
        return self.k_pages.ndim == 4

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[2 if self.token_major else 3]

    @property
    def pages_per_seq(self) -> int:
        return self.page_table.shape[1]


@dataclasses.dataclass
class PagedLatentCache:
    """The latent page pool of the DeepSeek-V3 family: one row of
    ``kv_lora_rank + qk_rope_head_dim`` values per token and layer."""

    pages: torch.Tensor       # (L, P, page, kv_lora_rank + qk_rope_head_dim)
    page_table: torch.Tensor  # (B_slots, pages_per_seq) int32 logical page ids
    lengths: torch.Tensor     # (B_slots,) int32 tokens written per slot
    quantized = False

    @property
    def page_size(self) -> int:
        return self.pages.shape[2]

    @property
    def pages_per_seq(self) -> int:
        return self.page_table.shape[1]


def pool_bytes_per_token(cache) -> int:
    """Bytes one token takes in the pool, over every layer (scales included)."""
    if isinstance(cache, PagedLatentCache):
        layers, _, _, width = cache.pages.shape
        return layers * width * cache.pages.element_size()
    kp = cache.k_pages
    # (L, P, page, H_kv * Dh) token-major or (L, H_kv, P, page, Dh) head-major.
    row = kp.shape[-1] if cache.token_major else kp.shape[1] * kp.shape[-1]
    per = 2 * row * kp.element_size()
    if cache.quantized:  # one f32 scale a kv head, for K and for V
        per += 2 * cache.k_scales.shape[-1] * cache.k_scales.element_size()
    return kp.shape[0] * per


def init_paged_cache(cfg: LlamaConfig, num_slots: int, total_pages: int, page_size: int = 64,
                     pages_per_seq: Optional[int] = None, dtype=torch.bfloat16,
                     quantize: bool = False, device="cpu",
                     lm: Optional[LlamaForCausalLM] = None) -> PagedKVCache:
    """``total_pages`` logical pages shared by all slots (page 0 = trash);
    with ``lm``, at its kv heads on this rank (``llama.local_kv_heads``).
    An ``MLAConfig`` gets the latent pool, in ``dtype`` (no int8 pages)."""
    pps = pages_per_seq or total_pages
    table = torch.full((num_slots, pps), TRASH_PAGE, dtype=torch.int32, device=device)
    lengths = torch.zeros((num_slots,), dtype=torch.int32, device=device)
    if is_mla(cfg):
        if quantize:
            raise ValueError("int8 KV pages are for the Llama family; the latent pool of the "
                             "DeepSeek-V3 family is kept in the model's dtype")
        shape = (cfg.num_hidden_layers, total_pages, page_size, cfg.latent_dim)
        return PagedLatentCache(pages=torch.zeros(shape, dtype=dtype, device=device),
                                page_table=table, lengths=lengths)
    h_kv, dh, layers = local_kv_heads(cfg, lm), cfg.head_dim, cfg.num_hidden_layers
    if quantize:
        shape = (layers, total_pages, page_size, h_kv * dh)
        scales = (layers, total_pages, page_size, h_kv)
        return PagedKVCache(
            k_pages=torch.zeros(shape, dtype=torch.int8, device=device),
            v_pages=torch.zeros(shape, dtype=torch.int8, device=device),
            page_table=table, lengths=lengths,
            k_scales=torch.zeros(scales, dtype=torch.float32, device=device),
            v_scales=torch.zeros(scales, dtype=torch.float32, device=device))
    shape = (layers, h_kv, total_pages, page_size, dh)
    return PagedKVCache(k_pages=torch.zeros(shape, dtype=dtype, device=device),
                        v_pages=torch.zeros(shape, dtype=dtype, device=device),
                        page_table=table, lengths=lengths)


def scatter_pages(cache: PagedKVCache, single: KVCache, page_ids: Sequence[int],
                  skip_pages: int = 0) -> None:
    """Copy the whole pages of a dense B=1 cache into the pool at the real
    (non-trash) ``page_ids``, past the first ``skip_pages`` (shared prefix
    pages already in the pool), without touching any slot's table (it also
    writes a prefix's pages at registration); int8 pools quantise per token
    and kv head.
    The JAX package also writes the trash entries, into page 0."""
    page = cache.page_size
    n = min(len(page_ids), single[0].shape[2] // page, sum(p != TRASH_PAGE for p in page_ids))
    if n <= skip_pages:
        return
    ids = torch.as_tensor(list(page_ids[skip_pages:n]), dtype=torch.long,
                          device=single[0].device)
    if isinstance(cache, PagedLatentCache):
        rows = single.kv[:, 0, skip_pages * page:n * page]
        cache.pages[:, ids] = rows.reshape(rows.shape[0], n - skip_pages, page, -1).to(
            cache.pages.dtype)
        return
    _, _, _, h_kv, dh = single.k.shape
    m = n - skip_pages
    for layer in range(single.k.shape[0]):
        for pool, scales, dense in ((cache.k_pages, cache.k_scales, single.k),
                                    (cache.v_pages, cache.v_scales, single.v)):
            rows = dense[layer, 0, skip_pages * page:n * page].reshape(m, page, h_kv, dh)
            if cache.token_major:
                s = get_quantization_scales(rows.float())  # (m, page, H_kv, 1)
                pool[layer, ids] = to_int8(rows.float(), s).reshape(m, page, h_kv * dh)
                scales[layer, ids] = s[..., 0]
            else:
                pool[layer][:, ids] = rows.permute(2, 0, 1, 3).to(pool.dtype)


def paged_insert(cache: PagedKVCache, single: KVCache, slot: int,
                 page_ids: Sequence[int], skip_pages: int = 0) -> None:
    """Copy a prefilled B=1 dense cache into the pool at ``page_ids`` (the
    slot's full table row, unused entries TRASH_PAGE) and install the row.
    The first ``skip_pages`` entries are installed but not copied: shared
    prefix pages already in the pool."""
    scatter_pages(cache, single, page_ids, skip_pages)
    cache.page_table[slot] = torch.as_tensor(list(page_ids), dtype=torch.int32)
    cache.lengths[slot] = single.length[0]


@torch.no_grad()
def fused_admit(lm: LlamaForCausalLM, cfg: LlamaConfig, inputs_embeds: torch.Tensor,
                attention_mask: torch.Tensor, prompt_len: int, cache: PagedKVCache,
                all_logits: torch.Tensor, slot: int, page_ids: Sequence[int]) -> None:
    """Admission: chunked prefill of the (1, S_pad, D) splice buffer up to the
    real prompt length, then the pool insert, the table row and the engine's
    logits row, all in place. The JAX package fuses these into one compiled
    dispatch; eager PyTorch needs no fusion for that."""
    if isinstance(cache, PagedLatentCache):
        # Whole pages, so that the prompt's last partial page is inserted too.
        rows = -(-max(inputs_embeds.shape[1], prompt_len) // cache.page_size) * cache.page_size
        single = mla.init_latent_cache(cfg, 1, rows, dtype=inputs_embeds.dtype,
                                       device=inputs_embeds.device)
        logits, single = mla.chunked_prefill(lm, cfg, inputs_embeds, attention_mask, single,
                                             lengths=[prompt_len])
        paged_insert(cache, single, slot, page_ids)
        all_logits[slot] = logits[0]
        return
    s_pad = inputs_embeds.shape[1]
    pad = (-s_pad) % PREFILL_CHUNK
    if pad:  # chunk windows tile the buffer exactly
        inputs_embeds = F.pad(inputs_embeds, (0, 0, 0, pad))
        attention_mask = F.pad(attention_mask, (0, pad))
    single = init_kv_cache(cfg, 1, s_pad + pad, dtype=inputs_embeds.dtype,
                           device=inputs_embeds.device, lm=lm)
    logits, single = chunked_prefill(lm, cfg, inputs_embeds, attention_mask, single,
                                     lengths=[prompt_len])
    paged_insert(cache, single, slot, page_ids)
    all_logits[slot] = logits[0]


def gather_slot_pages(cache: PagedKVCache, page_ids: Sequence[int]):
    """Raw contents (k, v, k_scales, v_scales) of ``page_ids`` for host
    offload (swap-out): int8 pages stay int8 with their scales, so a swap
    round trip is bit-exact."""
    ids = torch.as_tensor(list(page_ids), dtype=torch.long, device=cache.page_table.device)
    if isinstance(cache, PagedLatentCache):
        return cache.pages[:, ids], None, None, None
    if cache.token_major:
        return (cache.k_pages[:, ids], cache.v_pages[:, ids],
                cache.k_scales[:, ids], cache.v_scales[:, ids])
    return cache.k_pages[:, :, ids], cache.v_pages[:, :, ids], None, None


def insert_raw_pages(cache: PagedKVCache, k_src: torch.Tensor, v_src: torch.Tensor,
                     page_ids: Sequence[int], k_scales: Optional[torch.Tensor] = None,
                     v_scales: Optional[torch.Tensor] = None) -> None:
    """Inverse of :func:`gather_slot_pages` (swap-in): write raw page
    contents back into the pool at fresh ``page_ids``, without requantising."""
    dev = cache.page_table.device
    ids = torch.as_tensor(list(page_ids), dtype=torch.long, device=dev)
    if isinstance(cache, PagedLatentCache):
        cache.pages[:, ids] = k_src.to(dev)
    elif cache.token_major:
        cache.k_pages[:, ids] = k_src.to(dev)
        cache.v_pages[:, ids] = v_src.to(dev)
        cache.k_scales[:, ids] = k_scales.to(dev)
        cache.v_scales[:, ids] = v_scales.to(dev)
    else:
        cache.k_pages[:, :, ids] = k_src.to(dev)
        cache.v_pages[:, :, ids] = v_src.to(dev)


@torch.no_grad()
def paged_decode_step(lm: LlamaForCausalLM, cfg: LlamaConfig, token_embeds: torch.Tensor,
                      cache: PagedKVCache) -> torch.Tensor:
    """One decode step of every slot against the pool, attention before write.

    Row i's token lands at (page_table[i, len // page], len % page); the
    caller has allocated that page. Returns the logits (B, V) f32 and
    advances ``cache.lengths`` by one, in place.

    Routes, one named predicate per kernel: on the card an int8 pool takes
    K4 for attention and K5 for the install, a bf16 pool takes K6. On the
    CPU the step takes the JAX package's route off the TPU: the XLA twins
    (``attend_token_major_int8_stats`` / ``attend_paged_with_stats_xla``)
    and the plain installs, so its greedy tokens match the JAX package's.
    A latent pool takes :func:`paged_latent_decode_step`.
    """
    if isinstance(cache, PagedLatentCache):
        return paged_latent_decode_step(lm, cfg, token_embeds, cache)
    b = token_embeds.shape[0]
    page, pps = cache.page_size, cache.pages_per_seq
    on_card = token_embeds.device.type == "cuda"
    quantized = cache.quantized
    use_gathered_kernel = on_card and quantized            # K4
    use_fresh_write_kernel = on_card and quantized         # K5
    use_stats_kernel = on_card and not quantized           # K6
    # Released slots keep stepping with the batch: clamp so their trash-only
    # rows never index past the table.
    pos = cache.lengths.clamp(max=pps * page - 1).long()
    rows = torch.arange(b, device=pos.device)
    write_page = cache.page_table[rows, pos // page].long()
    write_off = pos % page
    cos, sin = rope_cos_sin_cfg(cfg, pos[:, None])
    dh = cfg.head_dim
    scale = dh ** -0.5
    kp, vp, kp_s, vp_s = cache.k_pages, cache.v_pages, cache.k_scales, cache.v_scales
    ppb = _pick_ppb(pps, page)
    lens32 = pos.int() if use_stats_kernel else None  # K6 reads int32 lengths as they lie

    fresh = []
    x = token_embeds
    for layer_idx, layer in enumerate(lm.model.layers):
        with gathered(layer):
            q, k, v = _qkv(layer, cfg, x, cos, sin)
            q = q[:, 0] * scale  # (B, H, Dh), pre-scaled
            k_new, v_new = k[:, 0], v[:, 0]  # (B, H_kv, Dh)
            # This rank's heads: all of them, or 1 / tp under tensor parallelism.
            h, h_kv = q.shape[1], k_new.shape[1]
            groups = h // h_kv
            if use_gathered_kernel:
                o_old, m_old, l_old = gathered_paged_attention_int8(
                    q, kp, vp, cache.page_table, pos, kp_s[layer_idx], vp_s[layer_idx],
                    pages_per_block=ppb, layer=layer_idx)
            elif quantized:
                o_old, m_old, l_old = attend_token_major_int8_stats(
                    q, kp[layer_idx], vp[layer_idx], cache.page_table, pos, kp_s[layer_idx],
                    vp_s[layer_idx])
            elif use_stats_kernel:
                o_old, m_old, l_old = paged_attention_with_stats(
                    q, kp[layer_idx], vp[layer_idx], lens32, cache.page_table)
            else:
                o_old, m_old, l_old = attend_paged_with_stats_xla(
                    q, kp[layer_idx], vp[layer_idx], cache.page_table, pos)
            # Fold the current token in exactly (query head j reads kv head j // groups).
            qg = q.reshape(b, h_kv, groups, dh).float()
            s_self = torch.einsum("bkgd,bkd->bkg", qg, k_new.float()).reshape(b, h)
            v_rep = v_new[:, :, None].expand(b, h_kv, groups, dh).reshape(b, h, dh)
            attn = merge_one_token(o_old, m_old, l_old, s_self, v_rep)
            x = x + proj(layer.self_attn.o_proj, attn.reshape(b, 1, -1))
            x = _mlp(layer, cfg, x)
        if quantized:
            ks = get_quantization_scales(k_new.float())  # (B, H_kv, 1)
            vs = get_quantization_scales(v_new.float())
            fresh.append((to_int8(k_new.float(), ks).reshape(b, h_kv * dh),
                          to_int8(v_new.float(), vs).reshape(b, h_kv * dh),
                          ks[..., 0], vs[..., 0]))
        else:
            fresh.append((k_new, v_new))
    logits = _final(lm, cfg, x)[:, 0]

    if quantized:
        k_vals, v_vals, ks, vs = (torch.stack(t) for t in zip(*fresh))  # (L, B, ...)
        kp_s[:, write_page, write_off] = ks
        vp_s[:, write_page, write_off] = vs
        install = paged_fresh_write if use_fresh_write_kernel else paged_fresh_write_xla
        install(kp, vp, k_vals, v_vals, write_page, write_off)
    else:
        k_vals, v_vals = (torch.stack(t) for t in zip(*fresh))  # (L, B, H_kv, Dh)
        kp[:, :, write_page, write_off] = k_vals.permute(0, 2, 1, 3).to(kp.dtype)
        vp[:, :, write_page, write_off] = v_vals.permute(0, 2, 1, 3).to(vp.dtype)
    cache.lengths += 1
    return logits


def latent_attention(q: torch.Tensor, rows: torch.Tensor, bias: torch.Tensor, scale: float,
                     rank: int) -> torch.Tensor:
    """Absorbed attention: q (B, H, R + Dr) over latent rows (B, S, R + Dr),
    ``bias`` (B, S) 0 or NEG_INF -> (B, H, R), the softmax over the scaled
    scores and the output over the first ``rank`` dims of the rows. Scores
    and softmax are float32: on the card the products take bf16 operands
    and write float32 (``out_dtype``), elsewhere they run in float32."""
    if rows.is_cuda and rows.dtype != torch.float32:
        scores = torch.bmm(q, rows.transpose(1, 2), out_dtype=torch.float32)
        probs = torch.softmax(scores * scale + bias[:, None], dim=-1)
        return torch.bmm(probs.to(rows.dtype), rows[..., :rank])
    scores = torch.einsum("bhr,bsr->bhs", q.float(), rows.float()) * scale + bias[:, None]
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhs,bsr->bhr", probs, rows[..., :rank].float()).to(q.dtype)


@torch.no_grad()
def paged_latent_decode_step(lm, cfg, token_embeds: torch.Tensor,
                             cache: PagedLatentCache) -> torch.Tensor:
    """One decode step of every slot against the latent pool, absorbed.

    Per layer the fresh token's row is written at (page_table[i, len //
    page], len % page) first; then ``W_UK`` is folded into q, the scores are
    taken over the slot's 576-wide rows up to and including the fresh one
    (the table row gathered whole, positions past the length masked), the
    output over the 512 latent dims goes through ``W_UV`` and ``o_proj``.
    Every shape is fixed by the slot count and the table width, so the step
    replays as one CUDA graph. Returns the logits (B, V) f32 and advances
    ``cache.lengths`` by one, in place. The expert load counters count the
    slots holding a request: those whose table row maps a page (a free
    slot's row is all ``TRASH_PAGE``; its length still advances)."""
    b = token_embeds.shape[0]
    page, pps = cache.page_size, cache.pages_per_seq
    pos = cache.lengths.clamp(max=pps * page - 1).long()
    valid = (cache.page_table[:, 0] != TRASH_PAGE)[:, None]
    rows = torch.arange(b, device=pos.device)
    write_page = cache.page_table[rows, pos // page].long()
    write_off = pos % page
    cos, sin = rope_cos_sin_cfg(cfg, pos[:, None])
    span = pps * page
    bias = torch.where(torch.arange(span, device=pos.device)[None] <= pos[:, None], 0.0,
                       mla.NEG_INF)
    table = cache.page_table.long()
    x = token_embeds
    for i, layer in enumerate(lm.model.layers):
        normed = llama_rms_norm(layer.input_layernorm, x, cfg.rms_norm_eps)
        q_nope, q_pe = mla.q_heads(layer, cfg, normed, cos, sin)
        fresh = mla.latent_rows(layer, cfg, normed, cos, sin)[:, 0]
        cache.pages[i, write_page, write_off] = fresh.to(cache.pages.dtype)
        w_uk, w_uv = mla.absorbed_weights(layer, cfg)
        q_lat = torch.einsum("bhd,hdr->bhr", q_nope[:, 0], w_uk.to(q_nope.dtype))
        q_full = torch.cat([q_lat, q_pe[:, 0]], dim=-1)
        slot_rows = cache.pages[i][table].reshape(b, span, -1)
        o_lat = latent_attention(q_full, slot_rows.to(q_full.dtype), bias, cfg.softmax_scale,
                                 cfg.kv_lora_rank)
        out = torch.einsum("bhr,hdr->bhd", o_lat, w_uv.to(o_lat.dtype))
        x = x + proj(layer.self_attn.o_proj, out.reshape(b, 1, -1))
        x = mla.ffn(layer, cfg, x, valid)
    logits = _final(lm, cfg, x)[:, 0]
    cache.lengths += 1
    return logits


class PageAllocator:
    """Host-side refcounted free list over logical pages (page 0 = trash).

    Shared prefix pages are ``retain``-ed once per slot that maps them and
    return to the free list when the last reference (the slots and the
    prefix registration itself) drops."""

    def __init__(self, total_pages: int):
        self._free: List[int] = list(range(total_pages - 1, 0, -1))
        self._rc: Dict[int, int] = {}

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def refcount(self, page: int) -> int:
        return self._rc.get(page, 0)

    def alloc(self, n: int) -> Optional[List[int]]:
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._rc[p] = 1
        return pages

    def retain(self, pages: List[int]) -> None:
        for p in pages:
            if p != TRASH_PAGE:
                self._rc[p] += 1

    def free(self, pages: List[int]) -> None:
        for p in pages:
            if p == TRASH_PAGE:
                continue
            self._rc[p] -= 1
            if self._rc[p] == 0:
                del self._rc[p]
                self._free.append(p)

    def pages_needed(self, tokens: int, page_size: int) -> int:
        return max(1, math.ceil(tokens / page_size))
