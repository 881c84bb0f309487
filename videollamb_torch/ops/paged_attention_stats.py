"""Paged decode attention that also returns its softmax statistics (m, l)
(kernel K6), and the plain statements the paged decode step runs.

Port of ``videollamb_tpu/ops/paged_attention_stats.py``. Every function
returns ``(out (B, H, Dh), m (B, H), l (B, H))``: attention of the
pre-scaled query over each slot's first ``lengths`` resident tokens with
the running max and normaliser, so the decode step can fold the current
token in exactly with :func:`merge_one_token`. Zero-length slots give
out = 0, m = -inf, l = 0.

- :func:`paged_attention_with_stats` launches ``csrc/paged_attention_stats.cu``
  on a CUDA tensor (bf16 head-major pages) and runs its plain version,
  :func:`attend_paged_with_stats_xla`, on a CPU tensor. The kernel splits
  each slot's tokens into blocks of :data:`SPLIT_TOKENS` (whole pages) and
  merges the splits in the same launch (``ops/split_merge.py`` keeps the
  counters that merge rests on, shared with K4). Lengths past the table's
  width count as its width, as in the plain version.
- :func:`attend_paged_with_stats_xla` is the gather statement (the JAX
  package's XLA twin; its int8 form is not ported: int8 pools are
  token-major and go through the next function).
- :func:`attend_pool_int8_stats` is the JAX package's shared-pool int8
  statement, which the CPU route of the int8 token-major pool runs (through
  ``ops/gathered_paged_attention.attend_token_major_int8_stats``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from videollamb_torch.kernels import build as kb
from videollamb_torch.ops.quantization import MAX_INT8, exact_div, round_to_int8
from videollamb_torch.ops.split_merge import merge_counters

Stats = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


SPLIT_TOKENS = 256  # tokens a block of the kernel attends over, rounded to whole pages


def _split_tokens(page: int) -> int:
    return max(1, SPLIT_TOKENS // page) * page


@kb.counted
def paged_attention_with_stats(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                               lengths: torch.Tensor, page_indices: torch.Tensor) -> Stats:
    """q (B, H, Dh) pre-scaled; pages (H_kv, P, page, Dh); lengths (B,);
    page_indices (B, pps). Returns (out in q's dtype, m, l f32)."""
    if q.device.type == "cpu":
        return attend_paged_with_stats_xla(q, k_pages, v_pages, page_indices, lengths)
    b, h, dh = q.shape
    h_kv, p_total, page, _ = k_pages.shape
    pps = page_indices.shape[1]
    if (q.device.type != "cuda" or dh != 128 or h % h_kv or h // h_kv > 8
            or q.dtype not in (torch.float32, torch.bfloat16)
            or k_pages.dtype != torch.bfloat16 or v_pages.dtype != torch.bfloat16
            or v_pages.shape != k_pages.shape or k_pages.shape[3] != dh):
        raise ValueError(
            "paged attention kernel takes CUDA f32 or bf16 q (B, H, 128) and bf16 "
            "(H_kv, P, page, 128) pages with H / H_kv <= 8; got q "
            f"{q.dtype} {tuple(q.shape)}, pages {k_pages.dtype} {tuple(k_pages.shape)} "
            f"on {q.device}")
    kb.refuse_grad("paged_attention_with_stats", q, k_pages, v_pages)
    q = q.contiguous()
    k_pages, v_pages = k_pages.contiguous(), v_pages.contiguous()
    table = page_indices.to(torch.int32).contiguous()
    lens = lengths.to(torch.int32).contiguous()
    split = _split_tokens(page)
    splits = -(-pps * page // split)
    counters = merge_counters(q.device, b * h_kv)
    partials = torch.empty(b * h * splits * (dh + 2), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    m = torch.empty((b, h), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    kb.check(kb.kernels().paged_attention_stats(
        kb.ptr(q), int(q.dtype == torch.bfloat16), kb.ptr(k_pages), kb.ptr(v_pages),
        kb.ptr(table), kb.ptr(lens), kb.ptr(out), kb.ptr(m), kb.ptr(l), kb.ptr(partials),
        kb.ptr(counters), b, h, h_kv, p_total, pps, page, split,
        kb.current_stream(q.device)), "paged_attention_stats")
    paged_attention_with_stats.launches += 1
    return out, m, l


def attend_paged_with_stats_xla(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                                page_indices: torch.Tensor, lengths: torch.Tensor) -> Stats:
    """Gather statement of the contract over (H_kv, P, page, Dh) pages."""
    b, h, dh = q.shape
    h_kv, _, page, _ = k_pages.shape
    s_virt = page_indices.shape[1] * page
    idx = page_indices.long()
    k = k_pages[:, idx].reshape(h_kv, b, s_virt, dh).float()  # gathered per slot
    v = v_pages[:, idx].reshape(h_kv, b, s_virt, dh).float()
    qg = q.reshape(b, h_kv, h // h_kv, dh).float()
    s = torch.einsum("bkgd,kbsd->bkgs", qg, k)
    valid = (torch.arange(s_virt, device=q.device)[None] < lengths[:, None])[:, None, None]
    s = s.masked_fill(~valid, -torch.inf)
    m = s.amax(dim=-1)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)  # all-masked rows
    e = torch.exp(s - m_safe[..., None]) * valid
    l = e.sum(dim=-1)
    o = torch.einsum("bkgs,kbsd->bkgd", e, v) / l.clamp_min(1e-30)[..., None]
    o = o * (lengths > 0)[:, None, None, None]
    return o.reshape(b, h, dh).to(q.dtype), m.reshape(b, h), l.reshape(b, h)


def attend_pool_int8_stats(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                           page_table: torch.Tensor, lengths: torch.Tensor,
                           k_scales: torch.Tensor, v_scales: torch.Tensor) -> Stats:
    """Shared-pool int8 statement: every slot attends over the whole layer
    pool (H_kv, P, page, Dh) int8 under an ownership mask from its page
    table. The query is quantised per (B, H) row and the probabilities,
    with the v-scale folded in, per row over the whole pool; both products
    are exact integer sums (f64 holds them exactly)."""
    b, h, dh = q.shape
    h_kv, p_layer, page, _ = k_pool.shape
    groups = h // h_kv
    pps = page_table.shape[1]
    s_pool = p_layer * page
    dev = q.device

    j = torch.arange(pps, device=dev)
    counts = (lengths[:, None] - j[None] * page).clamp(0, page)  # (B, pps)
    own = torch.zeros((b, p_layer), dtype=counts.dtype, device=dev).scatter_reduce(
        1, page_table.long(), counts, reduce="amax")
    pos = torch.arange(s_pool, device=dev)
    valid = ((pos % page)[None] < own[:, pos // page])[:, None, None]  # (B, 1, 1, S)

    qf = q.float()
    q_scale = qf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30)
    q_i8 = round_to_int8(qf * exact_div(MAX_INT8, q_scale))
    k = k_pool.reshape(h_kv, s_pool, dh)
    ks = k_scales.reshape(h_kv, s_pool)
    s_int = torch.einsum("bkgd,ksd->bkgs", q_i8.reshape(b, h_kv, groups, dh).double(),
                         k.double())
    s = s_int.float() * exact_div(q_scale.reshape(b, h_kv, groups, 1) * ks[None, :, None, :],
                                  MAX_INT8 * MAX_INT8)
    s = s.masked_fill(~valid, -torch.inf)
    m = s.amax(dim=-1)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    e = torch.exp(s - m_safe[..., None]) * valid
    l = e.sum(dim=-1)

    vs = v_scales.reshape(h_kv, s_pool)
    w = e * exact_div(vs[None, :, None, :], MAX_INT8)
    w_scale = w.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30)
    w_i8 = round_to_int8(w * exact_div(MAX_INT8, w_scale))
    o_int = torch.einsum("bkgs,ksd->bkgd", w_i8.double(),
                         v_pool.reshape(h_kv, s_pool, dh).double())
    o = o_int.float() * exact_div(w_scale, MAX_INT8)
    o = o / l.clamp_min(1e-30)[..., None]
    o = o * (lengths > 0)[:, None, None, None]
    return o.reshape(b, h, dh).to(q.dtype), m.reshape(b, h), l.reshape(b, h)


def merge_one_token(o_old: torch.Tensor, m_old: torch.Tensor, l_old: torch.Tensor,
                    s_self: torch.Tensor, v_new: torch.Tensor) -> torch.Tensor:
    """Exact log-sum-exp fold of one extra key into a normalised result:
    softmax([old scores, s_self]) @ [V_old; v_new]. s_self (B, H) f32 is the
    pre-scaled q . k_new; v_new (B, H, Dh) is already grouped."""
    m_new = torch.maximum(m_old, s_self)
    alpha = torch.exp(m_old - m_new) * l_old
    beta = torch.exp(s_self - m_new)
    denom = alpha + beta
    o = (alpha[..., None] * o_old.float() + beta[..., None] * v_new.float()) / denom[..., None]
    return o.to(o_old.dtype)
