"""int8 paged decode attention over the token-major pool (kernel K4).

Port of ``videollamb_tpu/ops/gathered_paged_attention.py``. The quantised
pool is token-major: one layer is ``(P, page, H_kv * Dh)`` int8 with
per-token scales ``(P, page, H_kv)``, so a token's heads are contiguous.
Every function returns the softmax-stats contract of
``ops/paged_attention_stats``: ``(out (B, H, Dh), m (B, H), l (B, H))``
over each slot's first ``lengths`` tokens; zero-length slots give out = 0,
m = -inf, l = 0.

- :func:`gathered_paged_attention_int8` launches
  ``csrc/gathered_paged_attention.cu`` on a CUDA tensor and runs
  :func:`gathered_paged_attention_int8_reference` on a CPU tensor.
- :func:`gathered_paged_attention_int8_reference` states the TPU kernel's
  numerics: the query quantised per head, exact integer Q.K, a flash
  (m, l) over blocks of ``pages_per_block * page`` tokens with tokens past
  the length at ``MASK_VALUE``, and probabilities (v-scale folded in)
  requantised per (head, block) before an exact integer P.V.
- :func:`attend_token_major_int8_stats` is the JAX package's XLA twin, which
  requantises the probabilities per row over the whole pool instead; the
  paged decode step runs it on the CPU, as the JAX package does off the TPU.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from videollamb_torch.kernels import build as kb
from videollamb_torch.ops.paged_attention_stats import attend_pool_int8_stats
from videollamb_torch.ops.quantization import MAX_INT8, exact_div, round_to_int8
from videollamb_torch.ops.split_merge import merge_counters

MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)
TARGET_BLOCK_TOKENS = 512

Stats = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _pick_ppb(pps: int, page: int, target_tokens: int = TARGET_BLOCK_TOKENS) -> int:
    """Largest divisor of pages_per_seq whose block stays <= target tokens
    (512 at 7B serving shapes: 8 pages of 64, five blocks of a 40-page slot)."""
    best = 1
    for ppb in range(1, pps + 1):
        if pps % ppb == 0 and ppb * page <= target_tokens:
            best = ppb
    return best


def gathered_paged_attention_int8_reference(
        q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
        page_table: torch.Tensor, lengths: torch.Tensor, k_scales: torch.Tensor,
        v_scales: torch.Tensor, *, pages_per_block: int) -> Stats:
    """Plain PyTorch statement of the TPU kernel on one layer:
    q (B, H, Dh); pools (P, page, H_kv * Dh) int8; scales (P, page, H_kv)."""
    b, h, dh = q.shape
    _, page, kd = k_pool.shape
    h_kv = k_scales.shape[2]
    groups = h // h_kv
    pps = page_table.shape[1]
    t = pages_per_block * page
    dev = q.device

    qf = q.float()
    qs = qf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30)  # (B, H, 1)
    q_i8 = round_to_int8(qf * exact_div(MAX_INT8, qs)).reshape(b, h_kv, groups, dh)
    qs = qs.reshape(b, h_kv, groups, 1)
    table = page_table.long()
    m = torch.full((b, h_kv, groups, 1), -torch.inf, device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, h_kv, groups, dh), device=dev)
    for i in range(pps // pages_per_block):
        pages = table[:, i * pages_per_block:(i + 1) * pages_per_block]  # (B, ppb)
        k_blk = k_pool[pages].reshape(b, t, h_kv, dh)
        v_blk = v_pool[pages].reshape(b, t, h_kv, dh)
        ks = k_scales[pages].reshape(b, t, h_kv).permute(0, 2, 1)[:, :, None]  # (B, K, 1, T)
        vs = v_scales[pages].reshape(b, t, h_kv).permute(0, 2, 1)[:, :, None]
        s_int = torch.einsum("bkgd,btkd->bkgt", q_i8.double(), k_blk.double())
        s = s_int.float() * exact_div(qs * ks, MAX_INT8 * MAX_INT8)
        tok = i * t + torch.arange(t, device=dev)
        valid = (tok[None] < lengths[:, None])[:, None, None]  # (B, 1, 1, T)
        s = torch.where(valid, s, MASK_VALUE)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)  # masked tokens underflow to exactly 0
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        w = torch.where(valid, p * exact_div(vs, MAX_INT8), 0.0)
        wscale = w.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30)
        w_i8 = round_to_int8(w * exact_div(MAX_INT8, wscale))
        o_int = torch.einsum("bkgt,btkd->bkgd", w_i8.double(), v_blk.double())
        acc = acc * alpha + o_int.float() * exact_div(wscale, MAX_INT8)
        m = m_new
    out = acc / l.clamp_min(1e-30)
    # A block wholly past a slot's length leaves its (m, l, acc) exactly as
    # they were (alpha = 1, p = 0), so only zero-length slots need fixing.
    live = (lengths > 0)[:, None]
    out = torch.where(live[..., None], out.reshape(b, h, dh), 0.0).to(q.dtype)
    m = torch.where(live, m.reshape(b, h), -torch.inf)
    l = torch.where(live, l.reshape(b, h), 0.0)
    return out, m, l


def gathered_paged_attention_int8(
        q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
        page_table: torch.Tensor, lengths: torch.Tensor, k_scales: torch.Tensor,
        v_scales: torch.Tensor, *, pages_per_block: int,
        layer: Optional[int] = None) -> Stats:
    """Decode attention over one layer of the token-major int8 pool.

    The pools are (P, page, H_kv * Dh), or (L, P, page, H_kv * Dh) with
    ``layer`` naming the layer; the scales are one layer's (P, page, H_kv).
    A length past the table's width (pps x page tokens) counts as that
    width: the kernel cuts it before it reads a page, as the plain version
    and the TPU kernel's grid see only the table's tokens.

    The kernel splits each slot into its requantisation blocks of
    ``pages_per_block * page`` tokens (one block of the grid each, for all
    query heads of a kv head) and merges them in the same launch, through
    the counters of ``ops/split_merge.py``."""
    if k_pool.ndim == 4:
        k_pool, v_pool = k_pool[layer or 0], v_pool[layer or 0]
    if q.device.type == "cpu":
        return gathered_paged_attention_int8_reference(
            q, k_pool, v_pool, page_table, lengths, k_scales, v_scales,
            pages_per_block=pages_per_block)
    b, h, dh = q.shape
    _, page, kd = k_pool.shape
    h_kv = k_scales.shape[2]
    pps = page_table.shape[1]
    t = pages_per_block * page
    if (q.device.type != "cuda" or dh != 128 or kd != h_kv * dh or h % h_kv or h // h_kv > 8
            or k_pool.dtype != torch.int8 or v_pool.dtype != torch.int8
            or k_scales.dtype != torch.float32 or v_scales.dtype != torch.float32
            or pps % pages_per_block or t % 16 or t > 1024):
        raise ValueError(
            "gathered int8 kernel takes CUDA q (B, H, 128), int8 (P, page, H_kv * 128) pools, "
            "f32 (P, page, H_kv) scales, H / H_kv <= 8 and a block of at most 1024 tokens, a "
            "multiple of 16, dividing the table; got "
            f"q {q.dtype} {tuple(q.shape)}, pool {k_pool.dtype} {tuple(k_pool.shape)}, "
            f"scales {k_scales.dtype} {tuple(k_scales.shape)}, {pps} pages per slot, "
            f"{pages_per_block} per block, on {q.device}")
    kb.refuse_grad("gathered_paged_attention_int8", q, k_pool, v_pool, k_scales, v_scales)
    qf = q.float().contiguous()
    if qf.data_ptr() % 16:  # the kernel reads q rows as 16-byte vectors
        qf = qf.clone()
    k_pool, v_pool = k_pool.contiguous(), v_pool.contiguous()
    k_scales, v_scales = k_scales.contiguous(), v_scales.contiguous()
    table = page_table.to(torch.int32).contiguous()
    lens = lengths.to(torch.int32).contiguous()
    n_blocks = pps // pages_per_block
    counters = merge_counters(q.device, b * h_kv)
    partials = torch.empty(b * h * n_blocks * (dh + 2), dtype=torch.float32, device=q.device)
    out = torch.empty((b, h, dh), dtype=torch.float32, device=q.device)
    m = torch.empty((b, h), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    kb.check(kb.kernels().gathered_paged_attention_int8(
        kb.ptr(qf), kb.ptr(k_pool), kb.ptr(v_pool), kb.ptr(k_scales), kb.ptr(v_scales),
        kb.ptr(table), kb.ptr(lens), kb.ptr(out), kb.ptr(m), kb.ptr(l), kb.ptr(partials),
        kb.ptr(counters), b, h, h_kv, pps, page, t, kb.current_stream(q.device)),
        "gathered_paged_attention_int8")
    gathered_paged_attention_int8.launches += 1
    return out.to(q.dtype), m, l


gathered_paged_attention_int8.launches = 0


def attend_token_major_int8_stats(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                                  page_table: torch.Tensor, lengths: torch.Tensor,
                                  k_scales: torch.Tensor, v_scales: torch.Tensor) -> Stats:
    """The JAX package's XLA twin: one layer's token-major pool transposed
    to head-major, through :func:`attend_pool_int8_stats`."""
    p_total, page, kd = k_pool.shape
    h_kv = k_scales.shape[2]
    dh = kd // h_kv
    kp = k_pool.reshape(p_total, page, h_kv, dh).permute(2, 0, 1, 3)
    vp = v_pool.reshape(p_total, page, h_kv, dh).permute(2, 0, 1, 3)
    ks = k_scales.permute(2, 0, 1)[..., None]
    vs = v_scales.permute(2, 0, 1)[..., None]
    return attend_pool_int8_stats(q, kp, vp, page_table, lengths, ks, vs)
