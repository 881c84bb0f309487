"""Multimodal token splicing under static shapes.

Port of ``videollamb_tpu/models/splice.py``: ``splice_multimodal`` and the
packed-row ``splice_multimodal_packed``. Every row is written into a fixed
``max_len`` buffer: the k-th X sentinel (id < 0) is replaced by visual block k, text
token i lands at i - (#sentinels before i) + (#visual tokens inserted
before i), visual tokens are labelled IGNORE_INDEX, and the attention mask
covers the spliced prefix (right padding).

The JAX version drops writes at indices >= ``max_len`` (``mode="drop"``),
which is how the reference truncation (llava_arch.py:610-613) falls out.
Torch scatters raise or assert on such indices, so here every write goes
into a buffer one slot longer, all out-of-range writes land in that extra
slot, and the slot is cut off.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from videollamb_torch.constants import IGNORE_INDEX


class SplicedBatch(NamedTuple):
    embeds: torch.Tensor          # (B, L, D)
    attention_mask: torch.Tensor  # (B, L) bool
    labels: torch.Tensor          # (B, L) int64
    lengths: torch.Tensor         # (B,) spliced lengths (after truncation)


def _scatter_rows(buf: torch.Tensor, target: torch.Tensor, src: torch.Tensor) -> None:
    """buf[b, target[b, i]] = src[b, i] along dim 1 (target clamped by caller)."""
    idx = target.long()
    if src.dim() == 3:
        idx = idx[..., None].expand(-1, -1, src.shape[-1])
    buf.scatter_(1, idx, src)


def splice_multimodal(input_ids: torch.Tensor, attention_mask: torch.Tensor,
                      labels: Optional[torch.Tensor], text_embeds: torch.Tensor,
                      x_embeds: torch.Tensor, x_mask: torch.Tensor,
                      max_len: int) -> SplicedBatch:
    """Batched splice. ``x_embeds`` (B, N, D) is one block per row; (B, K, N, D)
    binds block k to the row's k-th sentinel. Rows without a sentinel pass
    through as text."""
    return _splice(input_ids, attention_mask, labels, text_embeds, x_embeds, x_mask,
                   max_len)[0]


def packed_position_ids(segment_ids: torch.Tensor) -> torch.Tensor:
    """Per-segment positions of packed rows: 0 at the start of each run of one
    segment id. (B, L) -> (B, L) int64."""
    idx = torch.arange(segment_ids.shape[-1], device=segment_ids.device)
    prev = torch.cat([torch.full_like(segment_ids[..., :1], -1), segment_ids[..., :-1]], -1)
    starts = torch.where(segment_ids != prev, idx, 0)
    return idx - torch.cummax(starts, dim=-1).values


def splice_multimodal_packed(input_ids: torch.Tensor, attention_mask: torch.Tensor,
                             labels: Optional[torch.Tensor], segment_ids: torch.Tensor,
                             text_embeds: torch.Tensor, x_embeds: torch.Tensor,
                             x_mask: torch.Tensor, max_len: int):
    """Packed-row splice: each row holds several conversations numbered by
    ``segment_ids`` (1..S, 0 = padding). Visual tokens take the segment of the
    sentinel they replace; positions restart at each segment.

    Returns (SplicedBatch, spliced segment ids (B, L), position ids (B, L))."""
    spliced, seg = _splice(input_ids, attention_mask, labels, text_embeds, x_embeds,
                           x_mask, max_len, segment_ids)
    seg = torch.where(spliced.attention_mask, seg, 0)
    return spliced, seg, packed_position_ids(seg)


def _splice(input_ids, attention_mask, labels, text_embeds, x_embeds, x_mask, max_len,
            segment_ids=None):
    """The splice of one batch, and the spliced ``segment_ids`` (None without them)."""
    dev = input_ids.device
    ids = input_ids.long()
    text_valid = attention_mask.bool()
    if labels is None:
        labels = torch.where(text_valid, ids, IGNORE_INDEX)
    if x_embeds.dim() == 3:
        x_embeds, x_mask = x_embeds[:, None], x_mask[:, None]
    b, t = ids.shape
    k_max, n = x_embeds.shape[1], x_embeds.shape[2]
    d = text_embeds.shape[-1]
    x_mask = x_mask.bool()

    is_x = (ids < 0) & text_valid
    num_sent = is_x.sum(dim=1)                                   # (B,)
    sent_cum = torch.cumsum(is_x.long(), dim=1)                  # inclusive
    sent_rank = sent_cum - 1
    n_per_block = x_mask.sum(dim=-1)                             # (B, K)
    block_used = torch.arange(k_max, device=dev)[None] < num_sent[:, None]
    n_used = torch.where(block_used, n_per_block, 0)

    safe_rank = sent_rank.clamp(0, k_max - 1)
    nx_here = torch.where(is_x & (sent_rank < k_max),
                          torch.gather(n_used, 1, safe_rank), 0)
    cum_nx_before = torch.cumsum(nx_here, dim=1) - nx_here
    sent_before = sent_cum - is_x.long()
    pos = torch.arange(t, device=dev)[None]
    text_target = pos - sent_before + cum_nx_before
    text_target = torch.where(is_x | ~text_valid, max_len, text_target).clamp(0, max_len)

    # Position of the k-th sentinel (t if absent).
    sent_pos = torch.full((b, k_max + 1), t, dtype=torch.long, device=dev)
    scatter_rank = torch.where(is_x & (sent_rank < k_max), safe_rank, k_max)
    sent_pos.scatter_(1, scatter_rank, pos.expand(b, t).contiguous())
    sent_pos = sent_pos[:, :k_max]
    blk_cum = torch.cumsum(n_used, dim=1) - n_used
    base = sent_pos - torch.arange(k_max, device=dev)[None] + blk_cum  # (B, K)
    x_rank = torch.cumsum(x_mask.long(), dim=-1) - 1
    x_target = base[..., None] + x_rank
    x_ok = x_mask & block_used[..., None]
    x_target = torch.where(x_ok, x_target, max_len).clamp(0, max_len).reshape(b, k_max * n)

    embeds = text_embeds.new_zeros((b, max_len + 1, d))
    _scatter_rows(embeds, text_target, text_embeds)
    _scatter_rows(embeds, x_target, x_embeds.reshape(b, k_max * n, d).to(text_embeds.dtype))
    out_labels = torch.full((b, max_len + 1), IGNORE_INDEX, dtype=torch.long, device=dev)
    _scatter_rows(out_labels, text_target, labels.long())

    seg_out = None
    if segment_ids is not None:
        seg = segment_ids.long()
        seg_out = torch.zeros((b, max_len + 1), dtype=torch.long, device=dev)
        _scatter_rows(seg_out, text_target, seg)
        # Visual block k inherits the segment of the sentinel it replaces.
        x_seg = torch.gather(seg, 1, sent_pos.clamp(0, t - 1))  # (B, K)
        _scatter_rows(seg_out, x_target,
                      x_seg[..., None].expand(b, k_max, n).reshape(b, k_max * n))
        seg_out = seg_out[:, :max_len]

    total = text_valid.sum(dim=1) - num_sent + n_used.sum(dim=1)
    lengths = total.clamp(max=max_len)
    attn = torch.arange(max_len, device=dev)[None] < lengths[:, None]
    return (SplicedBatch(embeds=embeds[:, :max_len], attention_mask=attn,
                         labels=out_labels[:, :max_len], lengths=lengths), seg_out)
