"""Multi-head attention dispatch (port of ``videollamb_tpu/ops/attention.py``).

One entry point for the LM's fresh-key attention, mirroring the JAX
``attn_impl`` switch:

- ``kernel``  -- the flash kernel (``ops/flash_attention.py``), heads
  repeated for grouped-query attention as on the TPU path; forward only;
- ``chunked`` -- online softmax over key blocks of ``block_kv`` tokens
  (the JAX package's ``_chunked_attention``): the same O(Sq * block_kv)
  score memory as flash attention, in plain PyTorch, so autograd reaches
  q, k and v. Training takes this route;
- ``torch``   -- the plain grouped-einsum statement (the JAX package's
  ``_xla_attention``);
- ``auto``    -- ``kernel`` for CUDA tensors, ``torch`` otherwise.

All three compute the same math: f32 scores, causal and key-validity
masks, grouped-query heads, an optional sliding ``window`` (causal only: a
query at position ``q_pos = i + (Skv - Sq)`` sees key ``k_pos`` when
``0 <= q_pos - k_pos < window``, Mistral's band) and, for packed rows,
``segment_ids`` (a query sees only keys of its own segment). The kernel has no segment lane, so
``segment_ids`` with ``kernel`` (or ``auto`` on a CUDA tensor) raises: a
packed batch passes ``chunked`` or ``torch`` itself.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from videollamb_torch.ops.flash_attention import NEG_INF, flash_attention

BLOCK_KV = 512  # keys per step of the chunked online softmax


def multihead_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = False,
                        k_mask: Optional[torch.Tensor] = None,
                        scale: Optional[float] = None,
                        impl: str = "auto",
                        segment_ids: Optional[torch.Tensor] = None,
                        window: Optional[int] = None) -> torch.Tensor:
    """q (B, Sq, H, Dh), k/v (B, Skv, Hkv, Dh) -> (B, Sq, H, Dh) in q's dtype.

    ``segment_ids`` (B, S) needs Sq == Skv (a forward without a cache).
    ``window`` needs ``causal``; the kernel computes the band itself (K3's
    key-tile loop starts at the window's first tile), and so counts causal
    positions from 0 on both sides: it takes Sq == Skv only."""
    h, dh = q.shape[2], q.shape[3]
    hkv = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(dh)
    if impl == "auto":
        impl = "kernel" if q.device.type == "cuda" else "torch"
    if impl == "kernel" and segment_ids is not None:
        raise ValueError("the flash kernel has no segment lane: pass impl='chunked' "
                         "or impl='torch' with segment_ids")
    if window is not None and not causal:
        raise ValueError("a sliding window needs causal attention")
    if impl == "kernel":
        if window is not None and q.shape[1] != k.shape[1]:
            raise ValueError("the flash kernel's window takes Sq == Skv (a prefill); "
                             f"got Sq {q.shape[1]}, Skv {k.shape[1]}")
        if hkv != h:
            k = k.repeat_interleave(h // hkv, dim=2)
            v = v.repeat_interleave(h // hkv, dim=2)
        # The kernel reads the transposed views as they lie and writes out with
        # q's strides, so the transpose back is the dense (B, Sq, H, Dh).
        out = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                              k_mask, causal=causal, scale=scale, window=window)
        return out.transpose(1, 2)
    if impl == "chunked":
        return _chunked_attention(q, k, v, causal=causal, k_mask=k_mask, scale=scale,
                                  segment_ids=segment_ids, window=window)
    if impl == "torch":
        return _torch_attention(q, k, v, causal=causal, k_mask=k_mask, scale=scale,
                                segment_ids=segment_ids, window=window)
    raise ValueError(f"unknown attention impl {impl!r} (auto, kernel, chunked, torch)")


def _torch_attention(q, k, v, *, causal, k_mask, scale, segment_ids=None, window=None):
    b, sq, h, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    qg = q.reshape(b, sq, hkv, g, dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    mask = torch.ones((b, sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        dist = (torch.arange(sq, device=q.device)[:, None] + (skv - sq)
                - torch.arange(skv, device=q.device)[None, :])
        mask = mask & (dist >= 0)[None]
        if window is not None:
            mask = mask & (dist < window)[None]
    if k_mask is not None:
        mask = mask & k_mask.bool()[:, None, :]
    if segment_ids is not None:
        mask = mask & (segment_ids[:, :, None] == segment_ids[:, None, :])
    s = s.masked_fill(~mask[:, None, None], NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.float(), v.float()).to(q.dtype)
    return out.reshape(b, sq, h, dh)


def _chunk_step(m_prev, l_prev, acc, qg, kc, vc, kmc, seg_q, seg_kc, lo: int,
                q_off: Optional[int], scale: float, window: Optional[int] = None):
    """One key block of the online softmax: returns the updated (m, l, acc).

    qg (B, Sq, Hkv, G, Dh), kc/vc (B, bkv, Hkv, Dh), kmc (B, bkv) key
    validity, seg_q (B, Sq) / seg_kc (B, bkv) segment ids or None, ``lo`` the
    block's first key position, ``q_off`` the first query's position when
    causal (Skv - Sq), else None, ``window`` the causal band or None;
    m/l (B, Hkv, G, Sq, 1) and acc
    (B, Hkv, G, Sq, Dh) are f32. The block's mask is built here, so a
    recompute needs only these inputs."""
    sq, bkv = qg.shape[1], kc.shape[1]
    valid = kmc[:, None, :].expand(-1, sq, -1)
    if q_off is not None:
        dist = (torch.arange(sq, device=qg.device)[:, None] + q_off
                - torch.arange(lo, lo + bkv, device=qg.device)[None, :])
        valid = valid & (dist >= 0)[None]
        if window is not None:
            valid = valid & (dist < window)[None]
    if seg_q is not None:
        valid = valid & (seg_q[:, :, None] == seg_kc[:, None, :])
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), kc.float()) * scale
    s = s.masked_fill(~valid[:, None, None], NEG_INF)
    m_new = torch.maximum(m_prev, s.amax(dim=-1, keepdim=True))
    p = torch.exp(s - m_new)
    corr = torch.exp(m_prev - m_new)
    l_new = l_prev * corr + p.sum(dim=-1, keepdim=True)
    pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(vc.dtype).float(), vc.float())
    return m_new, l_new, acc * corr + pv


def _chunked_attention(q, k, v, *, causal, k_mask, scale, block_kv: int = BLOCK_KV,
                       segment_ids=None, window=None):
    """Online softmax over key blocks, differentiable.

    The running max m, sum l and accumulator are f32; keys past Skv (when
    ``block_kv`` does not divide it) are padded and masked, their segment id
    -1 so padding matches no segment; a row that sees no key at all ends with
    l == 0 and is divided by 1. When a gradient is wanted each block's body
    runs under ``torch.utils.checkpoint``: the backward recomputes the block's
    scores from q and k instead of keeping them, so the saved memory is the
    O(Sq * Dh) carry per block, never the O(Sq * Skv) scores (the JAX
    package's ``jax.checkpoint`` of the scan body)."""
    b, sq, h, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    dev = q.device
    bkv = min(block_kv, skv)
    n_chunks = -(-skv // bkv)
    pad = n_chunks * bkv - skv
    pad_keys = (0, 0, 0, 0, 0, pad)
    k, v = torch.nn.functional.pad(k, pad_keys), torch.nn.functional.pad(v, pad_keys)
    km = (torch.ones((b, skv), dtype=torch.bool, device=dev) if k_mask is None
          else k_mask.bool())
    km = torch.nn.functional.pad(km, (0, pad), value=False)
    seg_k = None
    if segment_ids is not None:
        seg_k = torch.nn.functional.pad(segment_ids.long(), (0, pad), value=-1)
    qg = q.reshape(b, sq, hkv, g, dh)

    m = torch.full((b, hkv, g, sq, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hkv, g, sq, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hkv, g, sq, dh), dtype=torch.float32, device=dev)
    remat = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                         or v.requires_grad)
    for lo in range(0, n_chunks * bkv, bkv):
        hi = lo + bkv
        args = (m, l, acc, qg, k[:, lo:hi], v[:, lo:hi], km[:, lo:hi], segment_ids,
                None if seg_k is None else seg_k[:, lo:hi], lo,
                skv - sq if causal else None, scale, window)
        if remat:
            m, l, acc = checkpoint(_chunk_step, *args, use_reentrant=False)
        else:
            m, l, acc = _chunk_step(*args)
    out = acc / torch.where(l == 0.0, 1.0, l)
    out = out.to(q.dtype).permute(0, 3, 1, 2, 4)  # (B, Sq, Hkv, G, Dh)
    return out.reshape(b, sq, h, dh)
