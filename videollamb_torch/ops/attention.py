"""Multi-head attention dispatch (port of ``videollamb_tpu/ops/attention.py``).

One entry point for the LM's fresh-key attention, mirroring the JAX
``attn_impl`` switch:

- ``kernel`` -- the flash kernel (``ops/flash_attention.py``), heads
  repeated for grouped-query attention as on the TPU path;
- ``torch``  -- the plain grouped-einsum statement (the JAX package's
  ``_xla_attention``);
- ``auto``   -- ``kernel`` for CUDA tensors, ``torch`` otherwise.

The chunked, differentiable variant the JAX package uses for training is
not ported yet.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from videollamb_torch.ops.flash_attention import NEG_INF, flash_attention


def multihead_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = False,
                        k_mask: Optional[torch.Tensor] = None,
                        scale: Optional[float] = None,
                        impl: str = "auto") -> torch.Tensor:
    """q (B, Sq, H, Dh), k/v (B, Skv, Hkv, Dh) -> (B, Sq, H, Dh) in q's dtype."""
    h, dh = q.shape[2], q.shape[3]
    hkv = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(dh)
    if impl == "auto":
        impl = "kernel" if q.device.type == "cuda" else "torch"
    if impl == "kernel":
        if hkv != h:
            k = k.repeat_interleave(h // hkv, dim=2)
            v = v.repeat_interleave(h // hkv, dim=2)
        # The kernel reads the transposed views as they lie and writes out with
        # q's strides, so the transpose back is the dense (B, Sq, H, Dh).
        out = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                              k_mask, causal=causal, scale=scale)
        return out.transpose(1, 2)
    if impl == "torch":
        return _torch_attention(q, k, v, causal=causal, k_mask=k_mask, scale=scale)
    raise ValueError(f"unknown attention impl {impl!r} (auto, kernel, torch)")


def _torch_attention(q, k, v, *, causal, k_mask, scale):
    b, sq, h, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    qg = q.reshape(b, sq, hkv, g, dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    mask = torch.ones((b, sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        q_pos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
        mask = mask & (q_pos >= torch.arange(skv, device=q.device)[None, :])[None]
    if k_mask is not None:
        mask = mask & k_mask.bool()[:, None, :]
    s = s.masked_fill(~mask[:, None, None], NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.float(), v.float()).to(q.dtype)
    return out.reshape(b, sq, h, dh)
