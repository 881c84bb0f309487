"""Flash attention forward for the LM prefill (kernel K3) and whole-row
block attention for short sequences (kernel K11).

Port of ``videollamb_tpu/ops/flash_attention.py::flash_attention``:
attention on (B, H, S, Dh) with an optional causal mask (``q_pos >=
k_pos``, both counted from 0, as in the TPU kernel), an optional
per-key validity mask (B, Skv) and, with causal, an optional sliding
``window`` (``q_pos - k_pos < window``: Mistral's band, which the JAX
package computes in XLA because its Pallas kernel has none; here the
kernel's key-tile loop starts at the band's first tile). Grouped-query
heads are repeated by the caller (``ops/attention.py``).

- :func:`flash_attention` launches ``csrc/flash_attention.cu`` on a CUDA
  tensor and runs :func:`flash_attention_reference` on a CPU tensor.
- :func:`flash_attention_reference` is the plain PyTorch statement.

A query row with no valid key (no key both valid in ``k_mask`` and
visible: causally and inside the window) gives the mean of v over all Skv
keys, as the JAX
package's ``_xla_attention`` does: its finite -1e30 mask makes such a row's
softmax uniform. The kernel writes that mean in its epilogue (rows with
l == 0); the plain version sets those rows with
:func:`_fill_rows_without_keys`. Right-padded prefill has no such row.

The kernel takes q / out and k / v with any element strides whose last
dimension is dense and whose rows are 16-byte aligned, so the transposed
(B, S, H, Dh) -> (B, H, S, Dh) views of the LM's projections go in without
a copy, and ``out`` is allocated with q's strides: its transpose back is
the dense (B, S, H, Dh) the output projection reads. A bool or uint8 key
mask is read as it is. On the prefill path a call is one launch.

:func:`block_attention` (K11) ports the JAX package's ``block_attention``:
all keys at once (no online softmax), causal from position 0 even when
Sq != Skv, no key mask, the scale applied to the f32 scores, and the
NORMALISED probabilities rounded to the value dtype before the product
with V (K3 rounds the unnormalised ones and divides at the end). On a CUDA
tensor it launches ``csrc/block_attention.cu`` (any Skv, head dim 64 or
128, bf16); on a CPU tensor it runs :func:`block_attention_reference`.

Both kernels are forward only, as in the JAX package: their wrappers
refuse inputs that want a gradient. Training attention is the chunked
route, ``multihead_attention(..., impl="chunked")`` in ``ops/attention.py``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from videollamb_torch.kernels import build as kb

NEG_INF = -1e30
_NO_GRAD_ATTENTION = ("for gradients use the chunked route, "
                      "ops.attention.multihead_attention(..., impl='chunked')")


def _fill_rows_without_keys(out: torch.Tensor, v: torch.Tensor,
                            k_mask: Optional[torch.Tensor], causal: bool,
                            window: Optional[int] = None) -> torch.Tensor:
    """Rows with no valid, visible key take the mean of v over all keys."""
    if k_mask is None:
        return out
    sq = out.shape[2]
    valid = k_mask.bool()
    if causal:  # the valid keys in (i - window, min(i, Skv-1)] are a difference of counts
        seen = torch.nn.functional.pad(valid.long().cumsum(dim=1), (1, 0))  # seen[j]: keys < j
        rows = torch.arange(sq, device=out.device)
        hi = rows.clamp(max=valid.shape[1] - 1) + 1
        lo = ((rows - window + 1).clamp(min=0, max=valid.shape[1]) if window is not None
              else torch.zeros_like(rows))
        has_key = (seen[:, hi] - seen[:, lo]) > 0  # (B, Sq)
    else:
        has_key = valid.any(dim=1, keepdim=True).expand(-1, sq)
    mean_v = v.mean(dim=2, keepdim=True, dtype=torch.float32).to(out.dtype)  # (B, H, 1, Dh)
    return torch.where(has_key[:, None, :, None], out, mean_v, out=out)


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              k_mask: Optional[torch.Tensor] = None, *,
                              causal: bool = False,
                              scale: Optional[float] = None,
                              window: Optional[int] = None) -> torch.Tensor:
    """(B, H, Sq, Dh) attention in plain PyTorch; returns q's dtype."""
    b, h, sq, dh = q.shape
    skv = k.shape[2]
    _check_window(window, causal)
    if scale is None:
        scale = 1.0 / math.sqrt(dh)
    s = (q.float() @ k.float().transpose(-1, -2)) * scale  # (B, H, Sq, Skv)
    valid = torch.ones((b, 1, sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        dist = (torch.arange(sq, device=q.device)[:, None]
                - torch.arange(skv, device=q.device)[None, :])
        valid = valid & (dist >= 0)
        if window is not None:
            valid = valid & (dist < window)
    if k_mask is not None:
        valid = valid & k_mask.bool()[:, None, None, :]
    s = s.masked_fill(~valid, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * valid
    l = p.sum(dim=-1, keepdim=True)
    out = (p.to(v.dtype).float() @ v.float()) / torch.where(l == 0, 1.0, l)
    return _fill_rows_without_keys(out.to(q.dtype), v, k_mask, causal, window)


def _check_window(window: Optional[int], causal: bool) -> None:
    if window is not None and (not causal or window < 1):
        raise ValueError(f"a window needs causal attention and at least one key; "
                         f"got window={window}, causal={causal}")


def _strides(x: torch.Tensor):
    """Element strides of the three leading dims; 0 for a dim of size 1."""
    return [st if n > 1 else 0 for n, st in zip(x.shape[:-1], x.stride()[:-1])]


def _kernel_layout(x: torch.Tensor) -> bool:
    """Whether the kernels take ``x`` as it lies: dense last dim, 16-byte rows."""
    return (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
            and all(st % 8 == 0 for st in _strides(x)))


def _scaled(q: torch.Tensor, scale: float):
    """(q, scale) with scale > 0 giving the same scores: the kernels fold the
    scale into exp2 and take the max of the unscaled scores."""
    if scale < 0:  # (-q . k) = -(q . k)
        return -q, -scale
    if scale == 0:  # every visible key weighs the same, as with zero scores
        return torch.zeros_like(q), 1.0
    return q, scale


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    k_mask: Optional[torch.Tensor] = None, *, causal: bool = False,
                    scale: Optional[float] = None,
                    window: Optional[int] = None) -> torch.Tensor:
    """Flash attention forward: (B, H, Sq, Dh) q, (B, H, Skv, Dh) k/v, any
    strides; returns (B, H, Sq, Dh) with q's strides. ``window`` (causal
    only) bounds each row's keys to the ``window`` positions ending at it."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, k_mask, causal=causal, scale=scale,
                                          window=window)
    _check_window(window, causal)
    b, h, sq, dh = q.shape
    skv = k.shape[2]
    if (q.device.type != "cuda" or q.dtype != torch.bfloat16 or dh not in (64, 128)
            or k.dtype != q.dtype or v.dtype != q.dtype or sq < 1 or skv < 1
            or k.shape != (b, h, skv, dh) or v.shape != k.shape):
        raise ValueError(
            "flash attention kernel takes bf16 CUDA (B, H, S, 64|128) q/k/v with "
            f"equal heads; got q {q.dtype} {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} on {q.device}")
    kb.refuse_grad("flash_attention", q, k, v, route=_NO_GRAD_ATTENTION)
    q, scale = _scaled(q, 1.0 / math.sqrt(dh) if scale is None else scale)
    out = torch.empty_like(q)  # a dense q's strides, which the kernel gives out too
    if not _kernel_layout(q) or _strides(out) != _strides(q):
        q = q.contiguous()
        out = torch.empty_like(q)
    if not (_kernel_layout(k) and _kernel_layout(v) and _strides(k) == _strides(v)):
        k, v = k.contiguous(), v.contiguous()
    mask = None
    if k_mask is not None:
        if k_mask.shape != (b, skv):
            raise ValueError(f"k_mask must be (B, Skv)={(b, skv)}, got {tuple(k_mask.shape)}")
        mask = k_mask.to(q.device)
        if mask.dtype not in (torch.bool, torch.uint8):
            mask = mask != 0
        mask = mask.contiguous()
    kb.check(kb.kernels().flash_attention_bf16(
        kb.ptr(q), kb.ptr(k), kb.ptr(v), kb.ptr(mask) if mask is not None else None,
        kb.ptr(out), b, h, sq, skv, dh, float(scale), int(causal),
        0 if window is None or window >= sq else int(window), *_strides(q),
        *_strides(k), kb.current_stream(q.device)), "flash_attention_bf16")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def block_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                              causal: bool = False,
                              scale: Optional[float] = None) -> torch.Tensor:
    """(B, H, Sq, Dh) q, (B, H, Skv, Dh) k/v whole-row attention in plain PyTorch."""
    sq, skv = q.shape[2], k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    if causal:
        pos_q = torch.arange(sq, device=q.device)[:, None]
        s = s.masked_fill(pos_q < torch.arange(skv, device=q.device)[None], NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(l == 0, 1.0, l)
    return (p.to(v.dtype).float() @ v.float()).to(q.dtype)


def block_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, scale: Optional[float] = None) -> torch.Tensor:
    """K11: whole-row attention for short sequences, (B, H, Sq, Dh) -> (B, H, Sq, Dh)."""
    if q.device.type == "cpu":
        return block_attention_reference(q, k, v, causal=causal, scale=scale)
    b, h, sq, dh = q.shape
    skv = k.shape[2]
    if (q.device.type != "cuda" or q.dtype != torch.bfloat16 or dh not in (64, 128)
            or k.dtype != q.dtype or v.dtype != q.dtype or sq < 1 or skv < 1
            or k.shape != (b, h, skv, dh) or v.shape != k.shape):
        raise ValueError(
            "block attention kernel takes bf16 CUDA (B, H, S, 64|128) q/k/v with "
            f"Sq, Skv >= 1; got q {q.dtype} {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} on {q.device}")
    kb.refuse_grad("block_attention", q, k, v, route=_NO_GRAD_ATTENTION)
    q, scale = _scaled(q, 1.0 / math.sqrt(dh) if scale is None else scale)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    kb.check(kb.kernels().block_attention_bf16(
        kb.ptr(q), kb.ptr(k), kb.ptr(v), kb.ptr(out), b, h, sq, skv, dh, float(scale),
        int(causal), kb.current_stream(q.device)), "block_attention_bf16")
    block_attention.launches += 1
    return out


block_attention.launches = 0
