"""In-place install of the fresh K/V rows into the token-major int8 pools
(kernel K5).

Port of ``videollamb_tpu/ops/paged_fresh_write.py``. After a decode step,
slot b's new token of every layer l lands at
``pool[l, write_page[b], write_off[b]]`` in the K and the V pool. The port
updates the pools in place and returns them.

- :func:`paged_fresh_write` launches ``csrc/paged_fresh_write.cu`` on a CUDA
  tensor and runs :func:`paged_fresh_write_xla` on a CPU tensor.
- :func:`paged_fresh_write_xla` is the plain statement (the JAX package's
  dynamic-update-slice chain, as one indexed assignment).

Slots that share the trash page (page 0) write there in no fixed order; the
page holds garbage either way, so comparisons exclude it. The per-token
scale rows are a plain indexed assignment in the decode step, as they stay
XLA in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import torch

from videollamb_torch.kernels import build as kb


def paged_fresh_write_xla(k_pool: torch.Tensor, v_pool: torch.Tensor, fresh_k: torch.Tensor,
                          fresh_v: torch.Tensor, write_page: torch.Tensor,
                          write_off: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pools (L, P, page, KD); fresh rows (L, B, KD); page and offset (B,)."""
    page, off = write_page.long(), write_off.long()
    k_pool[:, page, off] = fresh_k.to(k_pool.dtype)
    v_pool[:, page, off] = fresh_v.to(v_pool.dtype)
    return k_pool, v_pool


@kb.counted
def paged_fresh_write(k_pool: torch.Tensor, v_pool: torch.Tensor, fresh_k: torch.Tensor,
                      fresh_v: torch.Tensor, write_page: torch.Tensor,
                      write_off: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Install every slot's fresh rows of every layer in place."""
    if k_pool.device.type == "cpu":
        return paged_fresh_write_xla(k_pool, v_pool, fresh_k, fresh_v, write_page, write_off)
    layers, p_total, page, kd = k_pool.shape
    b = fresh_k.shape[1]
    if (k_pool.device.type != "cuda" or k_pool.dtype != torch.int8
            or v_pool.dtype != torch.int8 or v_pool.shape != k_pool.shape
            or not (k_pool.is_contiguous() and v_pool.is_contiguous())
            or fresh_k.dtype != torch.int8 or fresh_v.dtype != torch.int8
            or fresh_k.shape != (layers, b, kd) or fresh_v.shape != fresh_k.shape or kd % 16):
        raise ValueError(
            "fresh-row install takes contiguous CUDA int8 (L, P, page, KD) pools with KD a "
            f"multiple of 16 and (L, B, KD) rows; got pools {k_pool.dtype} "
            f"{tuple(k_pool.shape)}, rows {fresh_k.dtype} {tuple(fresh_k.shape)} on "
            f"{k_pool.device}")
    kb.refuse_grad("paged_fresh_write", k_pool, v_pool, fresh_k, fresh_v)
    fk, fv = fresh_k.contiguous(), fresh_v.contiguous()
    page_ids = write_page.to(torch.int32).contiguous()
    offs = write_off.to(torch.int32).contiguous()
    kb.check(kb.kernels().paged_fresh_write_int8(
        kb.ptr(k_pool), kb.ptr(v_pool), kb.ptr(fk), kb.ptr(fv), kb.ptr(page_ids),
        kb.ptr(offs), layers, b, p_total, page, kd, kb.current_stream(k_pool.device)),
        "paged_fresh_write_int8")
    paged_fresh_write.launches += 1
    return k_pool, v_pool
