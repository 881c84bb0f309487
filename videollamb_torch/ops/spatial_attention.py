"""Spatial attention core of the vision tower (kernels K1 and K8).

Port of ``videollamb_tpu/ops/spatial_attention.py``: softmax attention over
the N (= 257) patch tokens of each frame, q pre-scaled, in two layouts.

- :func:`fused_spatial_core_packed` (K1) takes the (B, N, D) projection
  outputs with the heads packed in D; :func:`fused_spatial_core` (K8) the
  split (B, H, N, e) layout. Each replaces the Pallas kernel of the same
  name: on a CUDA tensor it launches ``csrc/spatial_attention.cu``, on a
  CPU tensor it runs its plain version.
- :func:`spatial_core_reference` (the JAX package's ``_xla_core``) and
  :func:`spatial_core_packed_reference` (``_xla_core_packed``) are the
  plain PyTorch statements: f32 scores, softmax, the probabilities rounded
  to the value dtype, an f32 product with V.
- :func:`spatial_core` and :func:`spatial_core_packed` are the
  differentiable ops, as the JAX ``custom_vjp`` rules ``_sc_bwd`` and
  ``_scp_bwd`` make them: kernel forward, backward through the plain
  version recomputed from q, k and v (``ops/recompute.py``). The tower
  calls these; the kernel wrappers themselves refuse inputs that want a
  gradient.

On the H100 the op is bound by device memory at the tower's shapes (see
the note at the top of the .cu file): the TPU kernel kept a (257, 257) f32
score tile per head, which is larger than a block's shared memory, so the
CUDA kernel stages one head's K and V per block and each warp keeps the
scores of 16 query rows in registers (``csrc/whole_row_attention.cuh``,
shared with K11). N has no limit: past 272 tokens the kernel streams K and
V in tiles.
"""

from __future__ import annotations

import torch

from videollamb_torch.kernels import build as kb
from videollamb_torch.ops.recompute import kernel_forward

E = 64  # the kernel's head dim


def spatial_core_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, H, N, e) pre-scaled q, k, v -> (B, H, N, e); plain PyTorch."""
    s = q.float() @ k.float().transpose(-1, -2)
    p = torch.softmax(s, dim=-1).to(v.dtype).float()
    return (p @ v.float()).to(q.dtype)


def _split(t: torch.Tensor, heads: int) -> torch.Tensor:  # (B, N, D) -> (B, H, N, e)
    b, n, d = t.shape
    return t.reshape(b, n, heads, d // heads).transpose(1, 2)


def _merge(t: torch.Tensor) -> torch.Tensor:  # (B, H, N, e) -> (B, N, D)
    b, h, n, e = t.shape
    return t.transpose(1, 2).reshape(b, n, h * e)


def spatial_core_packed_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, N, D) pre-scaled q, k, v -> (B, N, D); plain PyTorch."""
    return _merge(spatial_core_reference(*(_split(t, heads) for t in (q, k, v))))


@kb.counted
def fused_spatial_core_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              *, heads: int) -> torch.Tensor:
    """Spatial attention core over packed heads (K1): (B, N, D) -> (B, N, D)."""
    if q.device.type == "cpu":
        return spatial_core_packed_reference(q, k, v, heads)
    b, n, d = q.shape
    if (q.device.type != "cuda" or q.dtype != torch.bfloat16
            or k.shape != q.shape or v.shape != q.shape
            or k.dtype != q.dtype or v.dtype != q.dtype or d != heads * E):
        raise ValueError(
            "spatial attention kernel takes bf16 CUDA (B, N, heads*64) q/k/v of "
            f"one shape; got {q.dtype} {tuple(q.shape)} on {q.device}, "
            f"heads={heads}")
    kb.refuse_grad("fused_spatial_core_packed", q, k, v, route="use spatial_core_packed")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    kb.check(kb.kernels().spatial_attention_bf16(
        kb.ptr(q), kb.ptr(k), kb.ptr(v), kb.ptr(out), b, n, d, heads,
        kb.current_stream(q.device)), "spatial_attention_bf16")
    fused_spatial_core_packed.launches += 1
    return out


@kb.counted
def fused_spatial_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Spatial attention core on the split layout (K8): (B, H, N, 64) -> (B, H, N, 64)."""
    if q.device.type == "cpu":
        return spatial_core_reference(q, k, v)
    if (q.device.type != "cuda" or q.dtype != torch.bfloat16 or q.ndim != 4
            or q.shape[-1] != E or k.shape != q.shape or v.shape != q.shape
            or k.dtype != q.dtype or v.dtype != q.dtype):
        raise ValueError(
            "split-layout spatial attention kernel takes bf16 CUDA (B, H, N, 64) q/k/v "
            f"of one shape; got {q.dtype} {tuple(q.shape)} on {q.device}")
    kb.refuse_grad("fused_spatial_core", q, k, v, route="use spatial_core")
    b, h, n, _ = q.shape
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    kb.check(kb.kernels().spatial_core_bf16(
        kb.ptr(q), kb.ptr(k), kb.ptr(v), kb.ptr(out), b, h, n,
        kb.current_stream(q.device)), "spatial_core_bf16")
    fused_spatial_core.launches += 1
    return out


def spatial_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Differentiable split-layout core: K8 forward, plain-recompute backward."""
    return kernel_forward(fused_spatial_core, spatial_core_reference, q, k, v)


def spatial_core_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        heads: int) -> torch.Tensor:
    """Differentiable packed core: K1 forward, plain-recompute backward."""
    return kernel_forward(lambda *a: fused_spatial_core_packed(*a, heads=heads),
                          lambda *a: spatial_core_packed_reference(*a, heads),
                          q, k, v)
