"""Temporal attention branch of the video tower (kernel K2).

Port of ``videollamb_tpu/ops/temporal_attention.py:339-411`` and of its
plain statement ``temporal_attention_reference``. Each encoder layer adds
the temporal embedding into the residual stream, applies LayerNorm, and
runs CLIP attention across the t (= 8) frames of every patch position.

- :func:`temporal_attention_fm` is the live branch: frame-major
  (b, t, n, d) residual stream, one fused 3d-wide qkv projection with q's
  scale folded into its weight rows, then the core, then out_proj.
- :func:`fused_temporal_core_fm3` replaces the Pallas kernel of the same
  name. On a CUDA tensor it launches ``csrc/temporal_attention.cu``; on a
  CPU tensor it runs :func:`temporal_core_fm3_reference`.

On the H100 the core is bound by device memory (about 4 FLOPs per byte):
it reads the packed qkv operand once and writes the output once, with each
(b, n, head) solved by one warp; the TPU kernel's (t * block_n)-row
same-position pack is not carried over (see the .cu file).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from videollamb_torch.kernels import build as kb


def temporal_core_fm3_reference(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(b, t, n, 3d) packed [q*scale | k | v] -> (b, t, n, d); plain PyTorch."""
    b, t, n, d3 = qkv.shape
    d = d3 // 3
    e = d // num_heads

    def split(x):  # (b, t, n, d) -> (b, n, h, t, e)
        return x.reshape(b, t, n, num_heads, e).permute(0, 2, 3, 1, 4).float()

    q, k, v = (split(x) for x in qkv.split(d, dim=-1))
    p = torch.softmax(q @ k.transpose(-1, -2), dim=-1).to(qkv.dtype).float()
    o = (p @ v).to(qkv.dtype)  # (b, n, h, t, e)
    return o.permute(0, 3, 1, 2, 4).reshape(b, t, n, d)


def fused_temporal_core_fm3(qkv: torch.Tensor, *, num_heads: int) -> torch.Tensor:
    """Per-(b, n, head) softmax attention over t frames: (b, t, n, 3d) -> (b, t, n, d)."""
    if qkv.device.type == "cpu":
        return temporal_core_fm3_reference(qkv, num_heads)
    b, t, n, d3 = qkv.shape
    d = d3 // 3
    if (qkv.device.type != "cuda" or qkv.dtype != torch.bfloat16
            or d3 != 3 * d or d != num_heads * 64 or not 1 <= t <= 8):
        raise ValueError(
            "temporal attention kernel takes a bf16 CUDA (b, t<=8, n, 3*heads*64) "
            f"operand; got {qkv.dtype} {tuple(qkv.shape)} on {qkv.device}, "
            f"heads={num_heads}")
    qkv = qkv.contiguous()
    out = torch.empty((b, t, n, d), dtype=qkv.dtype, device=qkv.device)
    kb.check(kb.kernels().temporal_attention_bf16(
        kb.ptr(qkv), kb.ptr(out), b, t, n, d, num_heads,
        kb.current_stream(qkv.device)), "temporal_attention_bf16")
    fused_temporal_core_fm3.launches += 1
    return out


fused_temporal_core_fm3.launches = 0


def _layer_norm(ln: nn.LayerNorm, x: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm with f32 statistics, cast back to the input dtype."""
    y = F.layer_norm(x.float(), x.shape[-1:], ln.weight.float(), ln.bias.float(), eps)
    return y.to(x.dtype)


def _temb(temporal_embedding: torch.Tensor, t: int, d: int) -> torch.Tensor:
    return temporal_embedding.reshape(-1, d)[:t]


def _ln_fm(x: torch.Tensor, temporal_embedding: torch.Tensor, ln: nn.LayerNorm,
           eps: float):
    """Frame-major temb add + LayerNorm: returns (xt, normed)."""
    t, d = x.shape[1], x.shape[-1]
    xt = x + _temb(temporal_embedding, t, d).to(x.dtype)[None, :, None]
    return xt, _layer_norm(ln, xt, eps)


def _qkv_fused(attn: nn.Module, normed: torch.Tensor, q_scale: float) -> torch.Tensor:
    """ONE 3d-wide projection: normed @ [Wq*s | Wk | Wv]^T + [bq*s | bk | bv].

    With int8 projections (``models/vision/quant.Int8Dense``) the integer
    kernels are concatenated and so are their scales, in f32: ``scale * s``
    in bf16 would round the q third by about 0.4 %.
    """
    dt = normed.dtype
    if hasattr(attn.q_proj, "q"):
        from videollamb_torch.models.vision.quant import dense_int8

        qp, kp, vp = attn.q_proj, attn.k_proj, attn.v_proj
        fused = {"q": torch.cat([qp.q, kp.q, vp.q], dim=1),
                 "scale": torch.cat([qp.scale.float() * q_scale, kp.scale.float(),
                                     vp.scale.float()], dim=-1)}
        return dense_int8(fused, normed, torch.cat([qp.bias * q_scale, kp.bias, vp.bias]))
    w = torch.cat([attn.q_proj.weight.to(dt) * q_scale, attn.k_proj.weight.to(dt),
                   attn.v_proj.weight.to(dt)], dim=0)
    b = torch.cat([attn.q_proj.bias.float() * q_scale, attn.k_proj.bias.float(),
                   attn.v_proj.bias.float()]).to(dt)
    return F.linear(normed, w, b)


def temporal_attention_fm(x: torch.Tensor, temporal_embedding: torch.Tensor,
                          ln: nn.LayerNorm, attn: nn.Module, num_heads: int,
                          eps: float = 1e-5) -> torch.Tensor:
    """x + temb + CLIPAttention(LN(x + temb)) across frames, frame-major.

    x: (b, t, n, d), the residual stream viewed frame-major.
    """
    e = x.shape[-1] // num_heads
    xt, normed = _ln_fm(x, temporal_embedding, ln, eps)
    qkv = _qkv_fused(attn, normed, e ** -0.5)
    o = fused_temporal_core_fm3(qkv, num_heads=num_heads)
    return xt + attn.out_proj(o)


def temporal_attention_reference(x: torch.Tensor, temporal_embedding: torch.Tensor,
                                 ln: nn.LayerNorm, attn: nn.Module, *,
                                 num_heads: int, eps: float = 1e-5) -> torch.Tensor:
    """Plain statement of the same branch on the token-major (b, n, t, d) layout."""
    b, n, t, d = x.shape
    h = num_heads
    e = d // h
    xt = x + _temb(temporal_embedding, t, d).to(x.dtype)[None, None]
    normed = _layer_norm(ln, xt, eps)
    q = attn.q_proj(normed).reshape(b, n, t, h, e) * (e ** -0.5)
    k = attn.k_proj(normed).reshape(b, n, t, h, e)
    v = attn.v_proj(normed).reshape(b, n, t, h, e)
    s = torch.einsum("bnqhe,bnkhe->bnhqk", q.float(), k.float())
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bnhqk,bnkhe->bnqhe", p.float(), v.float())
    o = o.to(x.dtype).reshape(b, n, t, d)
    return xt + attn.out_proj(o)
