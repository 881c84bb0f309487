"""Temporal attention branch of the video tower (kernels K2, K9 and K10).

Port of ``videollamb_tpu/ops/temporal_attention.py``. Each encoder layer
adds the temporal embedding into the residual stream, applies LayerNorm,
and runs CLIP attention across the t (= 8) frames of every patch position.

- :func:`temporal_attention_fm` is the live branch: frame-major
  (b, t, n, d) residual stream, one fused 3d-wide qkv projection with q's
  scale folded into its weight rows, then the core (K2), then out_proj.
- :func:`temporal_attention` is the older (b, n, t, d) branch: three
  projections, q scaled after its projection, then the core (K9).
- The core kernels, each replacing the Pallas kernel of the same name: on
  a CUDA tensor they launch ``csrc/temporal_attention.cu``, on a CPU
  tensor they run their plain version. :func:`fused_temporal_core_fm3`
  (K2) reads one packed (b, t, n, 3d) [q*scale | k | v] operand,
  :func:`fused_temporal_core` (K9) three (b, n, t, d) operands and
  :func:`fused_temporal_core_fm` (K10) three frame-major (b, t, n, d) ones.
- Both branches are differentiable, as the JAX ``custom_vjp`` rules
  ``_ta_bwd`` and ``_ta_fm_bwd`` make them. The rules recompute the whole
  branch through ``temporal_attention_reference``; here only the core
  (q, k, v -> o) is a kernel-forward, plain-recompute-backward op
  (``ops/recompute.py``), and LayerNorm, the projections and out_proj
  differentiate natively. The gradients are the same up to rounding. K10
  has no VJP in the JAX package and refuses inputs that want a gradient.

On the H100 the core is bound by device memory (about 4 FLOPs per byte):
it reads its operands once and writes the output once. A warp packs two
(b, n, head) problems into one 16-row mma.sync tile, staged through a
cp.async ring; the TPU kernels' same-position and same-head row packs are
not carried over (see the .cu file).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from videollamb_torch.kernels import build as kb
from videollamb_torch.ops.recompute import kernel_forward
from videollamb_torch.parallel.tensor_parallel import local, tp_linear

E = 64  # the kernel's head dim
T_MAX = 8  # frames per window the kernel takes


def temporal_core_fm_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               num_heads: int) -> torch.Tensor:
    """Three frame-major (b, t, n, d) operands, q pre-scaled -> (b, t, n, d); plain PyTorch."""
    b, t, n, d = q.shape
    e = d // num_heads

    def split(x):  # (b, t, n, d) -> (b, n, h, t, e)
        return x.reshape(b, t, n, num_heads, e).permute(0, 2, 3, 1, 4).float()

    p = torch.softmax(split(q) @ split(k).transpose(-1, -2), dim=-1).to(v.dtype).float()
    o = (p @ split(v)).to(q.dtype)  # (b, n, h, t, e)
    return o.permute(0, 3, 1, 2, 4).reshape(b, t, n, d)


def temporal_core_fm3_reference(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(b, t, n, 3d) packed [q*scale | k | v] -> (b, t, n, d); plain PyTorch."""
    return temporal_core_fm_reference(*qkv.split(qkv.shape[-1] // 3, dim=-1), num_heads)


def temporal_core_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            num_heads: int) -> torch.Tensor:
    """Three (b, n, t, d) operands, q pre-scaled -> (b, n, t, d); plain PyTorch."""
    out = temporal_core_fm_reference(*(x.transpose(1, 2) for x in (q, k, v)), num_heads)
    return out.transpose(1, 2)


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """Contiguous, at a 16-byte boundary: the kernel copies 16-byte chunks."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _check_core(name: str, tensors, t: int, d: int, num_heads: int) -> None:
    q = tensors[0]
    if (q.device.type != "cuda" or q.ndim != 4 or d != num_heads * E or not 1 <= t <= T_MAX
            or any(x.dtype != torch.bfloat16 or x.device != q.device for x in tensors)):
        raise ValueError(
            f"{name} takes bf16 CUDA operands with t <= 8 frames and heads of 64; got "
            f"{[(x.dtype, tuple(x.shape)) for x in tensors]} on {q.device}, heads={num_heads}")


@kb.counted
def fused_temporal_core_fm3(qkv: torch.Tensor, *, num_heads: int) -> torch.Tensor:
    """K2: per-(b, n, head) softmax attention over t frames, (b, t, n, 3d) -> (b, t, n, d)."""
    if qkv.device.type == "cpu":
        return temporal_core_fm3_reference(qkv, num_heads)
    b, t, n, d3 = qkv.shape
    d = d3 // 3
    _check_core("temporal attention kernel", [qkv], t, d, num_heads)
    if d3 != 3 * d:
        raise ValueError(f"temporal attention kernel: last dim {d3} is not 3 * d")
    kb.refuse_grad("fused_temporal_core_fm3", qkv, route="use temporal_attention_fm")
    qkv = _aligned(qkv)
    out = torch.empty((b, t, n, d), dtype=qkv.dtype, device=qkv.device)
    kb.check(kb.kernels().temporal_attention_bf16(
        kb.ptr(qkv), kb.ptr(out), b, t, n, d, num_heads,
        kb.current_stream(qkv.device)), "temporal_attention_bf16")
    fused_temporal_core_fm3.launches += 1
    return out


def _launch_three(entry: str, q, k, v, dims, d: int, num_heads: int) -> torch.Tensor:
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(q)
    kb.check(getattr(kb.kernels(), entry)(
        kb.ptr(q), kb.ptr(k), kb.ptr(v), kb.ptr(out), *dims, d, num_heads,
        kb.current_stream(q.device)), entry)
    return out


@kb.counted
def fused_temporal_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        num_heads: int) -> torch.Tensor:
    """K9: the same attention on three (b, n, t, d) operands -> (b, n, t, d)."""
    if q.device.type == "cpu":
        return temporal_core_reference(q, k, v, num_heads)
    b, n, t, d = q.shape
    _check_core("(b, n, t, d) temporal attention kernel", [q, k, v], t, d, num_heads)
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("(b, n, t, d) temporal attention kernel: q, k, v differ in shape")
    kb.refuse_grad("fused_temporal_core", q, k, v, route="use temporal_attention")
    out = _launch_three("temporal_core_bntd_bf16", q, k, v, (b, n, t), d, num_heads)
    fused_temporal_core.launches += 1
    return out


@kb.counted
def fused_temporal_core_fm(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                           num_heads: int) -> torch.Tensor:
    """K10: the same attention on three frame-major (b, t, n, d) operands -> (b, t, n, d).

    Forward only, as in the JAX package (no caller there differentiates it)."""
    if q.device.type == "cpu":
        return temporal_core_fm_reference(q, k, v, num_heads)
    b, t, n, d = q.shape
    _check_core("frame-major temporal attention kernel", [q, k, v], t, d, num_heads)
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("frame-major temporal attention kernel: q, k, v differ in shape")
    kb.refuse_grad("fused_temporal_core_fm", q, k, v,
                   route="temporal_attention_fm is the differentiable frame-major branch")
    out = _launch_three("temporal_core_fm_bf16", q, k, v, (b, t, n), d, num_heads)
    fused_temporal_core_fm.launches += 1
    return out


def temporal_core_fm3(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Differentiable K2 core: kernel forward, plain-recompute backward."""
    return kernel_forward(lambda x: fused_temporal_core_fm3(x, num_heads=num_heads),
                          lambda x: temporal_core_fm3_reference(x, num_heads), qkv)


def temporal_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  num_heads: int) -> torch.Tensor:
    """Differentiable K9 core: kernel forward, plain-recompute backward."""
    return kernel_forward(lambda *a: fused_temporal_core(*a, num_heads=num_heads),
                          lambda *a: temporal_core_reference(*a, num_heads), q, k, v)


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


def _ln_qkv(x: torch.Tensor, temporal_embedding: torch.Tensor, ln: nn.LayerNorm,
            attn: nn.Module, eps: float):
    """(b, n, t, d) temb add, LayerNorm and the three projections: (xt, q, k, v).

    q is not scaled here: both callers scale it after its projection."""
    t, d = x.shape[2], x.shape[-1]
    xt = x + _temb(temporal_embedding, t, d).to(x.dtype)[None, None]
    normed = _layer_norm(ln, xt, eps)
    return xt, attn.q_proj(normed), attn.k_proj(normed), attn.v_proj(normed)


def _ln_qkv_fm(x: torch.Tensor, temporal_embedding: torch.Tensor, ln: nn.LayerNorm,
               attn: nn.Module, eps: float):
    """:func:`_ln_fm` and the three separate projections (the operands of K10)."""
    xt, normed = _ln_fm(x, temporal_embedding, ln, eps)
    return xt, attn.q_proj(normed), attn.k_proj(normed), attn.v_proj(normed)


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
    # Tensor-parallel projections fuse this rank's heads of q, of k and of v.
    qp, kp, vp = attn.q_proj, attn.k_proj, attn.v_proj
    w = torch.cat([local(qp.weight).to(dt) * q_scale, local(kp.weight).to(dt),
                   local(vp.weight).to(dt)], dim=0)
    b = torch.cat([local(qp.bias).float() * q_scale, local(kp.bias).float(),
                   local(vp.bias).float()]).to(dt)
    return F.linear(normed, w, b)


def _out_proj(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """The output projection; a tensor-parallel one sums over the ranks."""
    if isinstance(module, nn.Linear):
        return tp_linear(x, module.weight, module.bias)
    return module(x)


def temporal_attention_fm(x: torch.Tensor, temporal_embedding: torch.Tensor,
                          ln: nn.LayerNorm, attn: nn.Module, num_heads: int,
                          eps: float = 1e-5) -> torch.Tensor:
    """x + temb + CLIPAttention(LN(x + temb)) across frames, frame-major (K2).

    x: (b, t, n, d), the residual stream viewed frame-major.
    """
    e = x.shape[-1] // num_heads
    xt, normed = _ln_fm(x, temporal_embedding, ln, eps)
    qkv = _qkv_fused(attn, normed, e ** -0.5)
    o = temporal_core_fm3(qkv, qkv.shape[-1] // 3 // e)  # this rank's heads
    return xt + _out_proj(attn.out_proj, o)


def temporal_attention(x: torch.Tensor, temporal_embedding: torch.Tensor, ln: nn.LayerNorm,
                       attn: nn.Module, num_heads: int, eps: float = 1e-5) -> torch.Tensor:
    """The same branch on the token-major (b, n, t, d) layout, through K9."""
    e = x.shape[-1] // num_heads
    xt, q, k, v = _ln_qkv(x, temporal_embedding, ln, attn, eps)
    return xt + attn.out_proj(temporal_core(q * (e ** -0.5), k, v, num_heads))


def temporal_attention_reference(x: torch.Tensor, temporal_embedding: torch.Tensor,
                                 ln: nn.LayerNorm, attn: nn.Module, *,
                                 num_heads: int, eps: float = 1e-5) -> torch.Tensor:
    """Plain statement of the same branch on the token-major (b, n, t, d) layout."""
    e = x.shape[-1] // num_heads
    xt, q, k, v = _ln_qkv(x, temporal_embedding, ln, attn, eps)
    return xt + attn.out_proj(temporal_core_reference(q * (e ** -0.5), k, v, num_heads))
