"""EgoVLP video tower: the Frozen-in-Time divided space-time ViT.

Port of ``videollamb_tpu/models/vision/egovlp.py`` (reference
llava/model/multimodal_encoder/egovlp/model/video_transformer.py,
SpaceTimeTransformer, arXiv:2104.00650). Per block (:214-229):

    time_out  = timeattn(norm3(x))        # across frames, per position
    time_res  = x + time_out
    space_out = attn(norm1(time_res))     # within each frame
    space_res = x + space_out             # residual from x (:225)
    x = space_res + mlp(norm2(space_res))

Divided attention (VarAttention, :117-153): the CLS query attends over the
whole (1 + f*n) sequence; patch queries attend within their group (one
spatial position across frames for time, one frame for space) with the CLS
key / value prepended to every group. Positions (:353-372): a per-frame
table tiled over frames plus a temporal embedding repeated over patches.

The module keeps the reference's (and the JAX tree's) names, so
``models/convert.py`` and :func:`convert_egovlp_state_dict` map it. The
attention is plain PyTorch, as it is plain XLA in the JAX package. The
fusion blocks of the EgoVLP retrieval model (``egovlp_text.py``) carry the
image-to-text cross-attention in their space attention
(``EgoVLPTower(i2t_blocks=, text_hidden=)``, video_transformer.py:108-115);
:func:`_block` runs it when it is given a text stream ``y``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from videollamb_torch.models.seeded import empty_module, generator
from videollamb_torch.models.vision.deformable import _ln


@dataclass(frozen=True)
class EgoVLPConfig:
    """ViT-B/16 defaults (video_transformer.py:247-249)."""

    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    mlp_ratio: float = 4.0
    image_size: int = 224
    patch_size: int = 16
    num_frames: int = 4
    layer_norm_eps: float = 1e-6

    @property
    def patches_per_frame(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


class VarAttention(nn.Module):
    def __init__(self, d: int, text_hidden: Optional[int] = None, eps: float = 1e-6):
        super().__init__()
        self.qkv = nn.Linear(d, 3 * d)
        self.proj = nn.Linear(d, d)
        if text_hidden is not None:  # a fusion block's image-to-text cross-attention
            self.qkv_text_i2t = nn.Linear(text_hidden, 2 * d)
            self.qkv_i2t = nn.Linear(d, d)
            self.proj_i2t = nn.Linear(d, d)
            self.norm_i2t_i = nn.LayerNorm(d, eps=eps)
            self.alpha_i2t = nn.Parameter(torch.empty(()))


class Mlp(nn.Module):
    def __init__(self, d: int, inter: int):
        super().__init__()
        self.fc1 = nn.Linear(d, inter)
        self.fc2 = nn.Linear(inter, d)


class SpaceTimeBlock(nn.Module):
    def __init__(self, cfg: EgoVLPConfig, text_hidden: Optional[int] = None):
        super().__init__()
        d = cfg.hidden_size
        self.norm1 = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.norm2 = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.norm3 = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.attn = VarAttention(d, text_hidden, cfg.layer_norm_eps)
        self.timeattn = VarAttention(d)
        self.mlp = Mlp(d, int(d * cfg.mlp_ratio))


class EgoVLPTower(nn.Module):
    """The tower; its last ``i2t_blocks`` blocks are fusion blocks whose space
    attention cross-attends a text stream of width ``text_hidden``."""

    def __init__(self, cfg: EgoVLPConfig, i2t_blocks: int = 0,
                 text_hidden: Optional[int] = None):
        super().__init__()
        d = cfg.hidden_size
        first_fused = cfg.num_hidden_layers - i2t_blocks
        self.patch_embed = nn.Linear(3 * cfg.patch_size ** 2, d)
        self.cls_token = nn.Parameter(torch.empty(d))
        self.pos_embed = nn.Parameter(torch.empty(cfg.patches_per_frame + 1, d))
        self.temporal_embed = nn.Parameter(torch.empty(cfg.num_frames, d))
        self.blocks = nn.ModuleList(
            SpaceTimeBlock(cfg, text_hidden if i >= first_fused else None)
            for i in range(cfg.num_hidden_layers))
        self.norm = nn.LayerNorm(d, eps=cfg.layer_norm_eps)


def _attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain softmax attention with f32 scores (reference attn(), :35-39)."""
    s = torch.matmul(q, k.transpose(-1, -2)).float()
    return torch.matmul(torch.softmax(s, -1).to(v.dtype), v)


def _i2t_cross(p: VarAttention, x: torch.Tensor, y: torch.Tensor, cfg: EgoVLPConfig,
               y_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Image-to-text cross-attention on the space attention's output
    (VarAttention.forward, video_transformer.py:156-187): q from
    norm_i2t_i(x), k / v from the text stream y (b, n_text, d_text), the
    result gated by the learned scalar alpha_i2t (zero at initialisation).
    ``y_bias`` (b, n_text) is additive: 0 valid, a large negative pad."""
    b, tot, d = x.shape
    h, e = cfg.num_attention_heads, cfg.head_dim
    kv = p.qkv_text_i2t(y).reshape(y.shape[0], y.shape[1], 2, h, e)
    k, v = kv[:, :, 0], kv[:, :, 1]  # (b, n_text, h, e)
    q = p.qkv_i2t(_ln(p.norm_i2t_i, x, cfg.layer_norm_eps)).reshape(b, tot, h, e) * e ** -0.5
    s = torch.einsum("bihe,bjhe->bhij", q.float(), k.float())
    if y_bias is not None:
        s = s + y_bias[:, None, None, :].float()
    pr = torch.softmax(s, -1).to(v.dtype)
    o = torch.einsum("bhij,bjhe->bihe", pr.float(), v.float()).to(x.dtype)
    o = p.proj_i2t(o.reshape(b, tot, d))
    return x + p.alpha_i2t.float().to(x.dtype) * o


def _var_attention(p: VarAttention, x: torch.Tensor, cfg: EgoVLPConfig, mode: str,
                   f: int, y: Optional[torch.Tensor] = None,
                   y_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Divided attention over time ('time': one group per spatial position)
    or space ('space': one group per frame) groups; x (b, 1 + f*n, d). A text
    stream ``y`` adds the fusion block's :func:`_i2t_cross` after the
    projection."""
    b, tot, d = x.shape
    h, e = cfg.num_attention_heads, cfg.head_dim
    n = (tot - 1) // f
    qkv = p.qkv(x).reshape(b, tot, 3, h, e)
    q, k, v = (qkv[:, :, i].transpose(1, 2).reshape(b * h, tot, e) for i in range(3))
    q = q * e ** -0.5
    cls_out = _attn(q[:, :1], k, v)  # the CLS query attends over everything
    if mode == "time":  # 'b (f n) d -> (b n) f d'
        def group(t):
            return t.reshape(b * h, f, n, e).transpose(1, 2).reshape(b * h * n, f, e)

        def ungroup(t):
            return t.reshape(b * h, n, f, e).transpose(1, 2).reshape(b * h, f * n, e)

        r = n
    else:  # 'b (f n) d -> (b f) n d'
        def group(t):
            return t.reshape(b * h * f, n, e)

        def ungroup(t):
            return t.reshape(b * h, f * n, e)

        r = f
    kg = torch.cat([k[:, :1].repeat_interleave(r, 0), group(k[:, 1:])], 1)
    vg = torch.cat([v[:, :1].repeat_interleave(r, 0), group(v[:, 1:])], 1)
    out = torch.cat([cls_out, ungroup(_attn(group(q[:, 1:]), kg, vg))], 1)
    out = p.proj(out.reshape(b, h, tot, e).transpose(1, 2).reshape(b, tot, d))
    return out if y is None else _i2t_cross(p, out, y, cfg, y_bias)


def _block(p: SpaceTimeBlock, x: torch.Tensor, cfg: EgoVLPConfig, f: int,
           y: Optional[torch.Tensor] = None,
           y_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    eps = cfg.layer_norm_eps
    time_res = x + _var_attention(p.timeattn, _ln(p.norm3, x, eps), cfg, "time", f)
    # The text stream rides only the space attention (SpaceTimeBlock.forward :214-220).
    space_res = x + _var_attention(p.attn, _ln(p.norm1, time_res, eps), cfg, "space", f,
                                   y=y, y_bias=y_bias)
    h = p.mlp.fc2(F.gelu(p.mlp.fc1(_ln(p.norm2, space_res, eps))))
    return space_res + h


def egovlp_embed_patches(tower: EgoVLPTower, pixels: torch.Tensor,
                         cfg: EgoVLPConfig) -> torch.Tensor:
    """(B, F, C, H, W) -> (B, 1 + F*N, D) CLS + patch tokens with the tiled
    positions (forward_features :353-372)."""
    b, f, c, hh, ww = pixels.shape
    ps = cfg.patch_size
    gh, gw = hh // ps, ww // ps
    n = gh * gw
    d = cfg.hidden_size
    # Per-frame patchify (VideoPatchEmbed: a 2-D conv applied frame-wise).
    x = pixels.reshape(b * f, c, gh, ps, gw, ps).permute(0, 2, 4, 1, 3, 5)
    x = tower.patch_embed(x.reshape(b * f, n, c * ps * ps)).reshape(b, f * n, d)
    x = torch.cat([tower.cls_token.to(x.dtype).expand(b, 1, d), x], 1)
    pos = tower.pos_embed.to(x.dtype)
    temb = tower.temporal_embed.to(x.dtype)
    tiled = pos[1:].repeat(cfg.num_frames, 1) + temb.repeat_interleave(n, 0)
    total = torch.cat([pos[:1], tiled], 0)
    return x + total[: x.shape[1]][None]


def egovlp_encode(tower: EgoVLPTower, pixels: torch.Tensor, cfg: EgoVLPConfig) -> torch.Tensor:
    """(B, F, C, H, W) -> (B, 1 + F*N, D) final-LN hidden states; row 0 is
    the video embedding the reference pools (:392)."""
    f = pixels.shape[1]
    x = egovlp_embed_patches(tower, pixels.to(tower.cls_token.dtype), cfg)
    for block in tower.blocks:
        x = _block(block, x, cfg, f)
    return _ln(tower.norm, x, cfg.layer_norm_eps)


def init_egovlp_params(cfg: EgoVLPConfig, *, seed: int = 0, dtype=torch.float32,
                       device="cpu", i2t_blocks: int = 0,
                       text_hidden: Optional[int] = None) -> EgoVLPTower:
    """Seeded tower as the JAX initialiser draws it: 0.02-std kernels, zero
    biases, CLS and temporal table; time attention 'zeros' init (qkv zero,
    proj weight ones, :97-101), so the model starts as a ViT. Fusion blocks
    (``i2t_blocks``) start with their gate alpha_i2t at zero."""
    tower = empty_module(lambda: EgoVLPTower(cfg, i2t_blocks, text_hidden), device, dtype)
    g = generator(device, seed)
    with torch.no_grad():
        for name, p in tower.named_parameters():
            if "norm" in name:
                p.fill_(1.0 if name.endswith("weight") else 0.0)
            elif name.endswith(("bias", "timeattn.qkv.weight", "alpha_i2t")) \
                    or name in ("cls_token", "temporal_embed"):
                p.zero_()
            elif name.endswith("timeattn.proj.weight"):
                p.fill_(1.0)
            else:
                p.normal_(0.0, 0.02, generator=g)
    return tower


def convert_egovlp_state_dict(sd: Mapping[str, Any], cfg: EgoVLPConfig) -> dict:
    """Reference SpaceTimeTransformer state dict (video_transformer.py:231-352
    names) -> the state of :class:`EgoVLPTower`: the names carry over; the
    Conv2d patch embed flattens to a (D, C*ps*ps) Linear weight, channel
    major, matching the pixel unfold in :func:`egovlp_embed_patches`."""
    def t(name):
        v = sd[name]
        return v.detach().float().cpu() if torch.is_tensor(v) else torch.as_tensor(
            np.asarray(v, np.float32))

    d = cfg.hidden_size
    out = {"patch_embed.weight": t("patch_embed.proj.weight").reshape(d, -1),
           "patch_embed.bias": t("patch_embed.proj.bias"),
           "cls_token": t("cls_token").reshape(d),
           "pos_embed": t("pos_embed")[0],
           "temporal_embed": t("temporal_embed")[0],
           "norm.weight": t("norm.weight"), "norm.bias": t("norm.bias")}
    for i in range(cfg.num_hidden_layers):
        p = f"blocks.{i}."
        for name in ("norm1", "norm2", "norm3", "attn.qkv", "attn.proj", "timeattn.qkv",
                     "timeattn.proj", "mlp.fc1", "mlp.fc2"):
            for leaf in ("weight", "bias"):
                out[f"{p}{name}.{leaf}"] = t(f"{p}{name}.{leaf}")
    return out
