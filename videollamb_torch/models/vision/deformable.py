"""Deformable-DETR image tower (encoder only).

Port of ``videollamb_tpu/models/vision/deformable.py`` (reference
llava/model/multimodal_encoder/deformer/deformer_modeling.py, HF
DeformableDetrModel cut to backbone + multi-scale deformable encoder, and
deformer/__init__.py):

- a ResNet-50 backbone (HF ResNetBackbone layout: 7x7/2 embedder + max pool
  + bottleneck stages [3, 4, 6, 3]; features of the last three stages) with
  inference BatchNorm;
- DETR sine positions (normalised, temperature 10000);
- per-level 1x1 conv + GroupNorm(32) input projections, and a 3x3/2 one for
  the extra lowest-resolution level;
- multi-scale deformable attention: per query, learned sampling offsets
  around its reference point and softmaxed weights over levels x points;
  values sampled bilinearly (:func:`_grid_sample`);
- post-LN encoder layers with a ReLU FFN.

The module keeps the JAX tree's leaf names (convolutions hold OIHW
``weight``, BatchNorms their statistics as buffers), so
``models/convert.py`` maps it both ways. Everything is plain PyTorch, as it
is plain XLA in the JAX package.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from videollamb_torch.models.seeded import empty_module, generator


@dataclass(frozen=True)
class DeformableConfig:
    d_model: int = 256
    encoder_layers: int = 6
    encoder_attention_heads: int = 8
    encoder_ffn_dim: int = 1024
    num_feature_levels: int = 4
    encoder_n_points: int = 4
    layer_norm_eps: float = 1e-5
    # ResNet-50 backbone geometry (HF microsoft/resnet-50).
    backbone_embed_channels: int = 64
    backbone_depths: Tuple[int, ...] = (3, 4, 6, 3)
    backbone_channels: Tuple[int, ...] = (256, 512, 1024, 2048)
    # Feature levels come from the last len(backbone_out) stages.
    backbone_out: Tuple[int, ...] = (1, 2, 3)

    @property
    def head_dim(self) -> int:
        return self.d_model // self.encoder_attention_heads


# ---------------------------------------------------------------------------
# Modules (the JAX tree's names)
# ---------------------------------------------------------------------------


class BatchNorm(nn.Module):
    """Inference BatchNorm: scale / shift learned, statistics as buffers."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))
        self.register_buffer("running_mean", torch.empty(c))
        self.register_buffer("running_var", torch.empty(c))


def _conv_module(cin: int, cout: int, k: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, bias=False)


class ConvBN(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = _conv_module(cin, cout, 1)
        self.bn = BatchNorm(cout)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, cout: int, shortcut: bool):
        super().__init__()
        mid = cout // 4
        self.conv0, self.bn0 = _conv_module(cin, mid, 1), BatchNorm(mid)
        self.conv1, self.bn1 = _conv_module(mid, mid, 3), BatchNorm(mid)
        self.conv2, self.bn2 = _conv_module(mid, cout, 1), BatchNorm(cout)
        if shortcut:
            self.shortcut = ConvBN(cin, cout)


class Backbone(nn.Module):
    def __init__(self, cfg: DeformableConfig):
        super().__init__()
        self.embed_conv = _conv_module(3, cfg.backbone_embed_channels, 7)
        self.embed_bn = BatchNorm(cfg.backbone_embed_channels)
        stages, cin = [], cfg.backbone_embed_channels
        for depth, cout in zip(cfg.backbone_depths, cfg.backbone_channels):
            stages.append(nn.ModuleList(Bottleneck(cin if li == 0 else cout, cout, li == 0)
                                        for li in range(depth)))
            cin = cout
        self.stages = nn.ModuleList(stages)


class InputProj(nn.Module):
    def __init__(self, cin: int, d: int, k: int):
        super().__init__()
        self.conv = _conv_module(cin, d, k)
        self.gn = nn.GroupNorm(32, d)


class MSDeformAttn(nn.Module):
    def __init__(self, cfg: DeformableConfig):
        super().__init__()
        d, h = cfg.d_model, cfg.encoder_attention_heads
        lp = cfg.num_feature_levels * cfg.encoder_n_points
        self.sampling_offsets = nn.Linear(d, h * lp * 2)
        self.attention_weights = nn.Linear(d, h * lp)
        self.value_proj = nn.Linear(d, d)
        self.output_proj = nn.Linear(d, d)


class DeformableEncoderLayer(nn.Module):
    def __init__(self, cfg: DeformableConfig):
        super().__init__()
        d = cfg.d_model
        self.self_attn = MSDeformAttn(cfg)
        self.self_attn_layer_norm = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.fc1 = nn.Linear(d, cfg.encoder_ffn_dim)
        self.fc2 = nn.Linear(cfg.encoder_ffn_dim, d)
        self.final_layer_norm = nn.LayerNorm(d, eps=cfg.layer_norm_eps)


def _input_proj_shapes(cfg: DeformableConfig) -> List[Tuple[int, int]]:
    """(in channels, kernel) of each level's projection."""
    out_channels = [cfg.backbone_channels[i] for i in cfg.backbone_out]
    shapes = []
    for li in range(cfg.num_feature_levels):
        if li < len(out_channels):
            shapes.append((out_channels[li], 1))
        else:
            shapes.append((out_channels[-1] if li == len(out_channels) else cfg.d_model, 3))
    return shapes


class DeformableTower(nn.Module):
    def __init__(self, cfg: DeformableConfig):
        super().__init__()
        self.backbone = Backbone(cfg)
        self.input_proj = nn.ModuleList(InputProj(cin, cfg.d_model, k)
                                        for cin, k in _input_proj_shapes(cfg))
        self.level_embed = nn.Parameter(torch.empty(cfg.num_feature_levels, cfg.d_model))
        self.layers = nn.ModuleList(DeformableEncoderLayer(cfg)
                                    for _ in range(cfg.encoder_layers))


# ---------------------------------------------------------------------------
# ResNet backbone
# ---------------------------------------------------------------------------


def _conv(conv: nn.Conv2d, x: torch.Tensor, stride: int = 1, padding: int = 0) -> torch.Tensor:
    return F.conv2d(x, conv.weight.to(x.dtype), stride=stride, padding=padding)


def _bn(p: BatchNorm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    inv = torch.rsqrt(p.running_var.float() + eps)
    scale = p.weight.float() * inv
    bias = p.bias.float() - p.running_mean.float() * scale
    return (x.float() * scale[None, :, None, None] + bias[None, :, None, None]).to(x.dtype)


def _bottleneck(p: Bottleneck, x: torch.Tensor, stride: int) -> torch.Tensor:
    """HF ResNetBottleNeckLayer: 1x1 reduce -> 3x3 -> 1x1 expand, BN after each
    conv, a shortcut conv when the shape changes."""
    identity = x
    if hasattr(p, "shortcut"):
        identity = _bn(p.shortcut.bn, _conv(p.shortcut.conv, x, stride))
    h = F.relu(_bn(p.bn0, _conv(p.conv0, x)))
    h = F.relu(_bn(p.bn1, _conv(p.conv1, h, stride, padding=1)))
    h = _bn(p.bn2, _conv(p.conv2, h))
    return F.relu(h + identity)


def resnet_features(backbone: Backbone, pixels: torch.Tensor,
                    cfg: DeformableConfig) -> List[torch.Tensor]:
    """(B, 3, H, W) -> the feature maps of the cfg.backbone_out stages."""
    x = F.relu(_bn(backbone.embed_bn, _conv(backbone.embed_conv, pixels, 2, padding=3)))
    x = F.max_pool2d(x, 3, 2, padding=1)
    outs = []
    for si, stage in enumerate(backbone.stages):
        stride = 1 if si == 0 else 2
        for li, layer in enumerate(stage):
            x = _bottleneck(layer, x, stride if li == 0 else 1)
        if si in cfg.backbone_out:
            outs.append(x)
    return outs


# ---------------------------------------------------------------------------
# DETR sine position embedding (normalised)
# ---------------------------------------------------------------------------


def sine_position_embedding(h: int, w: int, d_model: int, device=None,
                            temperature: float = 10000.0) -> torch.Tensor:
    """(d_model, h, w): HF DeformableDetrSinePositionEmbedding with a full
    mask, at cell centres ((cumsum - 0.5) / last), scale 2 pi."""
    half = d_model // 2
    eps = 1e-6
    scale = 2 * math.pi
    y = (torch.arange(1, h + 1, dtype=torch.float32, device=device) - 0.5)[:, None] / (h + eps) * scale
    x = (torch.arange(1, w + 1, dtype=torch.float32, device=device) - 0.5)[None, :] / (w + eps) * scale
    dim_t = temperature ** (2 * (torch.arange(half, device=device) // 2) / half)
    pos_x = x[..., None] / dim_t  # (1, w, half)
    pos_y = y[..., None] / dim_t  # (h, 1, half)
    pos_x = torch.stack([pos_x[..., 0::2].sin(), pos_x[..., 1::2].cos()], -1).reshape(1, w, half)
    pos_y = torch.stack([pos_y[..., 0::2].sin(), pos_y[..., 1::2].cos()], -1).reshape(h, 1, half)
    return torch.cat([pos_y.expand(h, w, half), pos_x.expand(h, w, half)], -1).permute(2, 0, 1)


# ---------------------------------------------------------------------------
# Multi-scale deformable attention
# ---------------------------------------------------------------------------


def _grid_sample(value: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """torch ``grid_sample`` (bilinear, zero padding, align_corners=False) on
    one level, in f32: value (BH, E, H, W), grid (BH, Q, P, 2) in [-1, 1]
    as (x, y). Returns (BH, E, Q, P) in value's dtype."""
    out = F.grid_sample(value.float(), grid.float(), mode="bilinear", padding_mode="zeros",
                        align_corners=False)
    return out.to(value.dtype)


def deformable_attention(p: MSDeformAttn, cfg: DeformableConfig, hidden: torch.Tensor,
                         pos: torch.Tensor, reference_points: torch.Tensor,
                         spatial_shapes: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """HF DeformableDetrMultiscaleDeformableAttention.forward: hidden (B, Q, D)
    (queries are the values), pos (B, Q, D), reference_points (B, Q, L, 2)."""
    b, q, d = hidden.shape
    h = cfg.encoder_attention_heads
    e = cfg.head_dim
    nl = len(spatial_shapes)
    pts = cfg.encoder_n_points

    query = hidden + pos
    value = p.value_proj(hidden).reshape(b, q, h, e)
    offsets = p.sampling_offsets(query).reshape(b, q, h, nl, pts, 2)
    weights = torch.softmax(p.attention_weights(query).reshape(b, q, h, nl * pts).float(), -1)
    weights = weights.to(hidden.dtype).reshape(b, q, h, nl, pts)

    # offset_normalizer = (w, h) per level.
    normalizer = torch.tensor([(w_, h_) for h_, w_ in spatial_shapes], dtype=torch.float32,
                              device=hidden.device)
    loc = (reference_points[:, :, None, :, None, :]
           + offsets.float() / normalizer[None, None, None, :, None, :])
    grids = 2 * loc - 1  # (B, Q, H, L, P, 2)

    outs, start = [], 0
    for li, (hh, ww) in enumerate(spatial_shapes):
        v_l = value[:, start: start + hh * ww].permute(0, 2, 3, 1).reshape(b * h, e, hh, ww)
        g_l = grids[:, :, :, li].permute(0, 2, 1, 3, 4).reshape(b * h, q, pts, 2)
        outs.append(_grid_sample(v_l, g_l))  # (B*H, E, Q, P)
        start += hh * ww
    sampled = torch.stack(outs, dim=-2)  # (B*H, E, Q, L, P)
    w_ = weights.permute(0, 2, 1, 3, 4).reshape(b * h, 1, q, nl, pts)
    out = (sampled * w_.to(sampled.dtype)).sum(dim=(-2, -1))  # (B*H, E, Q)
    out = out.reshape(b, h, e, q).permute(0, 3, 1, 2).reshape(b, q, d)
    return p.output_proj(out.to(hidden.dtype))


def _ln(ln: nn.LayerNorm, x: torch.Tensor, eps: float) -> torch.Tensor:
    y = F.layer_norm(x.float(), x.shape[-1:], ln.weight.float(), ln.bias.float(), eps)
    return y.to(x.dtype)


def encoder_layer(p: DeformableEncoderLayer, cfg: DeformableConfig, hidden, pos,
                  reference_points, spatial_shapes):
    """HF DeformableDetrEncoderLayer: deformable self-attention + ReLU FFN,
    post-LN residuals."""
    attn = deformable_attention(p.self_attn, cfg, hidden, pos, reference_points, spatial_shapes)
    hidden = _ln(p.self_attn_layer_norm, hidden + attn, cfg.layer_norm_eps)
    ffn = p.fc2(F.relu(p.fc1(hidden)))
    return _ln(p.final_layer_norm, hidden + ffn, cfg.layer_norm_eps)


def encoder_reference_points(spatial_shapes: Sequence[Tuple[int, int]],
                             device=None) -> torch.Tensor:
    """(1, Q, L, 2) normalised cell centres of every level, tiled over levels
    (HF get_reference_points with valid_ratios == 1)."""
    refs = []
    for h, w in spatial_shapes:
        ys = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h
        xs = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        refs.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], -1))
    ref = torch.cat(refs, 0)
    return ref[None, :, None, :].expand(1, ref.shape[0], len(spatial_shapes), 2)


def _group_norm(gn: nn.GroupNorm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    y = F.group_norm(x.float(), gn.num_groups, gn.weight.float(), gn.bias.float(), eps)
    return y.to(x.dtype)


def deformable_encode(tower: DeformableTower, pixels: torch.Tensor,
                      cfg: DeformableConfig) -> List[torch.Tensor]:
    """(B, 3, H, W) -> per-layer hidden states [(B, Q, D)] of the deformable
    encoder over the multi-scale token sequence (reference
    DeformableVisionModel.forward, deformer_modeling.py:60-160)."""
    pixels = pixels.to(tower.level_embed.dtype)
    feats = resnet_features(tower.backbone, pixels, cfg)
    sources, shapes = [], []
    for li, f in enumerate(feats):
        proj = tower.input_proj[li]
        sources.append(_group_norm(proj.gn, _conv(proj.conv, f)))
    # Extra lowest-resolution levels: 3x3 stride-2 convs.
    for li in range(len(feats), cfg.num_feature_levels):
        src = feats[-1] if li == len(feats) else sources[-1]
        proj = tower.input_proj[li]
        sources.append(_group_norm(proj.gn, _conv(proj.conv, src, 2, padding=1)))
    shapes = [tuple(s.shape[-2:]) for s in sources]

    b = pixels.shape[0]
    dev = pixels.device
    flat = torch.cat([s.reshape(b, cfg.d_model, -1).transpose(1, 2) for s in sources], 1)
    pos = torch.cat([
        (sine_position_embedding(hh, ww, cfg.d_model, dev).to(flat.dtype).reshape(cfg.d_model, -1).t()
         + tower.level_embed[li].to(flat.dtype))[None]
        for li, (hh, ww) in enumerate(shapes)], 1).expand_as(flat)
    refs = encoder_reference_points(shapes, dev).expand(b, -1, -1, -1)

    hidden = flat
    states = [hidden]
    for lp in tower.layers:
        hidden = encoder_layer(lp, cfg, hidden, pos, refs, shapes)
        states.append(hidden)
    return states


def init_deformable_params(cfg: DeformableConfig, *, seed: int = 0, dtype=torch.float32,
                           device="cpu") -> DeformableTower:
    """Seeded tower, drawn as the JAX initialiser draws: He-normal
    convolutions, identity BatchNorms, unit GroupNorms, uniform(1/sqrt(d_in))
    projections, zero offset and weight kernels with the HF directional
    offset-bias grid, a normal level embedding."""
    tower = empty_module(lambda: DeformableTower(cfg), device, dtype)
    g = generator(device, seed)
    h = cfg.encoder_attention_heads
    thetas = torch.arange(h, dtype=torch.float32) * (2.0 * math.pi / h)
    grid = torch.stack([thetas.cos(), thetas.sin()], -1)
    grid = grid / grid.abs().max(-1, keepdim=True).values
    grid = grid[:, None, None, :].repeat(1, cfg.num_feature_levels, cfg.encoder_n_points, 1)
    grid = grid * torch.arange(1, cfg.encoder_n_points + 1, dtype=torch.float32)[None, None, :, None]
    with torch.no_grad():
        for name, p in list(tower.named_parameters()) + list(tower.named_buffers()):
            leaf = name.rsplit(".", 1)[-1]
            if name.endswith("sampling_offsets.bias"):
                p.copy_(grid.reshape(-1))
            elif "sampling_offsets" in name or "attention_weights" in name:
                p.zero_()
            elif leaf == "running_var" or (leaf == "weight" and p.dim() == 1):
                p.fill_(1.0)
            elif leaf in ("bias", "running_mean"):
                p.zero_()
            elif p.dim() == 4:
                p.normal_(0.0, (2.0 / (p.shape[1] * p.shape[2] * p.shape[3])) ** 0.5, generator=g)
            elif p.dim() == 2 and leaf == "weight":
                lim = (1.0 / p.shape[1]) ** 0.5
                p.uniform_(-lim, lim, generator=g)
            else:
                p.normal_(0.0, 1.0, generator=g)
    return tower
