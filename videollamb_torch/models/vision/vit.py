"""Generic ViT-family towers: ViT, ViT-MAE, ViViT, VideoMAE.

Port of ``videollamb_tpu/models/vision/vit.py`` (reference
llava/model/multimodal_encoder/{vit,mae,vivit,videomae}_encoder.py, each a
thin wrapper over the HF model). One module covers all four:

- 2-D patches (ViT / MAE) or 3-D tubelets (ViViT / VideoMAE);
- an optional CLS token (VideoMAE has none);
- learned positional embeddings or VideoMAE's fixed sin-cos table;
- pre-LN encoder blocks (layernorm_before -> MHA -> +res -> layernorm_after
  -> MLP -> +res), exact GELU;
- VideoMAE's q / v-only biases (k unbiased).

The module keeps the JAX tree's leaf names (``embeddings.patch_embedding``,
``layers.N.attention.query`` ...), so ``models/convert.py`` maps it both
ways. The attention is plain PyTorch, as it is plain XLA in the JAX
package. Select-layer semantics match the CLIP towers: hidden_states[sel].
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from videollamb_torch.models.seeded import empty_module, generator
from videollamb_torch.ops.temporal_attention import _layer_norm


@dataclasses.dataclass(frozen=True)
class ViTFamilyConfig:
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    image_size: int = 224
    patch_size: int = 16
    tubelet_t: int = 1  # > 1 for ViViT / VideoMAE tubelets
    num_frames: int = 1
    use_cls_token: bool = True
    pos_embed: str = "learned"  # 'learned' | 'sincos'
    layer_norm_eps: float = 1e-12
    qkv_bias: str = "full"  # 'full' | 'qv_only' (VideoMAE) | 'none'
    select_layer: int = -2

    @property
    def tokens_per_frame_group(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @staticmethod
    def vit_base(**kw):
        return ViTFamilyConfig(**kw)

    @staticmethod
    def vivit_base(num_frames=32, **kw):
        return ViTFamilyConfig(tubelet_t=2, num_frames=num_frames, layer_norm_eps=1e-6, **kw)

    @staticmethod
    def videomae_base(num_frames=16, **kw):
        return ViTFamilyConfig(tubelet_t=2, num_frames=num_frames, use_cls_token=False,
                               pos_embed="sincos", qkv_bias="qv_only", **kw)


def sincos_position_table(n_position: int, d: int) -> np.ndarray:
    """HF VideoMAE fixed table: sin on even columns, cos on odd."""
    pos = np.arange(n_position)[:, None]
    dim = np.arange(d)[None, :]
    angle = pos / np.power(10000, 2 * (dim // 2) / d)
    table = np.zeros((n_position, d), np.float32)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table


class ViTEmbeddings(nn.Module):
    def __init__(self, cfg: ViTFamilyConfig):
        super().__init__()
        d = cfg.hidden_size
        self.patch_embedding = nn.Linear(3 * cfg.tubelet_t * cfg.patch_size ** 2, d)
        if cfg.use_cls_token:
            self.cls_token = nn.Parameter(torch.empty(d))
        if cfg.pos_embed == "learned":
            gt = max(cfg.num_frames // cfg.tubelet_t, 1)
            n = gt * cfg.tokens_per_frame_group + int(cfg.use_cls_token)
            self.position_embeddings = nn.Parameter(torch.empty(n, d))


class ViTAttention(nn.Module):
    def __init__(self, cfg: ViTFamilyConfig):
        super().__init__()
        d = cfg.hidden_size
        qv = cfg.qkv_bias != "none"
        self.query = nn.Linear(d, d, bias=qv)
        self.key = nn.Linear(d, d, bias=cfg.qkv_bias == "full")
        self.value = nn.Linear(d, d, bias=qv)
        self.output = nn.Linear(d, d)


class ViTLayer(nn.Module):
    def __init__(self, cfg: ViTFamilyConfig):
        super().__init__()
        d = cfg.hidden_size
        self.layernorm_before = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.attention = ViTAttention(cfg)
        self.layernorm_after = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.intermediate = nn.Linear(d, cfg.intermediate_size)
        self.output = nn.Linear(cfg.intermediate_size, d)


class ViTTower(nn.Module):
    """``embeddings`` and ``layers``; ``layernorm`` when a checkpoint has one
    (the select layer never reaches it)."""

    def __init__(self, cfg: ViTFamilyConfig, final_layernorm: bool = False):
        super().__init__()
        self.embeddings = ViTEmbeddings(cfg)
        self.layers = nn.ModuleList(ViTLayer(cfg) for _ in range(cfg.num_hidden_layers))
        if final_layernorm:
            self.layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


def _attention(p: ViTAttention, x: torch.Tensor, heads: int) -> torch.Tensor:
    b, n, d = x.shape
    dh = d // heads

    def split(v):
        return v.reshape(b, n, heads, dh).transpose(1, 2)

    q, k, v = split(p.query(x)), split(p.key(x)), split(p.value(x))
    s = torch.matmul(q, k.transpose(-1, -2)).float() / math.sqrt(dh)
    o = torch.matmul(torch.softmax(s, -1).to(v.dtype), v)
    return p.output(o.transpose(1, 2).reshape(b, n, d))


def _embed(emb: ViTEmbeddings, pixels: torch.Tensor, cfg: ViTFamilyConfig) -> torch.Tensor:
    """pixels (B, T, C, H, W) -> (B, tokens, D); T == 1 for image models."""
    b, t, c, h, w = pixels.shape
    ph = pw = cfg.patch_size
    tt = cfg.tubelet_t
    gh, gw, gt = h // ph, w // pw, t // tt
    x = pixels.reshape(b, gt, tt, c, gh, ph, gw, pw)
    # (B, gt, gh, gw, C, tt, ph, pw) row-major matches the Conv3d weight
    # (D, C, tt, ph, pw).
    x = x.permute(0, 1, 4, 6, 3, 2, 5, 7).reshape(b, gt * gh * gw, c * tt * ph * pw)
    tokens = emb.patch_embedding(x)
    if cfg.use_cls_token:
        cls = emb.cls_token.to(x.dtype).expand(b, 1, cfg.hidden_size)
        tokens = torch.cat([cls, tokens], dim=1)
    if cfg.pos_embed == "learned":
        return tokens + emb.position_embeddings.to(x.dtype)[None]
    table = torch.from_numpy(sincos_position_table(tokens.shape[1], cfg.hidden_size))
    return tokens + table.to(device=x.device, dtype=x.dtype)[None]


def vit_encode(tower: ViTTower, pixels: torch.Tensor, cfg: ViTFamilyConfig,
               select_layer: Optional[int] = None) -> torch.Tensor:
    """(B, T, C, H, W) -> select-layer hidden states (B, tokens, D)."""
    sel = cfg.select_layer if select_layer is None else select_layer
    n_layers = len(tower.layers) + sel + 1 if sel < 0 else sel
    eps = cfg.layer_norm_eps
    x = _embed(tower.embeddings, pixels.to(tower.embeddings.patch_embedding.weight.dtype), cfg)
    for lp in tower.layers[:n_layers]:
        x = x + _attention(lp.attention, _layer_norm(lp.layernorm_before, x, eps),
                           cfg.num_attention_heads)
        h = _layer_norm(lp.layernorm_after, x, eps)
        h = F.gelu(lp.intermediate(h).float()).to(x.dtype)
        x = x + lp.output(h)
    return x


def init_vit_params(cfg: ViTFamilyConfig, *, seed: int = 0, dtype=torch.float32,
                    device="cpu") -> ViTTower:
    """Seeded tower, drawn as the JAX initialiser draws: normal kernels of
    std 1/sqrt(d_in), zero biases, 0.02-std CLS and positions, unit norms."""
    tower = empty_module(lambda: ViTTower(cfg), device, dtype)
    g = generator(device, seed)
    with torch.no_grad():
        for name, p in tower.named_parameters():
            if "layernorm" in name:
                p.fill_(1.0 if name.endswith("weight") else 0.0)
            elif name.endswith("bias"):
                p.zero_()
            elif name.endswith("weight"):
                p.normal_(0.0, p.shape[1] ** -0.5, generator=g)
            else:
                p.normal_(0.0, 0.02, generator=g)
    return tower


def convert_vit_state_dict(sd: Mapping[str, Any], cfg: ViTFamilyConfig) -> dict:
    """HF ViT / ViTMAE / Vivit / VideoMAE state dict -> the state of
    :class:`ViTTower` (load with ``ViTTower(cfg, "layernorm.weight" in sd)``)."""
    def t(name):
        v = sd[name]
        return v.detach().float().cpu() if torch.is_tensor(v) else torch.as_tensor(
            np.asarray(v, np.float32))

    out = {}
    pw = t("embeddings.patch_embeddings.projection.weight")
    d = pw.shape[0]
    out["embeddings.patch_embedding.weight"] = pw.reshape(d, -1)
    out["embeddings.patch_embedding.bias"] = t("embeddings.patch_embeddings.projection.bias")
    if cfg.use_cls_token:
        out["embeddings.cls_token"] = t("embeddings.cls_token").reshape(d)
    if cfg.pos_embed == "learned":
        out["embeddings.position_embeddings"] = t("embeddings.position_embeddings").reshape(-1, d)
    names = {"attention.query": "attention.attention.query",
             "attention.key": "attention.attention.key",
             "attention.value": "attention.attention.value",
             "attention.output": "attention.output.dense",
             "layernorm_before": "layernorm_before", "layernorm_after": "layernorm_after",
             "intermediate": "intermediate.dense", "output": "output.dense"}
    i = 0
    while f"encoder.layer.{i}.attention.attention.query.weight" in sd:
        src, dst = f"encoder.layer.{i}.", f"layers.{i}."
        for ours, theirs in names.items():
            for leaf in ("weight", "bias"):
                if f"{src}{theirs}.{leaf}" in sd:
                    out[f"{dst}{ours}.{leaf}"] = t(f"{src}{theirs}.{leaf}")
        if cfg.qkv_bias == "qv_only":
            out[f"{dst}attention.query.bias"] = t(f"{src}attention.attention.q_bias")
            out[f"{dst}attention.value.bias"] = t(f"{src}attention.attention.v_bias")
        i += 1
    # VideoMAE with mean pooling has no final layernorm.
    if "layernorm.weight" in sd:
        out["layernorm.weight"] = t("layernorm.weight")
        out["layernorm.bias"] = t("layernorm.bias")
    return out
