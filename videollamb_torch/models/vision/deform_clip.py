"""DeformCLIP vision tower: CLIP ViT whose self-attention is single-level
deformable attention over the patch grid.

Port of ``videollamb_tpu/models/vision/deform_clip.py`` (reference
llava/model/multimodal_encoder/deform_clip/, which cannot run as shipped;
the JAX module's docstring lists its faults). As there:

- CLIP embeddings (patchify + CLS + learned positions, ``clip_vit._embed``)
  and pre-LN residual layers with a quick-GELU MLP;
- each layer's self-attention is deformable: per query, ``n_points``
  sampling offsets and softmax weights per head come from linear heads;
  values are sampled bilinearly from the v-projected patch grid
  (``deformable._grid_sample``, one level) and combined with the weights,
  then out-projected;
- reference points are patch-cell centres, the CLS query's the image
  centre (0.5, 0.5);
- ``q_proj`` / ``k_proj`` exist but are never read, as in the reference.

The module keeps the JAX tree's names (the embeddings those of the CLIP
tower), so ``models/convert.py`` maps it both ways. Everything here is plain
PyTorch, as it is plain XLA in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from videollamb_torch.models.seeded import empty_module, generator
from videollamb_torch.models.vision.clip_vit import CLIPEmbeddings, _embed
from videollamb_torch.models.vision.deformable import _grid_sample, _ln


@dataclasses.dataclass(frozen=True)
class DeformCLIPConfig:
    """deform_clip_configuration.py:160-260 CLIPVisionConfig + n_points."""

    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    image_size: int = 224
    patch_size: int = 14
    n_points: int = 4  # deform_clip_configuration.py:229
    layer_norm_eps: float = 1e-5
    select_layer: int = -2

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def seq_len(self) -> int:
        return 1 + self.grid * self.grid

    @classmethod
    def tiny(cls) -> "DeformCLIPConfig":
        return cls(hidden_size=32, intermediate_size=64, num_hidden_layers=3,
                   num_attention_heads=4, image_size=28, patch_size=7, n_points=2)


class DeformCLIPAttention(nn.Module):
    def __init__(self, cfg: DeformCLIPConfig):
        super().__init__()
        d, h = cfg.hidden_size, cfg.num_attention_heads
        self.q_proj = nn.Linear(d, d)  # created, never read (:391-392)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)
        self.sampling_offsets = nn.Linear(d, h * cfg.n_points * 2)
        self.attention_weights = nn.Linear(d, h * cfg.n_points)


class DeformCLIPMLP(nn.Module):
    def __init__(self, d: int, inter: int):
        super().__init__()
        self.fc1 = nn.Linear(d, inter)
        self.fc2 = nn.Linear(inter, d)


class DeformCLIPLayer(nn.Module):
    def __init__(self, cfg: DeformCLIPConfig):
        super().__init__()
        d = cfg.hidden_size
        self.self_attn = DeformCLIPAttention(cfg)
        self.layer_norm1 = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.layer_norm2 = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.mlp = DeformCLIPMLP(d, cfg.intermediate_size)


class DeformCLIPTower(nn.Module):
    def __init__(self, cfg: DeformCLIPConfig):
        super().__init__()
        self.embeddings = CLIPEmbeddings(cfg)
        self.pre_layrnorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)  # sic, HF
        self.post_layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList(DeformCLIPLayer(cfg) for _ in range(cfg.num_hidden_layers))


def reference_points(gh: int, gw: int, device=None) -> torch.Tensor:
    """(1+N, 2) normalised (x, y) anchors: the image centre for CLS, the
    patch-cell centres for the grid (get_reference_points, :885-902)."""
    ys = (torch.arange(gh, dtype=torch.float32, device=device) + 0.5) / gh
    xs = (torch.arange(gw, dtype=torch.float32, device=device) + 0.5) / gw
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    pts = torch.stack([gx.reshape(-1), gy.reshape(-1)], -1)
    return torch.cat([torch.full((1, 2), 0.5, device=device), pts], 0)


def deform_clip_attention(p: DeformCLIPAttention, x: torch.Tensor, refs: torch.Tensor,
                          gh: int, gw: int, *, num_heads: int, n_points: int) -> torch.Tensor:
    """DeformCLIPAttention's intended forward (:399-465): values from the
    patch grid only (x[:, 1:]); every token, CLS included, is a query."""
    b, s, d = x.shape
    e = d // num_heads
    value = p.v_proj(x[:, 1:]).reshape(b, gh * gw, num_heads, e)
    offsets = p.sampling_offsets(x).reshape(b, s, num_heads, n_points, 2)
    weights = torch.softmax(p.attention_weights(x).reshape(b, s, num_heads, n_points).float(), -1)
    # offset_normalizer = (W, H) (:435-439, one level).
    norm = torch.tensor([gw, gh], dtype=torch.float32, device=x.device)
    loc = refs[None, :, None, None, :] + offsets.float() / norm
    grids = 2.0 * loc - 1.0  # (B, S, H, P, 2)
    v_map = value.permute(0, 2, 3, 1).reshape(b * num_heads, e, gh, gw)
    g = grids.permute(0, 2, 1, 3, 4).reshape(b * num_heads, s, n_points, 2)
    sampled = _grid_sample(v_map, g)  # (B*H, E, S, P)
    w = weights.permute(0, 2, 1, 3).reshape(b * num_heads, 1, s, n_points)
    out = (sampled * w.to(sampled.dtype)).sum(-1)  # (B*H, E, S)
    out = out.reshape(b, num_heads, e, s).permute(0, 3, 1, 2)
    return p.out_proj(out.reshape(b, s, d).to(x.dtype))


def encoder_layer(p: DeformCLIPLayer, cfg: DeformCLIPConfig, x: torch.Tensor,
                  refs: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
    """Pre-LN residual layer (DeformCLIPEncoderLayer.forward, :595-639)."""
    h = _ln(p.layer_norm1, x, cfg.layer_norm_eps)
    x = x + deform_clip_attention(p.self_attn, h, refs, gh, gw,
                                  num_heads=cfg.num_attention_heads, n_points=cfg.n_points)
    h = p.mlp.fc1(_ln(p.layer_norm2, x, cfg.layer_norm_eps))
    return x + p.mlp.fc2(h * torch.sigmoid(1.702 * h))


def deform_clip_encode(tower: DeformCLIPTower, pixels: torch.Tensor, cfg: DeformCLIPConfig,
                       select_layer: Optional[int] = None) -> torch.Tensor:
    """(M, C, H, W) -> (M, 1+N, D) select-layer hidden states."""
    sel = cfg.select_layer if select_layer is None else select_layer
    stop = cfg.num_hidden_layers + 1 + sel if sel < 0 else sel
    gh = gw = pixels.shape[-1] // cfg.patch_size
    x = _embed(tower.embeddings, pixels.to(tower.embeddings.class_embedding.dtype), cfg)
    x = _ln(tower.pre_layrnorm, x, cfg.layer_norm_eps)
    refs = reference_points(gh, gw, x.device)
    for layer in tower.layers[:stop]:
        x = encoder_layer(layer, cfg, x, refs, gh, gw)
    return x


def init_deform_clip_params(cfg: DeformCLIPConfig, *, seed: int = 0, dtype=torch.float32,
                            device="cpu") -> DeformCLIPTower:
    """Seeded tower with the JAX initialiser's scales (CLIP's; the deform
    heads 0.02-std normal)."""
    tower = empty_module(lambda: DeformCLIPTower(cfg), device, dtype)
    g = generator(device, seed)
    d, n = cfg.hidden_size, cfg.num_hidden_layers
    in_std = d ** -0.5 * (2 * n) ** -0.5
    stds = {"q_proj": in_std, "k_proj": in_std, "v_proj": in_std, "out_proj": d ** -0.5,
            "sampling_offsets": 0.02, "attention_weights": 0.02, "fc1": (2 * d) ** -0.5,
            "fc2": in_std, "patch_embedding": 0.02, "position_embedding": 0.02}
    with torch.no_grad():
        for name, p in tower.named_parameters():
            parts = name.split(".")
            if "norm" in name or "layrnorm" in name:
                p.fill_(1.0 if parts[-1] == "weight" else 0.0)
            elif parts[-1] == "bias":
                p.zero_()
            elif parts[-1] == "class_embedding":
                p.normal_(0.0, d ** -0.5, generator=g)
            else:
                p.normal_(0.0, stds[parts[-2]], generator=g)
    return tower
