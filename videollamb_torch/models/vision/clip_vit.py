"""LanguageBind CLIP-ViT vision tower with per-layer temporal attention.

Port of ``videollamb_tpu/models/vision/clip_vit.py``. Module and parameter
names follow the reference tower checkpoint (``vision_model.embeddings``,
``vision_model.pre_layrnorm`` -- sic -- ``vision_model.encoder.layers.N.
{self_attn,temporal_attn,...}``), so a LanguageBind tower state dict loads
by name. Linear weights keep the (out, in) orientation.

- The patchify convolution (stride == kernel) is a reshape plus one matmul,
  as in the JAX package; cuDNN would run an f32 convolution in TF32.
- Temporal attention runs over fixed windows of ``cfg.num_frames`` frames
  on the frame-major residual stream (kernel K2), spatial attention over
  the patches of each frame with heads packed (kernel K1). Both go through
  the differentiable ops (``temporal_attention_fm``, ``spatial_core_packed``:
  kernel forward, plain-recompute backward), so gradients reach the pixels
  and every weight, as through the JAX package's ``custom_vjp`` rules.
- After ``models/vision/quant.quantize_vision_params`` the dense layers and
  the patch embedding are ``Int8Dense`` modules (int8 x int8 products with
  per-row activation scales); the attention cores are unchanged.
- Under tensor parallelism (``parallel/sharding.shard_params``) the
  projections are DTensors sharded over the mesh's ``model`` axis and
  computed through ``llama.proj``: each rank's K1 and K2 see its own heads,
  (B, N, D / tp) and (b, t, N, 3 D / tp). Each layer is called as a module
  (``CLIPEncoderLayer.forward``), so FSDP's hooks gather its weights.
- Feature extraction stops at the select layer (-2: the last layer is
  never run). :func:`patch_dropout` (training only) keeps one random subset
  of patches per video, drawn from the caller's ``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from videollamb_torch.config import VisionConfig
from videollamb_torch.models.bridge.layers import _act
from videollamb_torch.models.lm.llama import proj
from videollamb_torch.models.seeded import empty_module, fill_dense_, generator
from videollamb_torch.parallel.tensor_parallel import tp_linear
from videollamb_torch.ops.spatial_attention import spatial_core_packed
from videollamb_torch.ops.temporal_attention import _layer_norm, temporal_attention_fm


class CLIPAttention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)


class CLIPMLP(nn.Module):
    def __init__(self, d: int, inter: int):
        super().__init__()
        self.fc1 = nn.Linear(d, inter)
        self.fc2 = nn.Linear(inter, d)


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: VisionConfig):
        super().__init__()
        d = cfg.hidden_size
        self.self_attn = CLIPAttention(d)
        self.layer_norm1 = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.mlp = CLIPMLP(d, cfg.intermediate_size)
        self.layer_norm2 = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        if cfg.add_time_attn:
            self.temporal_embedding = nn.Parameter(torch.empty(1, cfg.num_frames, d))
            self.temporal_attn = CLIPAttention(d)
            self.temporal_layer_norm1 = nn.LayerNorm(d, eps=cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor, cfg: VisionConfig, time_window: int) -> torch.Tensor:
        return _encoder_layer(self, x, cfg, time_window)


class PatchEmbedding(nn.Module):
    """Holds the (D, C, ph, pw) patchify weight under the conv's key name."""

    def __init__(self, d: int, patch: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d, 3, patch, patch))


class CLIPEmbeddings(nn.Module):
    def __init__(self, cfg: VisionConfig):
        super().__init__()
        self.class_embedding = nn.Parameter(torch.empty(cfg.hidden_size))
        self.patch_embedding = PatchEmbedding(cfg.hidden_size, cfg.patch_size)
        self.position_embedding = nn.Embedding(cfg.seq_len, cfg.hidden_size)


class CLIPEncoder(nn.Module):
    def __init__(self, cfg: VisionConfig):
        super().__init__()
        self.layers = nn.ModuleList(CLIPEncoderLayer(cfg) for _ in range(cfg.num_hidden_layers))


class CLIPVisionTransformer(nn.Module):
    def __init__(self, cfg: VisionConfig):
        super().__init__()
        self.embeddings = CLIPEmbeddings(cfg)
        self.pre_layrnorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.encoder = CLIPEncoder(cfg)
        self.post_layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class CLIPVisionTower(nn.Module):
    """Tower checkpoint root: parameters under ``vision_model.*``."""

    def __init__(self, cfg: VisionConfig):
        super().__init__()
        self.vision_model = CLIPVisionTransformer(cfg)


def _clip_attention(attn: CLIPAttention, x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """CLIPAttention with the packed spatial core (kernel K1) over this
    rank's heads."""
    e = x.shape[-1] // num_heads
    q = proj(attn.q_proj, x) * e ** -0.5
    out = spatial_core_packed(q, proj(attn.k_proj, x), proj(attn.v_proj, x), q.shape[-1] // e)
    return proj(attn.out_proj, out)


def _encoder_layer(layer: CLIPEncoderLayer, x: torch.Tensor, cfg: VisionConfig,
                   time_window: int) -> torch.Tensor:
    """One pre-LN encoder layer: [temporal attn ->] spatial attn -> MLP."""
    bt, n, d = x.shape
    eps = cfg.layer_norm_eps
    if cfg.add_time_attn and time_window > 1:
        t = time_window
        y = temporal_attention_fm(
            x.reshape(bt // t, t, n, d), layer.temporal_embedding,
            layer.temporal_layer_norm1, layer.temporal_attn,
            cfg.num_attention_heads, eps)
        x = y.reshape(bt, n, d)
    x = x + _clip_attention(layer.self_attn, _layer_norm(layer.layer_norm1, x, eps),
                            cfg.num_attention_heads)
    h = _layer_norm(layer.layer_norm2, x, eps)
    return x + proj(layer.mlp.fc2, _act(cfg.hidden_act, proj(layer.mlp.fc1, h)))


def _embed(emb: CLIPEmbeddings, pixels: torch.Tensor, cfg: VisionConfig) -> torch.Tensor:
    """Patchify + class token + positional embedding: (M, C, H, W) -> (M, 1+N, D)."""
    m, c, h, w = pixels.shape
    p = cfg.patch_size
    gh, gw = h // p, w // p
    x = pixels.reshape(m, c, gh, p, gw, p).permute(0, 2, 4, 1, 3, 5)
    x = x.reshape(m, gh * gw, c * p * p)
    if isinstance(emb.patch_embedding, PatchEmbedding):
        weight = emb.patch_embedding.weight
        patches = tp_linear(x, weight.reshape(weight.shape[0], -1), gather=True)
    else:  # int8 patch embedding, no bias
        patches = emb.patch_embedding(x)
    cls = emb.class_embedding.to(x.dtype).expand(m, 1, -1)
    x = torch.cat([cls, patches], dim=1)
    return x + emb.position_embedding.weight.to(x.dtype)[None]


def patch_dropout(x: torch.Tensor, generator: torch.Generator, prob: float, b: int,
                  t: int) -> torch.Tensor:
    """PatchDropout (reference modeling_video.py:32-76): keep the patches of a
    random top-(1 - prob) subset, the same subset for every frame of a video;
    the CLS token is always kept. (b*t, 1+N, d) -> (b*t, 1+keep, d)."""
    if prob <= 0.0:
        return x
    cls_tokens, patches = x[:, :1], x[:, 1:]
    num_tokens = patches.shape[1]
    keep = max(1, int(num_tokens * (1.0 - prob)))
    scores = torch.randn((b, num_tokens), generator=generator, device=generator.device)
    idx = scores.topk(keep, dim=-1).indices.to(x.device)  # (b, keep), per video
    idx = idx.repeat_interleave(t, dim=0)  # shared by the frames of a video
    kept = torch.gather(patches, 1, idx[..., None].expand(-1, -1, patches.shape[-1]))
    return torch.cat([cls_tokens, kept], dim=1)


def vision_encode(tower: CLIPVisionTower, pixels: torch.Tensor, cfg: VisionConfig,
                  select_layer: Optional[int] = None, patch_dropout_prob: float = 0.0,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """(B, T, C, H, W) normalised frames -> (B, T, 1+N, D) select-layer features.

    For the video tower T is a multiple of ``cfg.num_frames``; images have T == 1.
    With ``patch_dropout_prob`` > 0 and a ``generator``, N is the kept count.
    """
    b, t, c, h, w = pixels.shape
    vm = tower.vision_model
    layers = vm.encoder.layers
    sel = cfg.select_layer if select_layer is None else select_layer
    n_layers = len(layers) + sel + 1 if sel < 0 else sel
    time_window = cfg.num_frames if (cfg.add_time_attn and t > 1) else 1
    dtype = vm.embeddings.class_embedding.dtype
    x = _embed(vm.embeddings, pixels.reshape(b * t, c, h, w).to(dtype), cfg)
    if patch_dropout_prob > 0.0 and generator is not None:
        x = patch_dropout(x, generator, patch_dropout_prob, b, t)
    x = _layer_norm(vm.pre_layrnorm, x, cfg.layer_norm_eps)
    for layer in layers[:n_layers]:
        x = layer(x, cfg, time_window)
    return x.reshape(b, t, x.shape[-2], x.shape[-1])


def init_vision_params(cfg: VisionConfig, *, seed: int = 0, dtype=torch.float32,
                       device="cpu") -> CLIPVisionTower:
    """Tower with seeded random weights: uniform Linear weights of variance
    1/fan_in, zero biases, small normal embeddings, unit LayerNorms."""
    tower = empty_module(lambda: CLIPVisionTower(cfg), device, dtype)
    g = generator(device, seed)
    d = cfg.hidden_size
    with torch.no_grad():
        for name, p in tower.named_parameters():
            if "norm" in name:
                p.fill_(1.0 if name.endswith("weight") else 0.0)
            elif name.endswith("bias"):
                p.zero_()
            elif name.endswith("patch_embedding.weight") or name.endswith("position_embedding.weight"):
                p.normal_(0.0, 0.02, generator=g)
            elif name.endswith("class_embedding") or name.endswith("temporal_embedding"):
                p.normal_(0.0, d ** -0.5, generator=g)
            else:
                fill_dense_(p, g)
    return tower
