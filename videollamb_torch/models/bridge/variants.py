"""The non-RMT-R projector family.

Port of ``videollamb_tpu/models/bridge/variants.py`` (reference
llava/model/multimodal_projector/): identity, linear, mlp{N}x_gelu,
transformer{N}x (3-D pooled), mlp_transformer{N}x, rmt_transformer{N}x
(recurrence without retrieval), the rmt_r_transformer cap variant (k = 7,
raw patches, detached memory cache), spatial_pool, a BLIP-2-style Q-Former
and the retention projector.

Each kind is an ``nn.Module`` whose parameter names are the leaf names of
the JAX package's ``init_bridge_params`` tree (``{kernel, bias}`` is a
Linear, ``{scale, bias}`` a LayerNorm, lists are ModuleLists; the bridge
layers' ``mlp.dense`` / the RMT projector's ``proj.dense`` are ``mlp.0`` /
``proj.0``, as in ``models/bridge/rmt_r.py``), so ``models/convert.py``
carries a tree either way by name. Video forwards take one video's (t, n, d)
tower features (CLS + patches) and return (tokens, mask); the dispatch over
kinds and modalities is ``models/bridge/builder.bridge_apply``.

As in the JAX package these forwards have no dropout: it calls their
transformer layers without dropout rates and their projector passes without
a key. Only the RMT-R bridge (``rmt_r.py``) trains with dropout.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from videollamb_torch.config import BridgeConfig
from videollamb_torch.models.bridge.layers import (
    Residual,
    TransformerLayer,
    _act,
    _dense,
    attention,
    transformer_layer,
)
from videollamb_torch.models.bridge.rmt_r import (
    RMTRBridge,
    TransformerProjector,
    pool_and_split,
    projector_pass,
    retrieve,
)
from videollamb_torch.ops.pooling import adaptive_avg_pool_2d, pool_frame_tokens
from videollamb_torch.ops.scene_tilling import segment_plan, segment_topk

Tokens = Tuple[torch.Tensor, torch.Tensor]


def _ones(tokens: torch.Tensor) -> torch.Tensor:
    return torch.ones(tokens.shape[:1], dtype=torch.bool, device=tokens.device)


# ---------------------------------------------------------------------------
# Modules (parameter trees)
# ---------------------------------------------------------------------------


class NoParams(nn.Module):
    """identity and spatial_pool: no parameters."""


class LinearProjector(nn.Module):
    def __init__(self, cfg: BridgeConfig, lm_d: int):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, lm_d)


class MLPProjector(nn.Module):
    """mlp{N}x_gelu: Linear(mm -> lm) then (N-1) x [GELU, Linear(lm -> lm)]
    (reference multimodal_projector/builder.py:41-48)."""

    def __init__(self, cfg: BridgeConfig, lm_d: int):
        super().__init__()
        self.layers = nn.ModuleList(
            [nn.Linear(cfg.hidden_size, lm_d)]
            + [nn.Linear(lm_d, lm_d) for _ in range(1, cfg.mlp_depth)])


def _two_layer_mlp(d_in: int, lm_d: int) -> nn.ModuleDict:
    return nn.ModuleDict({"fc1": nn.Linear(d_in, lm_d), "fc2": nn.Linear(lm_d, lm_d)})


class TransformerPooledProjector(nn.Module):
    """transformer{N}x: bridge layers at the tower width, then a projection."""

    def __init__(self, cfg: BridgeConfig, lm_d: int):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerLayer(cfg.hidden_size, cfg.intermediate_size) for _ in range(cfg.depth))
        self.proj = nn.ModuleDict({"dense": nn.Linear(cfg.hidden_size, lm_d)})


class MLPTransformerProjector(nn.Module):
    """mlp_transformer{N}x: a 2-layer GELU MLP to the LM width, then bridge
    layers at the LM width."""

    def __init__(self, cfg: BridgeConfig, lm_d: int):
        super().__init__()
        self.proj = _two_layer_mlp(cfg.hidden_size, lm_d)
        self.layers = nn.ModuleList(
            TransformerLayer(lm_d, cfg.intermediate_size) for _ in range(cfg.depth))


class ProjectorOnly(nn.Module):
    """rmt_transformer and retention: the RMT-R projector without retrieval."""

    def __init__(self, cfg: BridgeConfig, lm_d: int):
        super().__init__()
        self.projector = TransformerProjector(cfg, lm_d)


class QFormerProjector(nn.Module):
    def __init__(self, cfg: BridgeConfig, lm_d: int):
        super().__init__()
        self.query_tokens = nn.Parameter(torch.empty(cfg.qformer_queries, cfg.hidden_size))
        self.layers = nn.ModuleList(
            TransformerLayer(cfg.hidden_size, cfg.intermediate_size)
            for _ in range(cfg.qformer_layers))
        self.proj = _two_layer_mlp(cfg.hidden_size, lm_d)


class RetentionAttention(nn.Module):
    """The reference's Retention layer (retent_transformer_projector.py:40-70).
    ``g_proj`` / ``output_proj`` are never used by its forward and kept for
    state-dict parity; its group norm has no parameters."""

    def __init__(self, d: int):
        super().__init__()
        for name in ("q_proj", "k_proj", "v_proj", "g_proj", "output_proj"):
            setattr(self, name, nn.Linear(d, d))
        self.residual = Residual(d, d)


# ---------------------------------------------------------------------------
# Forwards
# ---------------------------------------------------------------------------


def identity_forward(module: nn.Module, cfg: BridgeConfig, x: torch.Tensor) -> torch.Tensor:
    return x


def linear_forward(module: LinearProjector, cfg: BridgeConfig,
                   x: torch.Tensor) -> torch.Tensor:
    return _dense(module.dense, x)


def mlp_forward(module: MLPProjector, cfg: BridgeConfig, x: torch.Tensor) -> torch.Tensor:
    x = _dense(module.layers[0], x)
    for layer in module.layers[1:]:
        x = _dense(layer, F.gelu(x))
    return x


def _run_layers(layers: nn.ModuleList, cfg: BridgeConfig, x: torch.Tensor,
                encoder_hidden: Optional[torch.Tensor] = None) -> torch.Tensor:
    for layer in layers:
        x = transformer_layer(layer, x, num_heads=cfg.num_attention_heads,
                              eps=cfg.layer_norm_eps, act=cfg.hidden_act,
                              encoder_hidden=encoder_hidden)
    return x


def _strip_cls(features: torch.Tensor) -> torch.Tensor:
    """Drop CLS when the tokens are 1 + k^2 (the transformer variants take
    CLS-free inputs)."""
    n = features.shape[-2]
    grid = int(round((n - 1) ** 0.5))
    return features[..., 1:, :] if grid * grid == n - 1 else features


def transformer_video_forward(module: TransformerPooledProjector, cfg: BridgeConfig,
                              features: torch.Tensor, pool_t: int = 4) -> Tokens:
    """Video: 3-D adaptive pool to (pool_t, pool_h, pool_w) tokens (a
    temporal pool, then a spatial one), the layers, the projection
    (reference transformer_projector.py:226-240)."""
    patches = _strip_cls(features)  # (t, n, d)
    t, n, d = patches.shape
    grid = int(round(n ** 0.5))
    x = patches.reshape(t, grid, grid, d).permute(3, 0, 1, 2)  # (d, t, g, g)
    x = adaptive_avg_pool_2d(x.reshape(d, t, grid * grid), (pool_t, grid * grid))
    x = adaptive_avg_pool_2d(x.reshape(d, pool_t, grid, grid), (cfg.pool_h, cfg.pool_w))
    x = x.permute(1, 2, 3, 0).reshape(1, pool_t * cfg.pool_h * cfg.pool_w, d)
    x = _run_layers(module.layers, cfg, x)
    tokens = _act(cfg.hidden_act, _dense(module.proj["dense"], x))[0]
    return tokens, _ones(tokens)


def transformer_image_forward(module: TransformerPooledProjector, cfg: BridgeConfig,
                              features: torch.Tensor) -> torch.Tensor:
    """Image (b, n, d): 2-D pool to pool_h x pool_w, the layers, the projection."""
    patches = _strip_cls(features)
    pooled = pool_frame_tokens(patches, int(round(patches.shape[-2] ** 0.5)),
                               cfg.pool_h, cfg.pool_w)
    x = _run_layers(module.layers, cfg, pooled)
    return _act(cfg.hidden_act, _dense(module.proj["dense"], x))


def mlp_transformer_forward(module: MLPTransformerProjector, cfg: BridgeConfig,
                            features: torch.Tensor) -> Tokens:
    """Per frame: MLP to the LM width, pool to pool_h x pool_w, the layers
    (reference mlp_transformer_projector.py:212-255).
    (t, n, d) -> (t * pool_h * pool_w, lm_d)."""
    patches = _strip_cls(features)
    x = _dense(module.proj["fc2"], F.gelu(_dense(module.proj["fc1"], patches)))
    pooled = pool_frame_tokens(x, int(round(x.shape[-2] ** 0.5)), cfg.pool_h, cfg.pool_w)
    out = _run_layers(module.layers, cfg, pooled)
    tokens = out.reshape(-1, out.shape[-1])
    return tokens, _ones(tokens)


def _segments(patches: torch.Tensor, bounds: torch.Tensor, max_frames: int):
    """(t, p, d) per-frame tokens and the segment ends -> the segments'
    tokens (S, max_frames * p, d), padded frames zeroed, and their mask."""
    s, (_, p, d) = bounds.shape[0], patches.shape
    frame_idx, frame_mask = segment_plan(bounds, max_frames=max_frames)
    seg_mask = frame_mask.repeat_interleave(p, dim=1)
    seg_tokens = patches[frame_idx].reshape(s, max_frames * p, d)
    return torch.where(seg_mask[..., None], seg_tokens, 0.0).to(patches.dtype), seg_mask


def _recurrence(projector: TransformerProjector, cfg: BridgeConfig,
                seg_tokens: torch.Tensor, seg_mask: torch.Tensor) -> Tokens:
    """Memory recurrence without retrieval over the segments in order; the
    first reads ``read_memory_emb``. Returns the final segment's projected
    tokens and mask."""
    mem = projector.read_memory_emb[None].to(seg_tokens.dtype)
    for step in range(seg_tokens.shape[0]):
        proj, mem = projector_pass(projector, cfg, seg_tokens[step][None],
                                   seg_mask[step][None], mem)
    return proj[0], seg_mask[-1]


def rmt_video_forward(module: ProjectorOnly, cfg: BridgeConfig, features: torch.Tensor,
                      max_frames: int = 4) -> Tokens:
    """rmt_transformer: pooled frames, SceneTilling's top-k segments of at
    most ``max_frames`` subsampled frames, memory recurrence without
    retrieval (reference rmt_transformer_projector.py:336-361)."""
    cls_states, pooled = pool_and_split(features, cfg)
    bounds = segment_topk(cls_states, k=cfg.segment_topk)
    seg_tokens, seg_mask = _segments(pooled, bounds, max_frames)
    return _recurrence(module.projector, cfg, seg_tokens, seg_mask)


def rmt_r_cap_video_forward(bridge: RMTRBridge, cfg: BridgeConfig, features: torch.Tensor,
                            topk: int = 7, max_frames: int = 4
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The caption / RMT-loss variant (reference
    rmt_r_transformer_cap_projector.py:275-416): k = 7 segments of RAW
    patches, at most ``max_frames`` frames each, the memory cache and every
    segment's output detached, retrieval after each step. Keeps the
    reference's CLS read from token 1 (:326).

    Returns every segment's tokens (S, max_frames * (n-1), lm_d) and masks."""
    s = topk + 1
    m = cfg.num_memory_tokens
    d = features.shape[-1]
    bounds = segment_topk(features[:, 1], k=topk)
    seg_tokens, seg_mask = _segments(features[:, 1:], bounds, max_frames)
    projector = bridge.projector
    mem = projector.read_memory_emb[None].to(seg_tokens.dtype)
    slots = torch.arange(s * m, device=features.device)
    entries, outs = [], []
    for step in range(s):
        proj, mem_out = projector_pass(projector, cfg, seg_tokens[step][None],
                                       seg_mask[step][None], mem)
        entries.append(mem_out.detach())
        cache = torch.cat(entries + [mem_out.new_zeros((1, (s - step - 1) * m, d))], dim=1)
        mem = retrieve(bridge.retrieval, cfg, mem_out, cache, (slots < (step + 1) * m)[None])
        outs.append(proj[0].detach())
    return torch.stack(outs), seg_mask


def spatial_pool_forward(module: nn.Module, cfg: BridgeConfig, features: torch.Tensor,
                         mode: str = "average", stride: int = 2) -> Tokens:
    """Stride-pool the patch tokens on their grid (reference
    spatial_pool_projector.py:6-53): (t, n, d) or (n, d) -> (t * (g/s)^2, d),
    at the tower's width (a resampler, not an LM projector)."""
    x = features if features.dim() == 3 else features[None]
    patches = _strip_cls(x)
    t, n, d = patches.shape
    grid = int(round(n ** 0.5))
    g = patches.reshape(t, grid // stride, stride, grid // stride, stride, d)
    if mode == "average":
        pooled = g.mean(dim=(2, 4))
    elif mode == "max":
        pooled = g.amax(dim=(2, 4))
    else:
        raise ValueError(f"Unknown pooling mode: {mode}")
    tokens = pooled.reshape(-1, d)
    return tokens, _ones(tokens)


def qformer_forward(module: QFormerProjector, cfg: BridgeConfig,
                    features: torch.Tensor) -> Tokens:
    """Learned queries self-attend and cross-attend the flattened features
    each layer, then a 2-layer GELU MLP projects them to the LM width
    (reference qformer_projector.py:12-92). features (t, n, d) or (n, d)."""
    features = features.reshape(1, -1, features.shape[-1])
    q = module.query_tokens[None].to(features.dtype)
    q = _run_layers(module.layers, cfg, q, encoder_hidden=features)
    tokens = _dense(module.proj["fc2"], F.gelu(_dense(module.proj["fc1"], q)))[0]
    return tokens, _ones(tokens)


def retention_video_forward(module: ProjectorOnly, cfg: BridgeConfig,
                            features: torch.Tensor) -> Tokens:
    """Reference retent_transformer_projector.py:429-455: CLS read from
    token 1, token 0 dropped, SceneTilling's top-k segments with every frame
    (no subsample), memory recurrence without retrieval, the final segment's
    tokens."""
    t = features.shape[0]
    bounds = segment_topk(features[:, 1], k=cfg.segment_topk)
    seg_tokens, seg_mask = _segments(features[:, 1:], bounds, t)
    return _recurrence(module.projector, cfg, seg_tokens, seg_mask)


def retention_image_forward(module: ProjectorOnly, cfg: BridgeConfig,
                            img: torch.Tensor) -> Tokens:
    """(1, n, d): every token (CLS kept, no pooling), one projector pass
    reading ``read_memory_emb`` (:417-428)."""
    emb = module.projector.read_memory_emb[None].to(img.dtype)
    proj, _ = projector_pass(module.projector, cfg, img, None, emb)
    return proj[0], _ones(proj[0])


def retention_attention(p: RetentionAttention, hidden: torch.Tensor, *, num_heads: int,
                        eps: float, encoder_hidden: Optional[torch.Tensor] = None,
                        key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Retention.forward (retent_transformer_projector.py:78-145): plain
    softmax attention into the Residual block; the gate, ``output_proj`` and
    the group norm are never applied."""
    return attention(p, hidden, num_heads=num_heads, eps=eps,
                     encoder_hidden=encoder_hidden, key_mask=key_mask)


def init_retention_attention(d: int, *, seed: int = 0, dtype=torch.float32,
                             device="cpu") -> RetentionAttention:
    """Seeded Retention layer: xavier-uniform weights of gain 2^-2.5
    (``output_proj`` 2^-1), biases uniform in +-sqrt(1/d), unit LayerNorm."""
    from videollamb_torch.models.seeded import empty_module, generator

    module = empty_module(lambda: RetentionAttention(d), device, dtype)
    g = generator(device, seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.startswith("residual.layernorm"):
                p.fill_(1.0 if name.endswith("weight") else 0.0)
            elif name.endswith("bias"):
                p.uniform_(-math.sqrt(1.0 / d), math.sqrt(1.0 / d), generator=g)
            else:
                gain = 2 ** -1 if name.startswith("output_proj") else 2 ** -2.5
                limit = gain * math.sqrt(6.0 / (d + d))
                p.uniform_(-limit, limit, generator=g)
    return module
