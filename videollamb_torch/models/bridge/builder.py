"""Projector factory: typed dispatch over the whole projector family.

Port of ``videollamb_tpu/models/bridge/builder.py`` (reference name-string
factory, llava/model/multimodal_projector/builder.py:13-53), driven by
:class:`videollamb_torch.config.BridgeConfig` (``from_projector_type``
parses the reference's names). :func:`init_bridge_params` builds a seeded
module of any kind; :func:`bridge_apply` runs one sample's tower features
through it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from videollamb_torch.config import BridgeConfig
from videollamb_torch.models.bridge import variants as v
from videollamb_torch.models.bridge.rmt_r import (
    RMTRBridge,
    fill_bridge_,
    rmt_r_image_forward,
    rmt_r_video_forward,
)
from videollamb_torch.models.seeded import empty_module, generator

RMT_R = "rmt_r_transformer"

MODULES = {
    "identity": lambda cfg, lm_d: v.NoParams(),
    "spatial_pool": lambda cfg, lm_d: v.NoParams(),
    "linear": v.LinearProjector,
    "mlp": v.MLPProjector,
    "transformer": v.TransformerPooledProjector,
    "mlp_transformer": v.MLPTransformerProjector,
    "rmt_transformer": v.ProjectorOnly,
    RMT_R: RMTRBridge,
    "rmt_r_transformer_cap": RMTRBridge,
    "qformer": v.QFormerProjector,
    # The reference's retent_transformer_projector.py, which its factory
    # never registers; see the retention section of variants.py.
    "retention": v.ProjectorOnly,
}


def bridge_module(cfg: BridgeConfig, lm_hidden_size: int) -> nn.Module:
    """The (uninitialised) module of ``cfg.kind``."""
    if cfg.kind not in MODULES:
        raise ValueError(f"Unknown projector kind: {cfg.kind!r}")
    return MODULES[cfg.kind](cfg, lm_hidden_size)


def init_bridge_params(cfg: BridgeConfig, lm_hidden_size: int, *, seed: int = 0,
                       dtype=torch.float32, device="cpu") -> nn.Module:
    """A projector of ``cfg.kind`` with seeded random weights
    (:func:`~videollamb_torch.models.bridge.rmt_r.fill_bridge_`)."""
    return fill_bridge_(empty_module(lambda: bridge_module(cfg, lm_hidden_size), device, dtype),
                        generator(device, seed))


def bridge_token_count(cfg: BridgeConfig, n_tokens: int, frames: int,
                       modality: str = "video") -> int:
    """Tokens :func:`bridge_apply` returns for one sample of ``frames`` frames
    (1 for an image) of ``n_tokens`` tower tokens each (CLS included), from
    the shapes alone (the JAX package traces the encoder for it)."""
    kind, pooled = cfg.kind, cfg.tokens_per_frame
    image = modality == "image"
    t = 1 if image else frames
    grid = int(round((n_tokens - 1) ** 0.5))
    patches = grid * grid if grid * grid == n_tokens - 1 else n_tokens  # _strip_cls
    if kind in ("identity", "linear", "mlp"):
        return t * n_tokens
    if kind == "transformer":
        return pooled if image else 4 * pooled
    if kind == "mlp_transformer":
        return t * pooled
    if kind == "rmt_transformer":
        return pooled if image else 4 * pooled
    if kind == RMT_R:
        return pooled if image else cfg.tokens_per_segment
    if kind == "qformer":
        return cfg.qformer_queries
    if kind == "retention":
        return n_tokens if image else frames * (n_tokens - 1)
    if kind == "spatial_pool":
        return t * (int(round(patches ** 0.5)) // 2) ** 2
    raise ValueError(f"no single token count for projector kind {kind!r}")


def bridge_apply(module: nn.Module, cfg: BridgeConfig, features: torch.Tensor, *,
                 modality: str = "video",
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run ONE sample's tower features through the projector of ``cfg.kind``.

    modality 'video': features (t, n, d), one video's frames;
    modality 'image': features (n, d), one image.

    Returns (tokens (N_tok, lm_d), mask (N_tok,)); ``spatial_pool`` keeps the
    tower's width and ``rmt_r_transformer_cap`` returns every segment's
    (S, N, lm_d) tokens. ``generator`` turns on the RMT-R bridge's dropout,
    the only kind that has any (as in the JAX package)."""
    kind = cfg.kind
    img = features[None] if modality == "image" and features.dim() == 2 else None

    if kind in ("identity", "linear", "mlp"):
        fwd = {"identity": v.identity_forward, "linear": v.linear_forward,
               "mlp": v.mlp_forward}[kind]
        tokens = fwd(module, cfg, features)
        tokens = tokens.reshape(-1, tokens.shape[-1])
        return tokens, v._ones(tokens)
    if kind == "transformer":
        if modality == "image":
            tokens = v.transformer_image_forward(module, cfg, img)[0]
            return tokens, v._ones(tokens)
        return v.transformer_video_forward(module, cfg, features)
    if kind == "mlp_transformer":
        return v.mlp_transformer_forward(module, cfg, img if img is not None else features)
    if kind in ("rmt_transformer", RMT_R):
        if modality == "image":  # one pass of the projector (no retrieval)
            tokens, _ = rmt_r_image_forward(module, cfg, img)
            return tokens[0], v._ones(tokens[0])
        if kind == "rmt_transformer":
            return v.rmt_video_forward(module, cfg, features)
        out = rmt_r_video_forward(module, cfg, features, generator)
        return out.tokens, out.token_mask
    if kind == "rmt_r_transformer_cap":
        return v.rmt_r_cap_video_forward(module, cfg, features)
    if kind == "qformer":
        return v.qformer_forward(module, cfg, features)
    if kind == "retention":
        if modality == "image":
            return v.retention_image_forward(module, cfg, img)
        return v.retention_video_forward(module, cfg, features)
    if kind == "spatial_pool":
        return v.spatial_pool_forward(module, cfg, features)
    raise ValueError(f"Unknown projector kind: {kind!r}")
