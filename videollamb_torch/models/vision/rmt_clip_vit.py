"""RMT-LanguageBind tower: CLIP ViT with recurrent read-memory tokens.

Port of ``videollamb_tpu/models/vision/rmt_clip_vit.py`` (reference
llava/model/multimodal_encoder/languagebind/rmt_video/modeling_video.py:354-520,
CLIPEncoder with 128 memory tokens prepended to the patch sequence, and
__init__.py:389-524). The reference's own forward cannot run (an
unconditional raise of an undefined name, modeling_video.py:755); the JAX
package implements the evident design, and so does this module:

- per frame step, the encoder runs over ``[read_memories, patch_tokens]``;
  the read memories are the carried memory plus the learned
  ``read_memory_emb`` (first step: the embedding alone, :461-477);
- after the layers, the first M positions are the new memories and the
  rest the frame's features (:512-513);
- a clip runs the recurrence over its frames, an image is one step.

Each step's layers are the port's own CLIP encoder layers
(``clip_vit._encoder_layer``), so the spatial attention of a step runs
kernel K1 at N = M + 1 + patches (385 at ViT-L/14, 224 px, M = 128).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from videollamb_torch.config import VisionConfig
from videollamb_torch.models.seeded import empty_module, generator
from videollamb_torch.models.vision.clip_vit import (
    CLIPVisionTower,
    _embed,
    _encoder_layer,
    init_vision_params,
)
from videollamb_torch.ops.temporal_attention import _layer_norm

NUM_MEMORY_TOKENS = 128  # reference modeling_video.py:371


class EncoderMemory(nn.Module):
    def __init__(self, num_memory_tokens: int, d: int):
        super().__init__()
        self.read_memory_emb = nn.Parameter(torch.empty(num_memory_tokens, d))
        self.memory_tokens = nn.Parameter(torch.empty(num_memory_tokens, d))


class RMTCLIPVisionTower(CLIPVisionTower):
    """The CLIP tower's ``vision_model`` plus ``encoder_memory``."""

    def __init__(self, cfg: VisionConfig, num_memory_tokens: int = NUM_MEMORY_TOKENS):
        super().__init__(cfg)
        self.encoder_memory = EncoderMemory(num_memory_tokens, cfg.hidden_size)


def init_rmt_vision_params(cfg: VisionConfig, *, seed: int = 0, dtype=torch.float32,
                           device="cpu",
                           num_memory_tokens: int = NUM_MEMORY_TOKENS) -> RMTCLIPVisionTower:
    """Seeded tower: the CLIP tower's draw, both memory tables normal(0.02)
    (reference :372-375)."""
    tower = empty_module(lambda: RMTCLIPVisionTower(cfg, num_memory_tokens), device, dtype)
    tower.vision_model = init_vision_params(cfg, seed=seed, dtype=dtype,
                                            device=device).vision_model
    g = generator(device, seed + 1)
    with torch.no_grad():
        for p in tower.encoder_memory.parameters():
            p.normal_(0.0, 0.02, generator=g)
    return tower


def rmt_vision_encode(tower: RMTCLIPVisionTower, pixels: torch.Tensor, cfg: VisionConfig,
                      memories: Optional[torch.Tensor] = None,
                      select_layer: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encode (B, T, C, H, W) with the memory recurrence over frames.

    Returns ((B, T, 1+N, D) features, (B, M, D) final memories); each frame
    reads the memories the previous frame wrote."""
    b, t, c, h, w = pixels.shape
    vm = tower.vision_model
    layers = vm.encoder.layers
    sel = cfg.select_layer if select_layer is None else select_layer
    n_layers = len(layers) + (sel + 1) if sel < 0 else sel
    dtype = vm.embeddings.class_embedding.dtype
    x = _embed(vm.embeddings, pixels.reshape(b * t, c, h, w).to(dtype), cfg)
    x = _layer_norm(vm.pre_layrnorm, x, cfg.layer_norm_eps)
    x = x.reshape(b, t, x.shape[-2], x.shape[-1])
    emb = tower.encoder_memory.read_memory_emb.to(x.dtype)
    m = emb.shape[0]
    # The first frame reads the raw embedding (memories None).
    mem = emb[None].expand(b, m, -1) if memories is None else memories.to(x.dtype) + emb[None]
    feats = []
    for i in range(t):
        y = torch.cat([mem, x[:, i]], dim=1)
        for layer in layers[:n_layers]:
            y = _encoder_layer(layer, y, cfg, time_window=1)
        feats.append(y[:, m:])
        mem = y[:, :m] + emb[None] if i + 1 < t else y[:, :m]
    return torch.stack(feats, dim=1), mem
