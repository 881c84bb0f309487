"""LanguageBind's video embedding (``LanguageBind_Video_merge``).

The tower's every layer, the class token of each frame averaged over the
clip's frames, the post-LayerNorm, the bias-free projection to the joint
space, L2 normalisation and the learned temperature (HF
``CLIPVisionModelWithProjection`` pooling; the reference repository's
``languagebind/__init__.py:79-88``).
"""

from __future__ import annotations

import torch

from portbench.reference import clip_tower
from portbench.reference.linear import Weights, layer_norm


def embed_video(w: Weights, cfg: dict, pixels: torch.Tensor, root: str = "modalities.video"
                ) -> torch.Tensor:
    """(B, T, 3, H, W) -> (B, projection_dim) float32 embeddings."""
    vis = cfg["vision"]
    feats = clip_tower.encode(w, root + ".tower.vision_model", pixels, vis,
                              vis["num_hidden_layers"])
    pooled = layer_norm(feats[:, :, 0].mean(dim=1), w, root + ".tower.vision_model.post_layernorm",
                        vis["layer_norm_eps"])
    emb = w.linear(pooled, root + ".projection", bias=False)
    emb = emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
    return emb * torch.exp(w(root + ".logit_scale"))
