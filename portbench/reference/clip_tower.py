"""The LanguageBind video tower: CLIP ViT with a temporal attention per layer.

Follows the LanguageBind video encoder (CLIP ViT-L/14 at 224, HF
``CLIPVisionModel`` with ``add_time_attn``; the reference repository's
``languagebind/video/modeling_video.py``): patchify, class token and
positions, pre-LayerNorm, then per layer

    x = x + temb;  x = x + T-Attn(LN_t(x))         (over the t = 8 frames of a window)
    x = x + S-Attn(LN_1(x))                          (over the 257 tokens of a frame)
    x = x + fc2(quick_gelu(fc1(LN_2(x))))

The temporal embedding is part of the residual stream from then on.
"""

from __future__ import annotations

import torch

from portbench.reference.linear import Weights, layer_norm, quick_gelu, softmax_attention


def _heads(x: torch.Tensor, h: int) -> torch.Tensor:
    """(..., S, D) -> (..., h, S, D / h)."""
    *lead, s, d = x.shape
    return x.reshape(*lead, s, h, d // h).transpose(-3, -2)


def _merge(x: torch.Tensor) -> torch.Tensor:
    *lead, h, s, e = x.shape
    return x.transpose(-3, -2).reshape(*lead, s, h * e)


def _attention(w: Weights, prefix: str, x: torch.Tensor, heads: int) -> torch.Tensor:
    """CLIP attention over the second-to-last axis of x (..., S, D)."""
    e = x.shape[-1] // heads
    q = _heads(w.linear(x, prefix + ".q_proj"), heads)
    k = _heads(w.linear(x, prefix + ".k_proj"), heads)
    v = _heads(w.linear(x, prefix + ".v_proj"), heads)
    return w.linear(_merge(softmax_attention(q, k, v, scale=e ** -0.5)), prefix + ".out_proj")


def embed(w: Weights, root: str, pixels: torch.Tensor, cfg: dict) -> torch.Tensor:
    """(M, 3, H, W) frames -> (M, 1 + N, D): patches, class token, positions."""
    m, c, hh, ww = pixels.shape
    p = cfg["patch_size"]
    gh, gw = hh // p, ww // p
    patches = pixels.float().reshape(m, c, gh, p, gw, p).permute(0, 2, 4, 1, 3, 5)
    patches = patches.reshape(m, gh * gw, c * p * p)
    kernel = w(root + ".embeddings.patch_embedding.weight")
    x = w.matmul(patches, kernel.reshape(kernel.shape[0], -1))
    cls = w(root + ".embeddings.class_embedding").expand(m, 1, -1)
    x = torch.cat([cls, x], dim=1)
    return x + w(root + ".embeddings.position_embedding.weight")[None]


def layer(w: Weights, prefix: str, x: torch.Tensor, cfg: dict, window: int) -> torch.Tensor:
    """One encoder layer on (M, N, D); M is a multiple of ``window`` frames."""
    m, n, d = x.shape
    eps = cfg["layer_norm_eps"]
    heads = cfg["num_attention_heads"]
    if cfg["add_time_attn"] and window > 1:
        xt = x.reshape(m // window, window, n, d)
        xt = xt + w(prefix + ".temporal_embedding").reshape(-1, d)[:window][None, :, None]
        # Attention across the frames of each (window, position): frames on the
        # second-to-last axis.
        normed = layer_norm(xt, w, prefix + ".temporal_layer_norm1", eps).transpose(1, 2)
        out = _attention(w, prefix + ".temporal_attn", normed, heads).transpose(1, 2)
        x = (xt + out).reshape(m, n, d)
    x = x + _attention(w, prefix + ".self_attn", layer_norm(x, w, prefix + ".layer_norm1", eps),
                       heads)
    h = layer_norm(x, w, prefix + ".layer_norm2", eps)
    return x + w.linear(quick_gelu(w.linear(h, prefix + ".mlp.fc1")), prefix + ".mlp.fc2")


def encode(w: Weights, root: str, pixels: torch.Tensor, cfg: dict, n_layers: int,
           chunk_frames: int = 64) -> torch.Tensor:
    """(B, T, 3, H, W) -> (B, T, 1 + N, D) after ``n_layers`` layers (no post-LN).

    Frames go through in chunks of whole temporal windows: a window's frames
    and a frame's tokens never mix with others, so chunking changes nothing."""
    b, t = pixels.shape[:2]
    window = cfg["num_frames"] if (cfg["add_time_attn"] and t > 1) else 1
    frames = pixels.reshape(b * t, *pixels.shape[2:])
    step = max(window, chunk_frames // window * window)
    outs = []
    for lo in range(0, b * t, step):
        x = embed(w, root, frames[lo:lo + step], cfg)
        x = layer_norm(x, w, root + ".pre_layrnorm", cfg["layer_norm_eps"])
        for i in range(n_layers):
            x = layer(w, f"{root}.encoder.layers.{i}", x, cfg, window)
        outs.append(x)
    x = torch.cat(outs)
    return x.reshape(b, t, *x.shape[1:])
