"""Rotary position embeddings, Llama convention (rotate_half, non-interleaved).

Port of ``videollamb_tpu/models/lm/rope.py``: inverse frequencies
theta^(-2i/d), optionally scaled for long contexts (``linear``, ``dynamic``,
``llama3``; HF ``ROPE_INIT_FUNCTIONS`` parity), f32 tables, applied in f32
and cast back.
"""

from __future__ import annotations

import math

import torch


def rope_frequencies(head_dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponents)


def scaled_rope_frequencies(head_dim: int, theta: float = 10000.0, scaling=None,
                            max_position_embeddings: int = 0, device=None) -> torch.Tensor:
    """(head_dim/2,) inverse frequencies with optional long-context scaling.

    ``scaling`` is a :class:`videollamb_torch.config.RopeScaling`. 'dynamic'
    keeps the JAX package's one static table: HF recomputes the NTK base per
    sequence length, and the table here is computed at
    ``max(target_length or max_position_embeddings, max_position_embeddings)``,
    where HF's formula reduces to the unscaled base for every sequence up to
    the trained maximum (set ``RopeScaling.target_length`` to pin it for a
    longer context; the two then agree at that length)."""
    inv = rope_frequencies(head_dim, theta, device)
    if scaling is None:
        return inv
    t = scaling.rope_type
    if t == "linear":
        return inv / scaling.factor
    if t == "dynamic":
        maxpos = max_position_embeddings or scaling.original_max_position_embeddings
        seq_len = max(scaling.target_length or maxpos, maxpos)
        base = theta * ((scaling.factor * seq_len / maxpos) - (scaling.factor - 1)) ** (
            head_dim / (head_dim - 2))
        return rope_frequencies(head_dim, base, device)
    if t == "llama3":
        # Long wavelengths scale by 1/factor, short ones keep, the band between blends.
        old_len = scaling.original_max_position_embeddings
        low_wl = old_len / scaling.low_freq_factor
        high_wl = old_len / scaling.high_freq_factor
        wavelen = 2.0 * math.pi / inv
        smooth = (old_len / wavelen - scaling.low_freq_factor) / (
            scaling.high_freq_factor - scaling.low_freq_factor)
        blended = (1.0 - smooth) / scaling.factor * inv + smooth * inv
        out = torch.where(wavelen > low_wl, inv / scaling.factor, inv)
        is_mid = (wavelen <= low_wl) & (wavelen >= high_wl)
        return torch.where(is_mid, blended, out)
    raise ValueError(f"unsupported rope_scaling type {t!r} (have: linear, dynamic, llama3)")


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float = 10000.0,
                 scaling=None, max_position_embeddings: int = 0):
    """(...,) int positions -> cos, sin of shape (..., head_dim), f32."""
    inv = scaled_rope_frequencies(head_dim, theta, scaling, max_position_embeddings,
                                  positions.device)
    angles = positions.float()[..., None] * inv
    emb = torch.cat([angles, angles], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def rope_cos_sin_cfg(cfg, positions: torch.Tensor):
    """:func:`rope_cos_sin` from a LlamaConfig (head_dim, rope_theta, optional
    rope_scaling, max_position_embeddings)."""
    return rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta,
                        scaling=getattr(cfg, "rope_scaling", None),
                        max_position_embeddings=cfg.max_position_embeddings)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (..., seq, heads, head_dim); cos/sin (..., seq, head_dim)."""
    cos = cos[..., :, None, :]
    sin = sin[..., :, None, :]
    xf = x.float()
    return (xf * cos + _rotate_half(xf) * sin).to(x.dtype)
