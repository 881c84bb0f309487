"""Memory Bridge building blocks: post-LN attention and transformer layers.

Port of ``videollamb_tpu/models/bridge/layers.py`` (reference
rmt_r_transformer_projector.py:13-184 and self_retriever.py:10-186).
Module names follow the reference (``q_proj``, ``residual.dense``,
``residual.layernorm``, ``mlp.0``) so its state dicts load by name.

Masking adds a -1e30 bias to disallowed keys (it does not replace their
scores), the activation is the exact-erf GELU, and LayerNorm statistics are
f32 with the bridge's eps (1e-12 in the reference config). Every dense layer
runs in its input's dtype (``_dense`` casts the weight, as the JAX
``_dense`` does), so f32 trainable weights serve bf16 tower features.

Training-mode dropout (``hidden_dropout_prob`` after each residual dense,
``attention_probs_dropout_prob`` on the attention probabilities) is on when
the caller passes a ``torch.Generator``, from which every mask is drawn; with
no generator the layers are deterministic.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from videollamb_torch.ops.temporal_attention import _layer_norm

NEG_INF = -1e30


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "gelu":  # HF 'gelu' is the exact erf GELU
        return F.gelu(x)
    if name == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    raise NotImplementedError(f"bridge activation {name!r}")


class Residual(nn.Module):
    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.dense = nn.Linear(d_in, d_out)
        self.layernorm = nn.LayerNorm(d_out)


class Attention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.residual = Residual(d, d)


class TransformerLayer(nn.Module):
    """Projector layer: self-attn, cross-attn (the Q-Former's only), MLP."""

    def __init__(self, d: int, inter: int):
        super().__init__()
        self.selfattention = Attention(d)
        self.crossattention = Attention(d)
        self.mlp = nn.Sequential(nn.Linear(d, inter))
        self.residual = Residual(inter, d)


class RetrieverLayer(nn.Module):
    """Retriever layer: attention modules only (reference self_retriever.py:115-131)."""

    def __init__(self, d: int):
        super().__init__()
        self.selfattention = Attention(d)
        self.crossattention = Attention(d)


def _dense(linear: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``linear`` in x's dtype (the weight and bias cast to it)."""
    return F.linear(x, linear.weight.to(x.dtype), linear.bias.to(x.dtype))


def _dropout(x: torch.Tensor, rate: float,
             generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout: zero with probability ``rate``, scale the rest by
    1 / (1 - rate). The identity without a generator or at rate 0."""
    if generator is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0).to(x.dtype)


def residual_block(p: Residual, hidden: torch.Tensor, inputs: torch.Tensor, *,
                   eps: float, dropout_rate: float = 0.0,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """dense -> dropout -> LayerNorm(x + inputs) (reference Residual)."""
    h = _dropout(_dense(p.dense, hidden), dropout_rate, generator)
    return _layer_norm(p.layernorm, h + inputs, eps)


def attention(p: Attention, hidden: torch.Tensor, *, num_heads: int, eps: float,
              encoder_hidden: Optional[torch.Tensor] = None,
              key_mask: Optional[torch.Tensor] = None, attn_dropout: float = 0.0,
              hidden_dropout: float = 0.0,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Post-LN multi-head attention; self-attention when ``encoder_hidden`` is None.

    ``key_mask`` (b, K) True-for-valid becomes an additive -1e30 bias.
    """
    b, q_len, d = hidden.shape
    e = d // num_heads
    kv_src = hidden if encoder_hidden is None else encoder_hidden

    def split(x):
        return x.reshape(b, x.shape[1], num_heads, e).transpose(1, 2)

    q = split(_dense(p.q_proj, hidden))
    k = split(_dense(p.k_proj, kv_src))
    v = split(_dense(p.v_proj, kv_src))
    scores = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(e)
    if key_mask is not None:
        bias = torch.where(key_mask.bool(), 0.0, NEG_INF).float()
        scores = scores + bias[:, None, None, :]
    probs = _dropout(torch.softmax(scores, dim=-1), attn_dropout, generator).to(v.dtype)
    out = (probs.float() @ v.float()).to(hidden.dtype)
    out = out.transpose(1, 2).reshape(b, q_len, d)
    return residual_block(p.residual, out, hidden, eps=eps, dropout_rate=hidden_dropout,
                          generator=generator)


def transformer_layer(p: TransformerLayer, hidden: torch.Tensor, *, num_heads: int,
                      eps: float, act: str, key_mask: Optional[torch.Tensor] = None,
                      encoder_hidden: Optional[torch.Tensor] = None,
                      encoder_key_mask: Optional[torch.Tensor] = None,
                      attn_dropout: float = 0.0, hidden_dropout: float = 0.0,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Self-attention [+ cross-attention over ``encoder_hidden``, the
    Q-Former's] + GELU MLP with residual projection."""
    h = attention(p.selfattention, hidden, num_heads=num_heads, eps=eps, key_mask=key_mask,
                  attn_dropout=attn_dropout, hidden_dropout=hidden_dropout,
                  generator=generator)
    if encoder_hidden is not None:
        h = attention(p.crossattention, h, num_heads=num_heads, eps=eps,
                      encoder_hidden=encoder_hidden, key_mask=encoder_key_mask,
                      attn_dropout=attn_dropout, hidden_dropout=hidden_dropout,
                      generator=generator)
    inter = _act(act, _dense(p.mlp[0], h))
    return residual_block(p.residual, inter, h, eps=eps, dropout_rate=hidden_dropout,
                          generator=generator)


def cross_only_layer(p: RetrieverLayer, hidden: torch.Tensor, *, num_heads: int,
                     eps: float, encoder_hidden: torch.Tensor,
                     encoder_key_mask: Optional[torch.Tensor] = None,
                     attn_dropout: float = 0.0, hidden_dropout: float = 0.0,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Retriever layer: cross-attention only (self_retriever.py:147-186)."""
    return attention(p.crossattention, hidden, num_heads=num_heads, eps=eps,
                     encoder_hidden=encoder_hidden, key_mask=encoder_key_mask,
                     attn_dropout=attn_dropout, hidden_dropout=hidden_dropout,
                     generator=generator)
