"""MPT backbone (ALiBi attention, bias-free LayerNorm and Linear).

Port of ``videollamb_tpu/models/lm/mpt.py`` (reference LlavaMptForCausalLM,
llava/model/language_model/llava_mpt.py:40, a thin LLaVA wrapper over HF
MPT, kept for checkpoint compatibility): ALiBi position bias instead of
RoPE, packed ``Wqkv``, tanh-GELU FFN, ``lm_head`` tied to ``wte``. Module
names follow the HF state dict (``transformer.blocks.N.attn.Wqkv``), so
:func:`convert_mpt_state_dict` only settles the root prefix.

Plain PyTorch, as the JAX module is plain XLA: no kernel, and no entry point
serves it (the JAX package has none either).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from videollamb_torch.models.seeded import empty_module, generator

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class MptConfig:
    """MPT-7B's ``MptConfig`` defaults."""

    vocab_size: int = 50432
    d_model: int = 4096
    n_heads: int = 32
    n_layers: int = 32
    expansion_ratio: int = 4
    max_seq_len: int = 2048
    layer_norm_epsilon: float = 1e-5
    alibi_bias_max: int = 8

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


class _Norm(nn.Module):  # LayerNorm without a bias
    def __init__(self, d: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d))


class MptAttention(nn.Module):
    def __init__(self, cfg: MptConfig):
        super().__init__()
        self.Wqkv = nn.Linear(cfg.d_model, 3 * cfg.d_model, bias=False)
        self.out_proj = nn.Linear(cfg.d_model, cfg.d_model, bias=False)


class MptMLP(nn.Module):
    def __init__(self, cfg: MptConfig):
        super().__init__()
        inner = cfg.expansion_ratio * cfg.d_model
        self.up_proj = nn.Linear(cfg.d_model, inner, bias=False)
        self.down_proj = nn.Linear(inner, cfg.d_model, bias=False)


class MptBlock(nn.Module):
    def __init__(self, cfg: MptConfig):
        super().__init__()
        self.norm_1 = _Norm(cfg.d_model)
        self.attn = MptAttention(cfg)
        self.norm_2 = _Norm(cfg.d_model)
        self.ffn = MptMLP(cfg)


class MptModel(nn.Module):
    def __init__(self, cfg: MptConfig):
        super().__init__()
        self.wte = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.blocks = nn.ModuleList(MptBlock(cfg) for _ in range(cfg.n_layers))
        self.norm_f = _Norm(cfg.d_model)


class MptForCausalLM(nn.Module):
    def __init__(self, cfg: MptConfig):
        super().__init__()
        self.transformer = MptModel(cfg)


def alibi_slopes(n_heads: int, bias_max: int = 8) -> np.ndarray:
    """HF ``build_mpt_alibi_tensor`` slopes: powers of 2 over the head count
    rounded up to a power of two, subsampled for other head counts."""
    n = 2 ** math.ceil(math.log2(n_heads))
    base = np.arange(1, n + 1, dtype=np.float64) * (bias_max / n)
    slopes = 1.0 / np.power(2, base)
    if n != n_heads:
        slopes = np.concatenate([slopes[1::2], slopes[0::2]])[:n_heads]
    return slopes.astype(np.float32)


def alibi_bias(n_heads: int, seq_len: int, bias_max: int = 8) -> np.ndarray:
    """(H, 1, S) bias added to the scores; it depends only on the key's
    position relative to the end of the sequence (HF MPT convention)."""
    pos = np.arange(1 - seq_len, 1, dtype=np.float32).reshape(1, 1, seq_len)
    return pos * alibi_slopes(n_heads, bias_max).reshape(n_heads, 1, 1)


def _ln(norm: _Norm, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    return ((xf - mean) * torch.rsqrt(var + eps) * norm.weight.float()).to(x.dtype)


def _mm(linear: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, linear.weight.to(x.dtype))


def mpt_forward(lm: MptForCausalLM, cfg: MptConfig, inputs_embeds: torch.Tensor,
                attention_mask: torch.Tensor) -> torch.Tensor:
    """Full-sequence forward -> (B, S, V) f32 logits (tied lm_head)."""
    b, s, d = inputs_embeds.shape
    h, dh = cfg.n_heads, cfg.head_dim
    dev = inputs_embeds.device
    causal = torch.tril(torch.ones((s, s), dtype=torch.bool, device=dev))
    mask = causal[None] & attention_mask.bool()[:, None, :]  # (B, S, S)
    bias = torch.from_numpy(alibi_bias(h, s, cfg.alibi_bias_max)).to(dev)  # (H, 1, S)
    x = inputs_embeds
    for blk in lm.transformer.blocks:
        hdn = _ln(blk.norm_1, x, cfg.layer_norm_epsilon)
        q, k, v = (t.reshape(b, s, h, dh).transpose(1, 2)
                   for t in _mm(blk.attn.Wqkv, hdn).chunk(3, dim=-1))
        scores = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(dh) + bias[None]
        scores = scores.masked_fill(~mask[:, None], NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        attn = (probs.float() @ v.float()).to(x.dtype).transpose(1, 2).reshape(b, s, d)
        x = x + _mm(blk.attn.out_proj, attn)
        hdn = _ln(blk.norm_2, x, cfg.layer_norm_epsilon)
        up = F.gelu(_mm(blk.ffn.up_proj, hdn).float(), approximate="tanh").to(x.dtype)
        x = x + _mm(blk.ffn.down_proj, up)
    x = _ln(lm.transformer.norm_f, x, cfg.layer_norm_epsilon)
    return (x.float() @ lm.transformer.wte.weight.float().T)


def mpt_embed(lm: MptForCausalLM, input_ids: torch.Tensor) -> torch.Tensor:
    table = lm.transformer.wte.weight
    return table[input_ids.long().clamp(0, table.shape[0] - 1)]


def convert_mpt_state_dict(sd: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """An HF MPT state dict (with or without the ``transformer.`` root) ->
    the state of :class:`MptForCausalLM`; a tied ``lm_head`` is dropped."""
    root = "transformer." if any(k.startswith("transformer.") for k in sd) else ""
    out = {}
    for key, value in sd.items():
        if not key.startswith(root) or key.endswith("lm_head.weight"):
            continue
        out["transformer." + key[len(root):]] = torch.as_tensor(value)
    return out


def init_mpt_params(cfg: MptConfig, *, seed: int = 0, dtype=torch.float32,
                    device="cpu") -> MptForCausalLM:
    """MPT with seeded random weights: N(0, 0.02) matrices, unit norms."""
    lm = empty_module(lambda: MptForCausalLM(cfg), device, dtype)
    g = generator(device, seed)
    with torch.no_grad():
        for name, p in lm.named_parameters():
            if "norm" in name:
                p.fill_(1.0)
            else:
                p.normal_(0.0, 0.02, generator=g)
    return lm
