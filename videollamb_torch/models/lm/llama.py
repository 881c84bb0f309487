"""Llama-family LM backbone with a dense KV cache.

Port of ``videollamb_tpu/models/lm/llama.py`` for inference: token
embedding, cached prefill, chunk extension of a filled cache (the serving
engines' chunked admission) and one-token decode. Module names follow the HF
``LlamaForCausalLM`` state dict (``model.layers.N.self_attn.q_proj``,
``model.norm``, ``lm_head``), so a reference checkpoint loads by name.

- The cache is a static (L, B, S_max, H_kv, Dh) buffer with per-row
  lengths, as in the JAX package. Prefill writes [0, S) of every row;
  decode writes slot ``length`` of each row and attends ``k_pos <= pos``.
  Unlike JAX, the port writes the cache in place.
- Prefill attention runs over the fresh keys through
  ``ops/attention.multihead_attention`` (the flash kernel on the card).
  Extend and decode attention are plain PyTorch over the cache, as they are
  plain XLA (``_grouped_attention``) in the JAX package.
- RMSNorm, RoPE and attention scores are f32; weights may be bf16.
- Every projection is a module call (``attn.q_proj(x)``, ``lm.lm_head(x)``):
  an ``nn.Linear``, a ``models/lm/quant.QuantLinear`` holding int8 or int4
  weights (int4 with at most 64 rows goes through kernel K7 on the card), or
  a ``models/lm/lora.LoRALinear`` around either, or a
  ``models/lm/mlora.MultiLoRALinear`` that adds each row's adapter from a
  stack of K (the row indices set around the call by
  ``mlora.adapter_rows``).
- Every projection goes through :func:`proj`, which casts a plain weight to
  the activation's dtype first, as the JAX ``_proj`` does: a frozen base in
  bf16 under f32 trainable leaves, or f32 masters under bf16 activations,
  multiply in the activation's dtype with f32 accumulation.
- :func:`llama_forward` is the full-sequence forward of training: logits of
  every position, per-row ``position_ids``, packed-row ``segment_ids``, the
  chunked differentiable attention and, with ``remat``, each layer under
  ``torch.utils.checkpoint`` (the JAX ``jax.checkpoint`` of the layer body),
  so the backward keeps only the layer boundaries. It calls each layer as a
  module (``LlamaDecoderLayer.forward``), so that FSDP's hooks on a layer
  (``parallel/sharding.py``) gather its weights around the call.
- Under tensor parallelism (``parallel/sharding.shard_params``) the
  projection weights, the embedding table and the LM head are DTensors
  sharded over the mesh's ``model`` axis: :func:`proj` and
  :func:`embed_tokens` compute on the rank's shard
  (``parallel/tensor_parallel.py``), the head counts of q / k / v and of the
  caches (``init_kv_cache(lm=)``) follow the local width, and the logits are
  gathered. Under FSDP the cached paths run each layer inside
  ``sharding.gathered(layer)``, and :func:`embed_tokens` and the head inside
  ``gathered(lm)`` (the root unit holds them), so every rank of a sharded
  model steps the same cache over its own heads.
- Mistral's sliding window (``cfg.sliding_window``) applies wherever the
  JAX package applies it: the fresh-key attention of the forward and the
  prefill (``multihead_attention(window=)``, which K3 computes on the card),
  and the masks over the cache of extend and decode
  (``q_pos - k_pos < window``). RoPE scaling (``cfg.rope_scaling``) comes
  with the cos / sin tables (``models/lm/rope.py``).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from videollamb_torch.config import LlamaConfig
from videollamb_torch.models.lm.rope import apply_rope, rope_cos_sin_cfg
from videollamb_torch.models.seeded import empty_module, generator
from videollamb_torch.ops.attention import multihead_attention
from videollamb_torch.parallel.sharding import gathered, local_heads
from videollamb_torch.parallel.tensor_parallel import tp_embedding, tp_linear

NEG_INF = -1e30
PREFILL_CHUNK = 256  # tokens per llama_extend call of the chunked prefill


class KVCache(NamedTuple):
    k: torch.Tensor       # (L, B, S_max, H_kv, Dh)
    v: torch.Tensor       # (L, B, S_max, H_kv, Dh)
    length: torch.Tensor  # (B,) int64, tokens written per row


class RMSNorm(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d))


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        d, dh = cfg.hidden_size, cfg.head_dim
        # The config's head counts; a tensor-parallel rank holds 1 / tp of
        # each (parallel/sharding.local_heads).
        self.num_heads, self.num_key_value_heads = cfg.num_attention_heads, cfg.num_key_value_heads
        self.head_dim = dh
        self.q_proj = nn.Linear(d, cfg.num_attention_heads * dh, bias=False)
        self.k_proj = nn.Linear(d, cfg.num_key_value_heads * dh, bias=False)
        self.v_proj = nn.Linear(d, cfg.num_key_value_heads * dh, bias=False)
        self.o_proj = nn.Linear(cfg.num_attention_heads * dh, d, bias=False)


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        d, inter = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = nn.Linear(d, inter, bias=False)
        self.up_proj = nn.Linear(d, inter, bias=False)
        self.down_proj = nn.Linear(inter, d, bias=False)


class LlamaDecoderLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.self_attn = LlamaAttention(cfg)
        self.mlp = LlamaMLP(cfg)
        self.input_layernorm = RMSNorm(cfg.hidden_size)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size)

    def forward(self, *args) -> torch.Tensor:
        """:func:`_layer` of this layer (the training forward's call)."""
        return _layer(self, *args)


class LlamaModel(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(LlamaDecoderLayer(cfg) for _ in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size)


class LlamaForCausalLM(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.model = LlamaModel(cfg)
        self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False)


def init_kv_cache(cfg: LlamaConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                  device="cpu", lm: Optional[LlamaForCausalLM] = None) -> KVCache:
    """A zero cache; with ``lm``, at its kv heads on this rank (1 / tp of the
    config's under tensor parallelism)."""
    shape = (cfg.num_hidden_layers, batch, max_len, local_kv_heads(cfg, lm), cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   length=torch.zeros((batch,), dtype=torch.long, device=device))


def local_kv_heads(cfg: LlamaConfig, lm: Optional[LlamaForCausalLM] = None) -> int:
    """The kv heads of ``lm``'s layers on this rank; the config's without an LM."""
    if lm is None:
        return cfg.num_key_value_heads
    return local_heads(lm.model.layers[0].self_attn)[1]


def _rms_norm(norm: RMSNorm, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    return (y * norm.weight.float()).to(x.dtype)


def proj(module: nn.Module, x: torch.Tensor, gather: bool = False) -> torch.Tensor:
    """A projection in x's dtype: a plain ``nn.Linear``'s weight is cast to it
    (a no-op when they agree), a tensor-parallel one computes on its shard
    (``gather`` collects a column-parallel output's features); quantised and
    adapter modules handle their own."""
    if isinstance(module, nn.Linear):
        return tp_linear(x, module.weight, module.bias, gather=gather)
    return module(x)


def _mlp(layer: LlamaDecoderLayer, cfg: LlamaConfig, x: torch.Tensor) -> torch.Tensor:
    h = _rms_norm(layer.post_attention_layernorm, x, cfg.rms_norm_eps)
    mlp = layer.mlp
    gate = F.silu(proj(mlp.gate_proj, h).float()).to(x.dtype)
    return x + proj(mlp.down_proj, gate * proj(mlp.up_proj, h))


def _qkv(layer: LlamaDecoderLayer, cfg: LlamaConfig, x: torch.Tensor, cos, sin):
    b, s, _ = x.shape
    dh = cfg.head_dim
    normed = _rms_norm(layer.input_layernorm, x, cfg.rms_norm_eps)
    attn = layer.self_attn
    # Head counts from the widths: a tensor-parallel rank holds h / tp heads.
    q = apply_rope(proj(attn.q_proj, normed).reshape(b, s, -1, dh), cos, sin)
    k = apply_rope(proj(attn.k_proj, normed).reshape(b, s, -1, dh), cos, sin)
    v = proj(attn.v_proj, normed).reshape(b, s, -1, dh)
    return q, k, v


def _final(lm: LlamaForCausalLM, cfg: LlamaConfig, x: torch.Tensor) -> torch.Tensor:
    with gathered(lm):
        return proj(lm.lm_head, _rms_norm(lm.model.norm, x, cfg.rms_norm_eps),
                    gather=True).float()


def embed_tokens(lm: LlamaForCausalLM, input_ids: torch.Tensor) -> torch.Tensor:
    """Token embeddings; out-of-range ids (multimodal sentinels) clamp to 0.

    Clamping matters: a negative index would otherwise read from the end.
    A vocabulary-parallel table sums the ranks' masked lookups.
    """
    with gathered(lm):
        table = lm.model.embed_tokens.weight
        return tp_embedding(input_ids.long().clamp(0, table.shape[0] - 1), table)


def _grouped_attention(q, k, v, mask):
    """q (B, Sq, H, Dh), k/v (B, Sk, H_kv, Dh), mask (B, Sq, Sk) -> (B, Sq, H, Dh)."""
    b, sq, h, dh = q.shape
    h_kv = k.shape[2]
    qg = q.reshape(b, sq, h_kv, h // h_kv, dh)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) / math.sqrt(dh)
    scores = scores.masked_fill(~mask[:, None, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.float(), v.float())
    return out.to(q.dtype).reshape(b, sq, h, dh)


def _layer(layer: LlamaDecoderLayer, cfg: LlamaConfig, x: torch.Tensor, cos, sin,
           valid: torch.Tensor, attn_impl: str,
           segment_ids: Optional[torch.Tensor]) -> torch.Tensor:
    """One decoder layer without a cache, causal (JAX ``_layer``)."""
    b, s, _ = x.shape
    q, k, v = _qkv(layer, cfg, x, cos, sin)
    attn = multihead_attention(q, k, v, causal=True, k_mask=valid, impl=attn_impl,
                               segment_ids=segment_ids, window=cfg.sliding_window)
    x = x + proj(layer.self_attn.o_proj, attn.reshape(b, s, -1))
    return _mlp(layer, cfg, x)


def _run_layers(lm: LlamaForCausalLM, cfg: LlamaConfig, x: torch.Tensor,
                attention_mask: torch.Tensor, position_ids: Optional[torch.Tensor],
                remat: bool, attn_impl: str,
                segment_ids: Optional[torch.Tensor]) -> torch.Tensor:
    b, s, _ = x.shape
    if position_ids is None:
        position_ids = torch.arange(s, device=x.device)[None].expand(b, s)
    cos, sin = rope_cos_sin_cfg(cfg, position_ids)
    valid = attention_mask.bool()
    for layer in lm.model.layers:
        args = (cfg, x, cos, sin, valid, attn_impl, segment_ids)
        if remat and torch.is_grad_enabled():
            x = checkpoint(layer, *args, use_reentrant=False)
        else:
            x = layer(*args)
    return x


def llama_forward(lm: LlamaForCausalLM, cfg: LlamaConfig, inputs_embeds: torch.Tensor,
                  attention_mask: torch.Tensor, position_ids: Optional[torch.Tensor] = None,
                  remat: bool = False, attn_impl: str = "auto",
                  segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence forward (training, no cache) -> (B, S, V) f32 logits.

    ``attn_impl``: ``auto`` (the flash kernel on the card, forward only) or
    ``chunked`` (differentiable; training). ``segment_ids`` (B, S) restricts
    attention to each packed segment and needs ``chunked`` or ``torch`` (the
    kernel has no segment lane and refuses it); pass per-segment
    ``position_ids`` with it so RoPE restarts per conversation."""
    x = _run_layers(lm, cfg, inputs_embeds, attention_mask, position_ids, remat,
                    attn_impl, segment_ids)
    return _final(lm, cfg, x)


def llama_forward_with_hidden(lm: LlamaForCausalLM, cfg: LlamaConfig,
                              inputs_embeds: torch.Tensor, attention_mask: torch.Tensor,
                              remat: bool = False, attn_impl: str = "auto"
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`llama_forward` that also returns the last layer's hidden states
    before the final norm (B, S, D), from which the LM-memory retro variant
    reads its memory tokens back."""
    x = _run_layers(lm, cfg, inputs_embeds, attention_mask, None, remat, attn_impl, None)
    return _final(lm, cfg, x), x


@torch.no_grad()
def llama_prefill(lm: LlamaForCausalLM, cfg: LlamaConfig, inputs_embeds: torch.Tensor,
                  attention_mask: torch.Tensor, cache: KVCache,
                  attn_impl: str = "auto") -> Tuple[torch.Tensor, KVCache]:
    """Prefill the cache from right-padded (B, S, D) embeds.

    Returns the last valid token's logits (B, V) f32 and the cache with
    ``length`` set to each row's valid length.
    """
    b, s, _ = inputs_embeds.shape
    valid = attention_mask.bool()
    lengths = valid.sum(dim=1)
    positions = torch.arange(s, device=inputs_embeds.device)[None].expand(b, s)
    cos, sin = rope_cos_sin_cfg(cfg, positions)
    x = inputs_embeds
    for i, layer in enumerate(lm.model.layers):
        with gathered(layer):
            q, k, v = _qkv(layer, cfg, x, cos, sin)
            cache.k[i, :, :s] = k.to(cache.k.dtype)
            cache.v[i, :, :s] = v.to(cache.v.dtype)
            attn = multihead_attention(q, k, v, causal=True, k_mask=valid, impl=attn_impl,
                                       window=cfg.sliding_window)
            x = x + proj(layer.self_attn.o_proj, attn.reshape(b, s, -1))
            x = _mlp(layer, cfg, x)
    logits = _final(lm, cfg, x)  # (B, S, V)
    last = logits[torch.arange(b, device=logits.device), lengths - 1]
    return last, KVCache(k=cache.k, v=cache.v, length=lengths)


@torch.no_grad()
def llama_extend(lm: LlamaForCausalLM, cfg: LlamaConfig, inputs_embeds: torch.Tensor,
                 attention_mask: torch.Tensor, cache: KVCache,
                 return_all: bool = False) -> Tuple[torch.Tensor, KVCache]:
    """Append a right-padded (B, S, D) chunk to a filled cache (in place).

    Row i's fresh tokens are written at [len_i, len_i + S) (rows past the
    buffer are dropped) and attend causally over the cache and each other.
    Returns (last valid token's logits (B, V) f32, or every position's
    (B, S, V) with ``return_all``; the cache with lengths advanced by the
    valid count).
    """
    b, s, _ = inputs_embeds.shape
    s_max = cache.k.shape[2]
    dev = inputs_embeds.device
    valid = attention_mask.bool()
    fresh_len = valid.sum(dim=1)
    start = cache.length
    rank = valid.long().cumsum(dim=1) - 1
    pos_ids = start[:, None] + torch.where(valid, rank, s)  # padding: past the end
    cos, sin = rope_cos_sin_cfg(cfg, pos_ids)
    # Keys at or past max(start) + S are visible to no query: attend over the
    # buffer up to there (the masked keys would contribute exactly 0).
    end = min(s_max, int(start.max()) + s)
    k_pos = torch.arange(end, device=dev)
    dist = pos_ids[:, :, None] - k_pos[None, None]
    mask = (dist >= 0) & valid[:, :, None]
    if cfg.sliding_window is not None:
        mask = mask & (dist < cfg.sliding_window)
    write = start[:, None] + torch.arange(s, device=dev)[None]
    keep = write < s_max
    rows = torch.arange(b, device=dev)[:, None].expand(b, s)[keep]
    write = write[keep]
    x = inputs_embeds
    for i, layer in enumerate(lm.model.layers):
        with gathered(layer):
            q, k, v = _qkv(layer, cfg, x, cos, sin)
            cache.k[i, rows, write] = k[keep].to(cache.k.dtype)
            cache.v[i, rows, write] = v[keep].to(cache.v.dtype)
            attn = _grouped_attention(q, cache.k[i, :, :end].to(q.dtype),
                                      cache.v[i, :, :end].to(q.dtype), mask)
            x = x + proj(layer.self_attn.o_proj, attn.reshape(b, s, -1))
            x = _mlp(layer, cfg, x)
    new_cache = KVCache(k=cache.k, v=cache.v, length=start + fresh_len)
    if return_all:
        return _final(lm, cfg, x), new_cache
    last = x[torch.arange(b, device=dev), (fresh_len - 1).clamp(min=0)]
    return _final(lm, cfg, last[:, None])[:, 0], new_cache


@torch.no_grad()
def chunked_prefill(lm: LlamaForCausalLM, cfg: LlamaConfig, inputs_embeds: torch.Tensor,
                    attention_mask: torch.Tensor, cache: KVCache,
                    lengths: Optional[Sequence[int]] = None) -> Tuple[torch.Tensor, KVCache]:
    """Prefill an empty cache in PREFILL_CHUNK-token slices of
    :func:`llama_extend`, up to the longest row's real length (``lengths``,
    host ints, saves the device read of the mask). Same contract as
    :func:`llama_prefill`."""
    chunk = PREFILL_CHUNK
    b, s_pad, d = inputs_embeds.shape
    if lengths is None:
        lengths = attention_mask.sum(dim=1).cpu().numpy()
    lengths = np.atleast_1d(np.asarray(lengths))
    logits = None
    for lo in range(0, max(1, int(lengths.max())), chunk):
        e = inputs_embeds[:, lo:lo + chunk]
        m = attention_mask[:, lo:lo + chunk]
        if e.shape[1] < chunk:  # ragged tail of the buffer
            e = F.pad(e, (0, 0, 0, chunk - e.shape[1]))
            m = F.pad(m, (0, chunk - m.shape[1]))
        nxt, cache = llama_extend(lm, cfg, e, m, cache)
        if logits is None:
            logits = nxt
        else:  # rows whose prompt ended in an earlier chunk keep their logits
            alive = torch.as_tensor(lengths > lo, device=nxt.device)[:, None]
            logits = torch.where(alive, nxt, logits)
    return logits, cache


@torch.no_grad()
def llama_decode_step(lm: LlamaForCausalLM, cfg: LlamaConfig, token_embeds: torch.Tensor,
                      cache: KVCache) -> Tuple[torch.Tensor, KVCache]:
    """One decode step: writes each row's token at its current length (in place)
    and returns (logits (B, V) f32, cache with length + 1)."""
    b = token_embeds.shape[0]
    s_max = cache.k.shape[2]
    pos = cache.length
    cos, sin = rope_cos_sin_cfg(cfg, pos[:, None])
    dist = pos[:, None] - torch.arange(s_max, device=pos.device)[None]
    mask = dist >= 0
    if cfg.sliding_window is not None:
        mask = mask & (dist < cfg.sliding_window)
    mask = mask[:, None, :]  # (B, 1, S_max)
    rows = torch.arange(b, device=pos.device)
    x = token_embeds
    for i, layer in enumerate(lm.model.layers):
        with gathered(layer):
            q, k, v = _qkv(layer, cfg, x, cos, sin)
            cache.k[i, rows, pos] = k[:, 0].to(cache.k.dtype)
            cache.v[i, rows, pos] = v[:, 0].to(cache.v.dtype)
            attn = _grouped_attention(q, cache.k[i].to(q.dtype), cache.v[i].to(q.dtype), mask)
            x = x + proj(layer.self_attn.o_proj, attn.reshape(b, 1, -1))
            x = _mlp(layer, cfg, x)
    logits = _final(lm, cfg, x)[:, 0]
    return logits, KVCache(k=cache.k, v=cache.v, length=cache.length + 1)


def init_llama_params(cfg: LlamaConfig, *, seed: int = 0, dtype=torch.float32,
                      device="cpu") -> LlamaForCausalLM:
    """LM with seeded random weights: N(0, 0.02) matrices, unit norms."""
    lm = empty_module(lambda: LlamaForCausalLM(cfg), device, dtype)
    g = generator(device, seed)
    with torch.no_grad():
        for name, p in lm.named_parameters():
            if "norm" in name:
                p.fill_(1.0)
            else:
                p.normal_(0.0, 0.02, generator=g)
    return lm
