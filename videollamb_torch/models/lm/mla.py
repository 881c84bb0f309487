"""DeepSeek-V3-family LM backbone: multi-head latent attention (MLA) and
sigmoid-routed experts with shared experts, over a dense latent cache.

The equations are DeepSeek-V3's published modeling code, at the settings of
Moonlight-16B-A3B (``config.MLAConfig``): no q compression, one routing
group, unscaled RoPE. Module names follow the HF ``DeepseekV3ForCausalLM``
state dict (``model.layers.N.self_attn.kv_a_proj_with_mqa``,
``model.layers.N.mlp.gate.e_score_correction_bias``,
``model.layers.N.mlp.experts.E.gate_proj``, ``...mlp.shared_experts.*``), so
a checkpoint loads by name.

- Attention. ``q_proj`` gives each head 128 dims without position and 64
  with RoPE; ``kv_a_proj_with_mqa`` gives one 512-wide kv latent, RMS-normed
  by ``kv_a_layernorm``, and one 64-wide key shared by the heads, roped.
  RoPE takes the 64 dims de-interleaved (pairs (2i, 2i + 1) to (i, 32 + i)),
  as the published ``apply_rotary_pos_emb`` does. The softmax scale is
  ``192 ** -0.5``. A token's cached row is the normed latent and the roped
  key: 576 values a layer, no heads (``LatentCache``; the paged pool,
  ``models/lm/paged.PagedLatentCache``, holds the same rows).
- Prefill and extend run attention unabsorbed: ``kv_b_proj`` expands each
  cached row to the heads' keys and values, and the scores and the softmax
  are float32 einsums (cuBLAS on the card). The paged decode runs it
  absorbed (``paged.paged_latent_decode_step``): ``W_UK`` folded into q,
  scores over the 576-wide rows, the output over the 512 latent dims, then
  ``W_UV``.
- Experts. Layer ``i >= first_k_dense_replace`` routes each token: float32
  logits, sigmoid scores, the top ``num_experts_per_tok`` of the scores plus
  ``e_score_correction_bias``, weights from the unbiased scores renormalised
  and times ``routed_scaling_factor``, and the shared experts added. On the
  card in bf16 the routed products are two ``torch._grouped_mm`` over the
  token-sorted rows, with every count kept on the device, so a forward
  holds no host synchronisation and the paged decode replays as one CUDA
  graph; elsewhere (the CPU, f32 weights) they are a loop over the experts. Each expert's
  weights are views into one stacked tensor a layer
  (:meth:`MoE.stacked`), which the grouped products read.
- Counters (graph-safe, in place on the device): each MoE block's
  ``routed`` buffer accumulates, per expert, the valid tokens routed to it
  and the forwards in which it had any token. The engines read them between
  steps (:func:`expert_load`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from videollamb_torch.config import MLAConfig
from videollamb_torch.models.lm.llama import RMSNorm, _final, _rms_norm, proj
from videollamb_torch.models.lm.rope import apply_rope, rope_cos_sin_cfg
from videollamb_torch.models.seeded import generator

NEG_INF = -1e30


class LatentCache(NamedTuple):
    kv: torch.Tensor      # (L, B, S_max, kv_lora_rank + qk_rope_head_dim)
    length: torch.Tensor  # (B,) int64, tokens written per row


class MLAAttention(nn.Module):
    def __init__(self, cfg: MLAConfig):
        super().__init__()
        d, h = cfg.hidden_size, cfg.num_attention_heads
        self.num_heads = h
        self.q_proj = nn.Linear(d, h * cfg.qk_head_dim, bias=False)
        self.kv_a_proj_with_mqa = nn.Linear(d, cfg.latent_dim, bias=False)
        self.kv_a_layernorm = RMSNorm(cfg.kv_lora_rank)
        self.kv_b_proj = nn.Linear(cfg.kv_lora_rank,
                                   h * (cfg.qk_nope_head_dim + cfg.v_head_dim), bias=False)
        self.o_proj = nn.Linear(h * cfg.v_head_dim, d, bias=False)


class MLAMLP(nn.Module):
    """A SiLU-gated MLP: the dense layers, each routed expert, the shared experts."""

    def __init__(self, d: int, inter: int):
        super().__init__()
        self.gate_proj = nn.Linear(d, inter, bias=False)
        self.up_proj = nn.Linear(d, inter, bias=False)
        self.down_proj = nn.Linear(inter, d, bias=False)


class MoEGate(nn.Module):
    def __init__(self, cfg: MLAConfig):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cfg.n_routed_experts, cfg.hidden_size))
        self.e_score_correction_bias = nn.Parameter(torch.empty(cfg.n_routed_experts))


class MoE(nn.Module):
    def __init__(self, cfg: MLAConfig):
        super().__init__()
        d, inter, e = cfg.hidden_size, cfg.moe_intermediate_size, cfg.n_routed_experts
        self.gate = MoEGate(cfg)
        self.experts = nn.ModuleList(MLAMLP(d, inter) for _ in range(e))
        self.shared_experts = MLAMLP(d, inter * cfg.n_shared_experts)
        # [0]: valid tokens routed to each expert; [1]: forwards in which it had any.
        self.register_buffer("routed", torch.zeros((2, e), dtype=torch.long), persistent=False)
        self._stack: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    def _is_stacked(self) -> bool:
        s = self._stack
        if s is None:
            return False
        first, last = self.experts[0], self.experts[-1]
        return (first.gate_proj.weight.data_ptr() == s[0].data_ptr()
                and first.gate_proj.weight.device == s[0].device
                and last.down_proj.weight.data_ptr() == s[1][-1].data_ptr())

    def allocate_stacked(self, device, dtype) -> None:
        """Give the experts' weights one stacked home on ``device``: (E, 2I, D)
        for gate over up, (E, D, I) for down; each expert's weights become
        views into it (their values are left undefined)."""
        inter, d = self.experts[0].gate_proj.weight.shape
        e = len(self.experts)
        w13 = torch.empty((e, 2 * inter, d), dtype=dtype, device=device)
        w2 = torch.empty((e, d, inter), dtype=dtype, device=device)
        for i, ex in enumerate(self.experts):
            ex.gate_proj.weight = nn.Parameter(w13[i, :inter], requires_grad=False)
            ex.up_proj.weight = nn.Parameter(w13[i, inter:], requires_grad=False)
            ex.down_proj.weight = nn.Parameter(w2[i], requires_grad=False)
        self._stack = (w13, w2)

    @torch.no_grad()
    def stacked(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(w13, w2), the experts' weights stacked; after a cast or a move
        replaced the views, the current values are stacked again."""
        if not self._is_stacked():
            ex = self.experts[0].gate_proj.weight
            old = [(m.gate_proj.weight.detach(), m.up_proj.weight.detach(),
                    m.down_proj.weight.detach()) for m in self.experts]
            self.allocate_stacked(ex.device, ex.dtype)
            for m, (g, u, dn) in zip(self.experts, old):
                m.gate_proj.weight.copy_(g)
                m.up_proj.weight.copy_(u)
                m.down_proj.weight.copy_(dn)
        return self._stack


class MLADecoderLayer(nn.Module):
    def __init__(self, cfg: MLAConfig, i: int):
        super().__init__()
        self.self_attn = MLAAttention(cfg)
        self.mlp = MoE(cfg) if cfg.is_moe_layer(i) else MLAMLP(cfg.hidden_size,
                                                              cfg.intermediate_size)
        self.input_layernorm = RMSNorm(cfg.hidden_size)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size)


class MLAModel(nn.Module):
    def __init__(self, cfg: MLAConfig):
        super().__init__()
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(MLADecoderLayer(cfg, i) for i in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size)


class MLAForCausalLM(nn.Module):
    def __init__(self, cfg: MLAConfig):
        super().__init__()
        self.model = MLAModel(cfg)
        self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False)


def moe_blocks(lm: MLAForCausalLM):
    return [layer.mlp for layer in lm.model.layers if isinstance(layer.mlp, MoE)]


def empty_mla_lm(cfg: MLAConfig, device, dtype) -> MLAForCausalLM:
    """The LM with uninitialised weights of ``dtype`` on ``device``, each MoE
    layer's experts allocated stacked (no second copy of them is made)."""
    with torch.device("meta"):
        lm = MLAForCausalLM(cfg)
    for moe in moe_blocks(lm):
        moe.allocate_stacked(device, dtype)
    for mod in lm.modules():
        for name, p in list(mod.named_parameters(recurse=False)):
            if p.is_meta:
                setattr(mod, name, nn.Parameter(torch.empty_like(p, dtype=dtype, device=device),
                                                requires_grad=False))
        for name, b in list(mod.named_buffers(recurse=False)):
            if b.is_meta:
                setattr(mod, name, torch.zeros_like(b, device=device))
    return lm.eval()


def init_mla_params(cfg: MLAConfig, *, seed: int = 0, dtype=torch.float32,
                    device="cpu") -> MLAForCausalLM:
    """LM with seeded random weights: N(0, 0.02) matrices and router, unit
    norms, a router bias of N(0, 0.02)."""
    lm = empty_mla_lm(cfg, device, dtype)
    g = generator(device, seed)
    with torch.no_grad():
        for name, p in lm.named_parameters():
            if "norm" in name:
                p.fill_(1.0)
            else:
                p.normal_(0.0, 0.02, generator=g)
    return lm


def init_latent_cache(cfg: MLAConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                      device="cpu", lm=None) -> LatentCache:
    """A zero dense cache of latent rows (``lm`` is taken for the Llama
    function's signature; the rows have no heads to shard)."""
    return LatentCache(
        kv=torch.zeros((cfg.num_hidden_layers, batch, max_len, cfg.latent_dim), dtype=dtype,
                       device=device),
        length=torch.zeros((batch,), dtype=torch.long, device=device))


# --------------------------------------------------------------------------- attention
def _deinterleave(x: torch.Tensor) -> torch.Tensor:
    """(..., d) -> the even dims then the odd ones (the published RoPE's view)."""
    return x.unflatten(-1, (x.shape[-1] // 2, 2)).transpose(-1, -2).flatten(-2)


def rope_mla(x: torch.Tensor, cos, sin) -> torch.Tensor:
    """DeepSeek-V3's RoPE on x (..., seq, heads, 64): de-interleave, rotate half."""
    return apply_rope(_deinterleave(x), cos, sin)


def q_heads(layer: MLADecoderLayer, cfg: MLAConfig, normed: torch.Tensor, cos, sin):
    """(q without position (B, S, H, 128), roped q (B, S, H, 64))."""
    b, s, _ = normed.shape
    q = proj(layer.self_attn.q_proj, normed).reshape(b, s, -1, cfg.qk_head_dim)
    q_nope, q_pe = q.split([cfg.qk_nope_head_dim, cfg.qk_rope_head_dim], dim=-1)
    return q_nope, rope_mla(q_pe, cos, sin)


def latent_rows(layer: MLADecoderLayer, cfg: MLAConfig, normed: torch.Tensor, cos, sin):
    """(B, S, 576): each token's normed kv latent and its roped shared key."""
    attn = layer.self_attn
    ckv, k_pe = proj(attn.kv_a_proj_with_mqa, normed).split(
        [cfg.kv_lora_rank, cfg.qk_rope_head_dim], dim=-1)
    ckv = _rms_norm(attn.kv_a_layernorm, ckv, cfg.rms_norm_eps)
    k_pe = rope_mla(k_pe[:, :, None], cos, sin)[:, :, 0]
    return torch.cat([ckv, k_pe], dim=-1)


def absorbed_weights(layer: MLADecoderLayer, cfg: MLAConfig):
    """``kv_b_proj``'s weight as (W_UK (H, 128, 512), W_UV (H, 128, 512)) views."""
    w = layer.self_attn.kv_b_proj.weight
    h = w.shape[0] // (cfg.qk_nope_head_dim + cfg.v_head_dim)
    w = w.view(h, cfg.qk_nope_head_dim + cfg.v_head_dim, cfg.kv_lora_rank)
    return w[:, :cfg.qk_nope_head_dim], w[:, cfg.qk_nope_head_dim:]


def unabsorbed_attention(layer: MLADecoderLayer, cfg: MLAConfig, q_nope, q_pe,
                         rows: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """q (B, S, H, 128 | 64) over latent rows (B, Sk, 576) expanded by
    ``kv_b_proj`` to every head's keys and values; ``mask`` (B, S, Sk). The
    scores and the softmax are float32. -> (B, S, H * 128)."""
    b, sk, _ = rows.shape
    kv = proj(layer.self_attn.kv_b_proj, rows[..., :cfg.kv_lora_rank]).reshape(
        b, sk, -1, cfg.qk_nope_head_dim + cfg.v_head_dim)
    k_nope, v = kv.split([cfg.qk_nope_head_dim, cfg.v_head_dim], dim=-1)
    k_pe = rows[..., cfg.kv_lora_rank:]
    scores = (torch.einsum("bqhd,bkhd->bhqk", q_nope.float(), k_nope.float())
              + torch.einsum("bqhd,bkd->bhqk", q_pe.float(), k_pe.float()))
    scores = (scores * cfg.softmax_scale).masked_fill(~mask[:, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q_nope.dtype)
    return out.reshape(out.shape[0], out.shape[1], -1)


# --------------------------------------------------------------------------- experts
def _mlp_out(mlp: MLAMLP, h: torch.Tensor) -> torch.Tensor:
    gate = F.silu(proj(mlp.gate_proj, h).float()).to(h.dtype)
    return proj(mlp.down_proj, gate * proj(mlp.up_proj, h))


def route(moe: MoE, cfg: MLAConfig, h: torch.Tensor):
    """The published gate (``noaux_tc``, one group) on h (T, D) -> (choice
    (T, k) expert ids, weights (T, k) f32)."""
    scores = F.linear(h.float(), moe.gate.weight.float()).sigmoid()
    biased = scores + moe.gate.e_score_correction_bias.float()
    choice = torch.topk(biased, cfg.num_experts_per_tok, dim=-1).indices
    w = scores.gather(1, choice)
    if cfg.norm_topk_prob and cfg.num_experts_per_tok > 1:
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
    return choice, w * cfg.routed_scaling_factor


def _experts_loop(moe: MoE, h: torch.Tensor, choice, w) -> torch.Tensor:
    """The CPU route: each expert over its tokens."""
    out = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
    for e, expert in enumerate(moe.experts):
        tok, pick = (choice == e).nonzero(as_tuple=True)
        if tok.numel():
            y = _mlp_out(expert, h[tok]).float() * w[tok, pick, None]
            out.index_add_(0, tok, y)
    return out


def grouped_route(h: torch.Tensor) -> bool:
    """Whether the routed products run grouped: bf16 on the card (the grouped
    GEMM's only graph-safe type); otherwise the loop over experts, which
    reads each expert's row count on the host."""
    return h.is_cuda and h.dtype == torch.bfloat16


def _experts_grouped(moe: MoE, h: torch.Tensor, choice, w, counts) -> torch.Tensor:
    """The card route: the (token, choice) rows sorted by expert, two grouped
    products over the stacked weights, the weighted sum back per token.
    Every shape is fixed by T and k and every count stays on the device."""
    w13, w2 = moe.stacked()
    inter = w2.shape[2]
    k = choice.shape[1]
    order = choice.reshape(-1).argsort(stable=True)
    tok = order // k
    offs = counts.cumsum(0, dtype=torch.int32)
    gu = torch._grouped_mm(h[tok], w13.transpose(1, 2), offs=offs)
    act = F.silu(gu[:, :inter].float()).to(h.dtype) * gu[:, inter:]
    y = torch._grouped_mm(act, w2.transpose(1, 2), offs=offs)
    out = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
    return out.index_add_(0, tok, y.float() * w.reshape(-1)[order, None])


def moe_forward(moe: MoE, cfg: MLAConfig, h: torch.Tensor,
                valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The routed experts and the shared experts on h (T, D). ``valid`` (T,)
    marks the tokens the load counters count (all without it)."""
    choice, w = route(moe, cfg, h)
    e, k = len(moe.experts), choice.shape[1]
    flat = choice.reshape(-1)
    ones = torch.ones_like(flat)
    counts = torch.zeros(e, dtype=torch.long, device=h.device).scatter_add_(0, flat, ones)
    real = ones if valid is None else valid.long().repeat_interleave(k)
    load = torch.zeros(e, dtype=torch.long, device=h.device).scatter_add_(0, flat, real)
    moe.routed[0] += load
    moe.routed[1] += (load > 0).long()
    if grouped_route(h):
        routed = _experts_grouped(moe, h, choice, w, counts)
    else:
        routed = _experts_loop(moe, h, choice, w)
    return routed.to(h.dtype) + _mlp_out(moe.shared_experts, h)


def ffn(layer: MLADecoderLayer, cfg: MLAConfig, x: torch.Tensor,
        valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The post-attention half of a layer on x (B, S, D); ``valid`` (B, S)."""
    h = _rms_norm(layer.post_attention_layernorm, x, cfg.rms_norm_eps)
    if not isinstance(layer.mlp, MoE):
        return x + _mlp_out(layer.mlp, h)
    flat_valid = None if valid is None else valid.reshape(-1)
    return x + moe_forward(layer.mlp, cfg, h.reshape(-1, h.shape[-1]), flat_valid).view(h.shape)


def expert_load(lm: MLAForCausalLM) -> torch.Tensor:
    """(2, MoE layers, E) on the device: tokens routed to each expert, and the
    forwards in which it had any, since the counters were zeroed."""
    return torch.stack([moe.routed for moe in moe_blocks(lm)], dim=1)


# --------------------------------------------------------------------------- the cached paths
@torch.no_grad()
def mla_extend(lm: MLAForCausalLM, cfg: MLAConfig, inputs_embeds: torch.Tensor,
               attention_mask: torch.Tensor, cache: LatentCache,
               return_all: bool = False) -> Tuple[torch.Tensor, LatentCache]:
    """Append a right-padded (B, S, D) chunk to a filled latent cache (in
    place), as ``llama.llama_extend``: row i's fresh tokens are written at
    [len_i, len_i + S) and attend causally over the cache and each other.
    Returns (the last valid token's logits (B, V) f32, or every position's
    with ``return_all``; the cache with lengths advanced)."""
    b, s, _ = inputs_embeds.shape
    s_max = cache.kv.shape[2]
    dev = inputs_embeds.device
    valid = attention_mask.bool()
    fresh_len = valid.sum(dim=1)
    start = cache.length
    rank = valid.long().cumsum(dim=1) - 1
    pos_ids = start[:, None] + torch.where(valid, rank, s)
    cos, sin = rope_cos_sin_cfg(cfg, pos_ids)
    mask = ((pos_ids[:, :, None] - torch.arange(s_max, device=dev)[None, None]) >= 0) \
        & valid[:, :, None]
    write = start[:, None] + torch.arange(s, device=dev)[None]
    keep = write < s_max
    rows = torch.arange(b, device=dev)[:, None].expand(b, s)[keep]
    write = write[keep]
    x = inputs_embeds
    for i, layer in enumerate(lm.model.layers):
        normed = _rms_norm(layer.input_layernorm, x, cfg.rms_norm_eps)
        q_nope, q_pe = q_heads(layer, cfg, normed, cos, sin)
        cache.kv[i, rows, write] = latent_rows(layer, cfg, normed, cos, sin)[keep].to(
            cache.kv.dtype)
        attn = unabsorbed_attention(layer, cfg, q_nope, q_pe, cache.kv[i].to(x.dtype), mask)
        x = x + proj(layer.self_attn.o_proj, attn)
        x = ffn(layer, cfg, x, valid)
    new_cache = LatentCache(kv=cache.kv, length=start + fresh_len)
    if return_all:
        return _final(lm, cfg, x), new_cache
    last = x[torch.arange(b, device=dev), (fresh_len - 1).clamp(min=0)]
    return _final(lm, cfg, last[:, None])[:, 0], new_cache


@torch.no_grad()
def chunked_prefill(lm: MLAForCausalLM, cfg: MLAConfig, inputs_embeds: torch.Tensor,
                    attention_mask: torch.Tensor, cache: LatentCache,
                    lengths: Optional[Sequence[int]] = None) -> Tuple[torch.Tensor, LatentCache]:
    """Prefill an empty latent cache, the contract of ``llama.chunked_prefill``,
    in one :func:`mla_extend` over the buffer cut at the longest row's real
    length (``lengths``, host ints): the routed experts then see no padding."""
    if lengths is None:
        lengths = attention_mask.sum(dim=1).cpu().numpy()
    n = max(1, int(np.max(np.atleast_1d(np.asarray(lengths)))))
    return mla_extend(lm, cfg, inputs_embeds[:, :n], attention_mask[:, :n], cache)


@torch.no_grad()
def mla_decode_step(lm: MLAForCausalLM, cfg: MLAConfig, token_embeds: torch.Tensor,
                    cache: LatentCache) -> Tuple[torch.Tensor, LatentCache]:
    """One decode step on the dense cache: (logits (B, V) f32, cache with length + 1)."""
    mask = torch.ones(token_embeds.shape[:2], dtype=torch.bool, device=token_embeds.device)
    return mla_extend(lm, cfg, token_embeds, mask, cache)


@torch.no_grad()
def mla_forward(lm: MLAForCausalLM, cfg: MLAConfig, inputs_embeds: torch.Tensor,
                attention_mask: torch.Tensor) -> torch.Tensor:
    """Full-sequence forward of right-padded rows -> (B, S, V) f32 logits."""
    b, s, _ = inputs_embeds.shape
    cache = init_latent_cache(cfg, b, s, dtype=inputs_embeds.dtype, device=inputs_embeds.device)
    return mla_extend(lm, cfg, inputs_embeds, attention_mask, cache, return_all=True)[0]
