"""VideoLLaMB over a DeepSeek-V3-family LM (Moonlight-16B-A3B): the tower,
SceneTilling, the RMT-R bridge and the splice of ``videollamb.py``, then an
LM with multi-head latent attention and sigmoid-routed experts.

Written from DeepSeek-V3's published modeling code
(``modeling_deepseek.py``: ``DeepseekV3Attention``, ``MoEGate``,
``DeepseekV3MoE``, ``apply_rotary_pos_emb``) at Moonlight's settings (no q
compression, one routing group, ``noaux_tc``, no rope scaling).

Departures from the published code, none of which changes the function:

- float32 throughout with TF32 off (the model runs bf16); every dense
  product goes through ``linear.Weights``, so the float8 control rounds its
  operands as it does the other references';
- no cache: one causal forward over the prompt and the served tokens,
  attention unabsorbed (``kv_b_proj`` expands the latent to every head's
  keys and values) and computed in blocks of queries;
- the group-limited selection is left out: with ``n_group = topk_group =
  1`` its mask keeps every expert;
- the routed experts run as a loop over the experts, each over the tokens
  that chose it, with no batching; the weighted sum is taken per token.

``score_request`` also reports how near routing came to a tie: the
smallest margin, over every token and MoE layer, between the 6th and the
7th largest of the biased scores, and how many choices fell under
``NEAR_TIE``. Routing is discrete: a choice within the program's rounding of
the router's input can flip, and the flip moves that token's output by a
whole expert's share.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Sequence

import torch
import torch.nn.functional as F

from portbench.reference import clip_tower
from portbench.reference.linear import Weights, rms_norm, softmax_attention
from portbench.reference.videollamb import bounds_margin, bridge, splice_embeds

NEG_INF = -1e30
# A sigmoid score moves by at most a quarter of its logit's change; the
# program's router reads a bf16 hidden state, whose rounding (2 ** -8
# relative) moves the logits by a few hundredths at this width, so a 6th
# choice less than 0.01 above the 7th can flip there.
NEAR_TIE = 0.01


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """The published RoPE on (S, H, d): de-interleave the dims
    (``view(d / 2, 2).transpose``), then rotate half."""
    s, h, d = x.shape
    x = x.reshape(s, h, d // 2, 2).transpose(-1, -2).reshape(s, h, d)
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float64, device=x.device) / d)
    ang = positions.double()[:, None] * inv[None]
    cos = torch.cat([ang.cos(), ang.cos()], -1).float()[:, None]
    sin = torch.cat([ang.sin(), ang.sin()], -1).float()[:, None]
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * cos + rot * sin


def _mlp(w: Weights, prefix: str, x: torch.Tensor) -> torch.Tensor:
    gate = F.silu(w.linear(x, prefix + ".gate_proj", bias=False))
    return w.linear(gate * w.linear(x, prefix + ".up_proj", bias=False), prefix + ".down_proj",
                    bias=False)


def _attention(w: Weights, cfg: dict, p: str, hn: torch.Tensor, pos: torch.Tensor,
               bias: torch.Tensor, q_block: int) -> torch.Tensor:
    s = hn.shape[0]
    h = cfg["num_attention_heads"]
    nope, rope, dv = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    rank = cfg["kv_lora_rank"]
    q = w.linear(hn, p + ".q_proj", bias=False).reshape(s, h, nope + rope)
    q_nope, q_pe = q[..., :nope], q[..., nope:]
    ckv = w.linear(hn, p + ".kv_a_proj_with_mqa", bias=False)
    latent, k_pe = ckv[:, :rank], ckv[:, rank:]
    latent = rms_norm(latent, w(p + ".kv_a_layernorm.weight"), cfg["rms_norm_eps"])
    kv = w.linear(latent, p + ".kv_b_proj", bias=False).reshape(s, h, nope + dv)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    theta = cfg["rope_theta"]
    q_pe = _rope(q_pe, pos, theta)
    k_pe = _rope(k_pe[:, None], pos, theta).expand(s, h, rope)
    query = torch.cat([q_nope, q_pe], -1).transpose(0, 1)
    key = torch.cat([k_nope, k_pe], -1).transpose(0, 1)
    v = v.transpose(0, 1)
    scale = (nope + rope) ** -0.5
    out = torch.cat([softmax_attention(query[:, lo:lo + q_block], key, v, bias[lo:lo + q_block],
                                       scale=scale) for lo in range(0, s, q_block)], dim=1)
    return w.linear(out.transpose(0, 1).reshape(s, h * dv), p + ".o_proj", bias=False)


@dataclass
class Routing:
    margin_min: float = math.inf  # smallest 6th-over-7th margin of the biased scores
    near_ties: int = 0            # choices whose margin is under NEAR_TIE
    choices: int = 0              # (token, MoE layer) choices made


def _moe(w: Weights, cfg: dict, p: str, hn: torch.Tensor, routing: Routing) -> torch.Tensor:
    k, n_exp = cfg["num_experts_per_tok"], cfg["n_routed_experts"]
    scores = torch.sigmoid(w.linear(hn, p + ".gate", bias=False))
    biased = scores + w(p + ".gate.e_score_correction_bias")
    ranked = torch.sort(biased, dim=-1, descending=True).values
    margin = ranked[:, k - 1] - ranked[:, k]
    routing.margin_min = min(routing.margin_min, float(margin.min()))
    routing.near_ties += int((margin < NEAR_TIE).sum())
    routing.choices += int(margin.numel())
    top = torch.topk(biased, k, dim=-1).indices
    weight = scores.gather(1, top)
    if cfg["norm_topk_prob"] and k > 1:
        weight = weight / (weight.sum(dim=-1, keepdim=True) + 1e-20)
    weight = weight * cfg["routed_scaling_factor"]
    out = torch.zeros_like(hn)
    for e in range(n_exp):
        chose = top == e
        tok = chose.any(dim=-1).nonzero()[:, 0]
        if tok.numel():
            share = (weight * chose).sum(dim=-1)[tok, None]
            out[tok] += _mlp(w, f"{p}.experts.{e}", hn[tok]) * share
    return out + _mlp(w, p + ".shared_experts", hn)


def lm_logits(w: Weights, cfg: dict, embeds: torch.Tensor, first: int, q_block: int = 512,
              routing: Routing = None) -> torch.Tensor:
    """Causal LM over (S, D) input embeddings -> float32 logits (S - first, V)
    of positions first .. S - 1; ``routing`` collects the near-tie counts."""
    routing = Routing() if routing is None else routing
    s = embeds.shape[0]
    eps = cfg["rms_norm_eps"]
    pos = torch.arange(s, device=embeds.device)
    bias = torch.where(pos[:, None] >= pos[None], 0.0, NEG_INF)
    x = embeds.float()
    for i in range(cfg["num_hidden_layers"]):
        p = f"lm.model.layers.{i}"
        hn = rms_norm(x, w(p + ".input_layernorm.weight"), eps)
        x = x + _attention(w, cfg, p + ".self_attn", hn, pos, bias, q_block)
        hn = rms_norm(x, w(p + ".post_attention_layernorm.weight"), eps)
        if i >= cfg["first_k_dense_replace"]:
            x = x + _moe(w, cfg, p + ".mlp", hn, routing)
        else:
            x = x + _mlp(w, p + ".mlp", hn)
    x = rms_norm(x[first:], w("lm.model.norm.weight"), eps)
    return w.linear(x, "lm.lm_head", bias=False)


@dataclass
class Scored:
    """As ``videollamb.Scored``, with the routing's near-tie counts."""

    logits: torch.Tensor      # (n_served, V)
    bounds: List[int]
    prompt_len: int
    margin: float             # bounds_margin of the clip
    routing: Routing


def score_request(w: Weights, cfg: dict, ids: Sequence[int], video: torch.Tensor,
                  served: Sequence[int]) -> Scored:
    """The reference over one request's prompt (text ids with a sentinel and
    its (T, 3, H, W) clip) followed by its served tokens."""
    vis = cfg["vision"]
    n_layers = vis["num_hidden_layers"] + vis["select_layer"] + 1 if vis["select_layer"] < 0 \
        else vis["select_layer"]
    feats = clip_tower.encode(w, "video_tower.vision_model", video[None], vis, n_layers)[0]
    tokens, bounds = bridge(w, cfg["bridge"], feats)
    margin = bounds_margin(feats[:, 0], cfg["bridge"]["segment_topk"])
    prompt = splice_embeds(w, ids, tokens)
    plen = prompt.shape[0]
    if plen > cfg["max_length"]:
        raise ValueError(f"spliced prompt of {plen} tokens exceeds max_length")
    table = w.tensors["lm.model.embed_tokens.weight"]
    answer = table[torch.tensor(list(served[:-1]), device=table.device, dtype=torch.long)]
    seq = torch.cat([prompt, answer.to(prompt.device).float()])
    routing = Routing()
    logits = lm_logits(w, cfg["lm"], seq, plen - 1, routing=routing)
    return Scored(logits=logits, bounds=bounds, prompt_len=plen, margin=margin, routing=routing)
