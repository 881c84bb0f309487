"""VideoLLaMB: video tower -> SceneTilling -> RMT-R Memory Bridge -> splice -> LM.

Written from the VideoLLaMB paper and the reference repository
(``llava/model/llava_arch.py:187-195, 331-338``,
``multimodal_projector/rmt_r_transformer_projector.py:186-402``,
``self_retriever.py:188-248``, ``self_segment.py``), with the LM of the
configuration (Mistral-7B: GQA, RoPE, RMSNorm, SiLU MLP, a sliding window).

- The tower runs its first ``len + select_layer + 1`` layers (select -2).
- SceneTilling: cosine similarity of adjacent frames' class tokens, depth
  = left peak + right peak - 2 sim (each peak the top of the monotone run
  beside the position), the top-k depths (ties to the lower index), then the
  last frame; each segment subsampled to at most 8 frames
  (``start + trunc(j * span / (n - 1))`` in float32).
- Every frame's patch grid is average-pooled to 12 x 12.
- The bridge runs the segments in order with 32 memory tokens: a post-LN
  transformer layer over [memory, segment tokens] (masked frames are
  masked keys), a projection to the LM width with GELU, then a retrieval
  cross-attention of the new memory over all memories so far. The LM gets
  the last segment's valid tokens in place of the video sentinel.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F

from portbench.reference import clip_tower
from portbench.reference.linear import (
    Weights,
    gelu,
    layer_norm,
    rms_norm,
    softmax_attention,
)

NEG_INF = -1e30


# --------------------------------------------------------------------------- SceneTilling
def depth_scores(sim: Sequence[float]) -> List[float]:
    """lpeak + rpeak - 2 sim, the peaks carried along monotone runs."""
    n = len(sim)
    left, right = [0.0] * n, [0.0] * n
    for i in range(n):
        left[i] = left[i - 1] if i and sim[i - 1] >= sim[i] else sim[i]
    for i in reversed(range(n)):
        right[i] = right[i + 1] if i < n - 1 and sim[i + 1] >= sim[i] else sim[i]
    return [left[i] + right[i] - 2.0 * sim[i] for i in range(n)]


def scene_depths(cls: torch.Tensor) -> List[float]:
    """(T, D) class tokens -> the T - 1 depth scores of adjacent-frame cosines."""
    a, b = cls[:-1].double(), cls[1:].double()
    na = torch.linalg.norm(a, dim=-1).clamp(min=1e-8)
    nb = torch.linalg.norm(b, dim=-1).clamp(min=1e-8)
    return depth_scores(((a * b).sum(-1) / (na * nb)).tolist())


def scene_bounds(cls: torch.Tensor, k: int) -> List[int]:
    """(T, D) class tokens -> k + 1 sorted segment ends, the last T - 1."""
    depth = scene_depths(cls)
    order = sorted(range(len(depth)), key=lambda i: (-depth[i], i))
    return sorted(order[:k]) + [cls.shape[0] - 1]


def bounds_margin(cls: torch.Tensor, k: int) -> float:
    """How far the k-th largest depth stands above the next, as a share of it:
    near 0 the choice of boundaries is a near-tie that rounding can flip."""
    depth = sorted(scene_depths(cls), reverse=True)
    return (depth[k - 1] - depth[k]) / depth[k - 1] if len(depth) > k and depth[k - 1] > 0 else 1.0


def segment_frames(bounds: Sequence[int], max_frames: int) -> List[List[int]]:
    """Each segment's subsampled frame indices."""
    out, start = [], 0
    for end in bounds:
        n = min(end - start + 1, max_frames)
        step = torch.tensor(float(end - start)) / torch.tensor(float(max(n - 1, 1)))
        idx = [int(torch.tensor(float(start)) + torch.tensor(float(j)) * step) for j in range(n)]
        out.append(idx)
        start = end + 1
    return out


def pool_grid(patches: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(T, g*g, D) -> (T, out_h*out_w, D): adaptive average pooling of each grid."""
    t, n, d = patches.shape
    g = int(round(n ** 0.5))
    x = patches.reshape(t, g, g, d).permute(0, 3, 1, 2)
    return F.adaptive_avg_pool2d(x, (out_h, out_w)).permute(0, 2, 3, 1).reshape(t, -1, d)


# --------------------------------------------------------------------------- the bridge
def _bridge_attention(w: Weights, prefix: str, hidden: torch.Tensor, heads: int, eps: float,
                      kv: Optional[torch.Tensor] = None,
                      key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Post-LN attention: LN(dense(attn(hidden, kv)) + hidden)."""
    kv = hidden if kv is None else kv
    s, d = hidden.shape
    e = d // heads
    q = w.linear(hidden, prefix + ".q_proj").reshape(s, heads, e).transpose(0, 1)
    k = w.linear(kv, prefix + ".k_proj").reshape(kv.shape[0], heads, e).transpose(0, 1)
    v = w.linear(kv, prefix + ".v_proj").reshape(kv.shape[0], heads, e).transpose(0, 1)
    bias = None
    if key_mask is not None:
        bias = torch.where(key_mask, 0.0, NEG_INF)[None, None]
    out = softmax_attention(q, k, v, bias, scale=1.0 / math.sqrt(e)).transpose(0, 1).reshape(s, d)
    return layer_norm(w.linear(out, prefix + ".residual.dense") + hidden, w,
                      prefix + ".residual.layernorm", eps)


def _projector_pass(w: Weights, cfg: dict, tokens: torch.Tensor, token_mask: torch.Tensor,
                    memory: torch.Tensor):
    """[memory, tokens] through the projector layers -> (projected tokens, new memory)."""
    root = "mm_projector.projector"
    m = memory.shape[0]
    x = torch.cat([memory, tokens])
    key_mask = torch.cat([torch.ones(m, dtype=torch.bool, device=x.device), token_mask])
    heads, eps = cfg["num_attention_heads"], cfg["layer_norm_eps"]
    for i in range(cfg["depth"]):
        p = f"{root}.layers.{i}"
        h = _bridge_attention(w, p + ".selfattention", x, heads, eps, key_mask=key_mask)
        inter = gelu(w.linear(h, p + ".mlp.0"))
        x = layer_norm(w.linear(inter, p + ".residual.dense") + h, w, p + ".residual.layernorm",
                       eps)
    return gelu(w.linear(x[m:], root + ".proj.0")), x[:m]


def bridge(w: Weights, cfg: dict, feats: torch.Tensor):
    """One video's (T, 1 + N, D) tower features -> (the last segment's valid
    tokens (n, lm_d), the segment ends)."""
    d = feats.shape[-1]
    f, ph, pw = cfg["max_frames_per_segment"], cfg["pool_h"], cfg["pool_w"]
    p = ph * pw
    bounds = scene_bounds(feats[:, 0], cfg["segment_topk"])
    pooled = pool_grid(feats[:, 1:], ph, pw)
    memory = w("mm_projector.projector.read_memory_emb")
    memories = []
    heads, eps = cfg["num_attention_heads"], cfg["layer_norm_eps"]
    for idx in segment_frames(bounds, f):
        n = len(idx)
        tokens = torch.zeros(f * p, d, device=feats.device)
        tokens[:n * p] = pooled[idx].reshape(n * p, d)
        mask = torch.arange(f * p, device=feats.device) < n * p
        projected, new_memory = _projector_pass(w, cfg, tokens, mask, memory)
        memories.append(new_memory)
        memory = _bridge_attention(w, "mm_projector.retrieval.layers.0.crossattention",
                                   new_memory, heads, eps, kv=torch.cat(memories))
        last = projected[:n * p]
    return last, bounds


# --------------------------------------------------------------------------- the LM
def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half RoPE on (S, H, Dh)."""
    dh = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, dh, 2, dtype=torch.float64, device=x.device) / dh)
    ang = positions.double()[:, None] * inv[None]
    cos = torch.cat([ang.cos(), ang.cos()], -1).float()[:, None]
    sin = torch.cat([ang.sin(), ang.sin()], -1).float()[:, None]
    half = dh // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos + rot * sin


def lm_logits(w: Weights, cfg: dict, embeds: torch.Tensor, first: int,
              q_block: int = 512) -> torch.Tensor:
    """Causal LM over (S, D) input embeddings -> float32 logits (S - first, V)
    of positions first .. S - 1."""
    s, d = embeds.shape
    h, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    dh = d // h
    window = cfg.get("sliding_window")
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    pos = torch.arange(s, device=embeds.device)
    dist = pos[:, None] - pos[None]
    allowed = dist >= 0
    if window is not None:
        allowed &= dist < window
    bias = torch.where(allowed, 0.0, NEG_INF)
    x = embeds.float()
    for i in range(cfg["num_hidden_layers"]):
        p = f"lm.model.layers.{i}"
        hn = rms_norm(x, w(p + ".input_layernorm.weight"), eps)
        q = _rope(w.linear(hn, p + ".self_attn.q_proj", bias=False).reshape(s, h, dh), pos, theta)
        k = _rope(w.linear(hn, p + ".self_attn.k_proj", bias=False).reshape(s, hkv, dh), pos, theta)
        v = w.linear(hn, p + ".self_attn.v_proj", bias=False).reshape(s, hkv, dh)
        k = k.repeat_interleave(h // hkv, dim=1).transpose(0, 1)
        v = v.repeat_interleave(h // hkv, dim=1).transpose(0, 1)
        q = q.transpose(0, 1)
        out = torch.cat([softmax_attention(q[:, lo:lo + q_block], k, v, bias[lo:lo + q_block],
                                           scale=dh ** -0.5)
                         for lo in range(0, s, q_block)], dim=1)
        x = x + w.linear(out.transpose(0, 1).reshape(s, h * dh), p + ".self_attn.o_proj",
                         bias=False)
        hn = rms_norm(x, w(p + ".post_attention_layernorm.weight"), eps)
        gate = F.silu(w.linear(hn, p + ".mlp.gate_proj", bias=False))
        up = w.linear(hn, p + ".mlp.up_proj", bias=False)
        x = x + w.linear(gate * up, p + ".mlp.down_proj", bias=False)
    x = rms_norm(x[first:], w("lm.model.norm.weight"), eps)
    return w.linear(x, "lm.lm_head", bias=False)


# --------------------------------------------------------------------------- one request
@dataclass
class Scored:
    """The reference's logits at each served position: ``logits[i]`` is the
    distribution the i-th served token was drawn from."""

    logits: torch.Tensor      # (n_served, V)
    bounds: List[int]
    prompt_len: int
    margin: float             # bounds_margin of the clip


def splice_embeds(w: Weights, ids: Sequence[int], visual: torch.Tensor) -> torch.Tensor:
    """Text ids with one negative sentinel -> (S, D): the visual tokens in its place."""
    table = w.tensors["lm.model.embed_tokens.weight"]
    at = [i for i, t in enumerate(ids) if t < 0]
    if len(at) != 1:
        raise ValueError(f"a prompt holds one video sentinel; got {len(at)}")
    dev = visual.device
    before = table[torch.tensor(list(ids[:at[0]]), dtype=torch.long, device=table.device)]
    after = table[torch.tensor(list(ids[at[0] + 1:]), dtype=torch.long, device=table.device)]
    before, after = before.to(dev).float(), after.to(dev).float()
    return torch.cat([before, visual.float(), after])


def score_request(w: Weights, cfg: dict, ids: Sequence[int], video: torch.Tensor,
                  served: Sequence[int]) -> Scored:
    """The reference over one request's prompt (text ids with a sentinel and its
    (T, 3, H, W) clip) followed by its served tokens."""
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
    logits = lm_logits(w, cfg["lm"], seq, plen - 1)
    return Scored(logits=logits, bounds=bounds, prompt_len=plen, margin=margin)
