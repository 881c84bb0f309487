"""RMT-R Memory Bridge: recurrent-memory projector with memory retrieval.

Port of ``videollamb_tpu/models/bridge/rmt_r.py`` (reference
rmt_r_transformer_projector.py:186-402 and self_retriever.py:188-248):
the video and image paths, and the streaming step with carried state.

SceneTilling cuts the video at its top-k (3) depth minima into 4 segments
of at most 8 subsampled frames, pooled to 12 x 12 tokens each. The
segments run in order through the projector with 32 carried memory tokens:
the first segment reads ``read_memory_emb``, each later one the memory
left by the previous step; after every step the memory is appended to a
cache and refreshed by a cross-attention over the filled part of it. The
LM consumes only the final segment's projected tokens. Padded frame slots
are masked, so the shapes are static. Given a ``torch.Generator``, the
video forward runs in training mode (the bridge's dropout, drawn from it);
the cache of memories is built without writes in place, so autograd
reaches every segment's memory.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from videollamb_torch.config import BridgeConfig
from videollamb_torch.models.bridge.layers import (
    RetrieverLayer,
    TransformerLayer,
    _act,
    _dense,
    cross_only_layer,
    transformer_layer,
)
from videollamb_torch.models.seeded import empty_module, fill_dense_, generator
from videollamb_torch.ops.pooling import pool_frame_tokens
from videollamb_torch.ops.scene_tilling import segment_plan, segment_topk


class BridgeOutput(NamedTuple):
    tokens: torch.Tensor       # (F*P, lm_d) final-segment projected tokens
    token_mask: torch.Tensor   # (F*P,)
    all_tokens: torch.Tensor   # (S, F*P, lm_d)
    all_masks: torch.Tensor    # (S, F*P)
    memory: torch.Tensor       # (M, d) final memory


class TransformerProjector(nn.Module):
    def __init__(self, cfg: BridgeConfig, lm_hidden_size: int):
        super().__init__()
        d = cfg.hidden_size
        self.layers = nn.ModuleList(
            TransformerLayer(d, cfg.intermediate_size) for _ in range(cfg.depth))
        self.proj = nn.Sequential(nn.Linear(d, lm_hidden_size))
        self.read_memory_emb = nn.Parameter(torch.empty(cfg.num_memory_tokens, d))
        self.memory_tokens = nn.Parameter(torch.empty(cfg.num_memory_tokens, d))


class Retriever(nn.Module):
    def __init__(self, cfg: BridgeConfig):
        super().__init__()
        self.layers = nn.ModuleList([RetrieverLayer(cfg.hidden_size)])


class RMTRBridge(nn.Module):
    """``mm_projector`` root: ``projector.*`` and ``retrieval.*`` parameters."""

    def __init__(self, cfg: BridgeConfig, lm_hidden_size: int):
        super().__init__()
        self.projector = TransformerProjector(cfg, lm_hidden_size)
        self.retrieval = Retriever(cfg)


def _dropouts(cfg: BridgeConfig, generator: Optional[torch.Generator]) -> dict:
    return dict(attn_dropout=cfg.attention_probs_dropout_prob,
                hidden_dropout=cfg.hidden_dropout_prob, generator=generator)


def projector_pass(projector: TransformerProjector, cfg: BridgeConfig,
                   tokens: torch.Tensor, token_mask: Optional[torch.Tensor],
                   read_memories: torch.Tensor,
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack [memories, tokens], run the layers, unpack, project.

    tokens (b, N, d), token_mask (b, N) or None, read_memories (b, M, d)
    -> (projected tokens (b, N, lm_d), new memories (b, M, d)).
    """
    b = tokens.shape[0]
    m = cfg.num_memory_tokens
    x = torch.cat([read_memories.to(tokens.dtype), tokens], dim=1)
    key_mask = None
    if token_mask is not None:
        ones = torch.ones((b, m), dtype=torch.bool, device=tokens.device)
        key_mask = torch.cat([ones, token_mask.bool()], dim=1)
    for layer in projector.layers:
        x = transformer_layer(layer, x, num_heads=cfg.num_attention_heads,
                              eps=cfg.layer_norm_eps, act=cfg.hidden_act,
                              key_mask=key_mask, **_dropouts(cfg, generator))
    new_memories, hidden = x[:, :m], x[:, m:]
    return _act(cfg.hidden_act, _dense(projector.proj[0], hidden)), new_memories


def retrieve(retrieval: Retriever, cfg: BridgeConfig, memories: torch.Tensor,
             cache: torch.Tensor, cache_mask: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Cross-attend the memories over the masked cache of past memories."""
    x = memories
    for layer in retrieval.layers:
        x = cross_only_layer(layer, x, num_heads=cfg.num_attention_heads,
                             eps=cfg.layer_norm_eps, encoder_hidden=cache,
                             encoder_key_mask=cache_mask, **_dropouts(cfg, generator))
    return x


def pool_and_split(features: torch.Tensor, cfg: BridgeConfig):
    """(t, n, d) features, CLS first -> cls (t, d), pooled (t, P, d)."""
    patches = features[:, 1:]
    grid = int(round(patches.shape[1] ** 0.5))
    return features[:, 0], pool_frame_tokens(patches, grid, cfg.pool_h, cfg.pool_w)


def rmt_r_video_forward(bridge: RMTRBridge, cfg: BridgeConfig, features: torch.Tensor,
                        generator: Optional[torch.Generator] = None) -> BridgeOutput:
    """Memory Bridge over one video's (t, n, d) tower features; dropout on
    when a ``generator`` is given."""
    d = cfg.hidden_size
    m = cfg.num_memory_tokens
    f = cfg.max_frames_per_segment
    p = cfg.tokens_per_frame
    s = cfg.max_segments

    cls_states, pooled = pool_and_split(features, cfg)
    bounds = segment_topk(cls_states, k=cfg.segment_topk)
    frame_idx, frame_mask = segment_plan(bounds, max_frames=f)  # (S, F)
    seg_tokens = pooled[frame_idx].reshape(s, f * p, d)
    seg_mask = frame_mask.repeat_interleave(p, dim=1)  # (S, F*P)
    seg_tokens = torch.where(seg_mask[..., None], seg_tokens, 0.0).to(pooled.dtype)

    projector = bridge.projector
    mem = projector.read_memory_emb[None].to(seg_tokens.dtype)
    slots = torch.arange(s * m, device=features.device)
    entries = []  # the cache: each step's memory, the unwritten rest zeros
    all_proj = []
    for step in range(s):
        proj, mem_out = projector_pass(projector, cfg, seg_tokens[step][None],
                                       seg_mask[step][None], mem, generator)
        entries.append(mem_out)
        cache = torch.cat(entries + [mem_out.new_zeros((1, (s - step - 1) * m, d))], dim=1)
        cache_mask = (slots < (step + 1) * m)[None]
        mem = retrieve(bridge.retrieval, cfg, mem_out, cache, cache_mask, generator)
        all_proj.append(proj[0])
    all_proj = torch.stack(all_proj)
    return BridgeOutput(tokens=all_proj[-1], token_mask=seg_mask[-1],
                        all_tokens=all_proj, all_masks=seg_mask, memory=mem[0])


class StreamBridgeState(NamedTuple):
    """Carry of the streaming bridge: the recurrent memory, a bounded ring of
    past segment memories for retrieval, and the segments seen (a device
    scalar, so a step needs no host read)."""

    memory: torch.Tensor  # (1, M, d)
    cache: torch.Tensor   # (1, S_cache*M, d)
    count: torch.Tensor   # () int64


def init_stream_state(cfg: BridgeConfig, dtype=torch.float32, cache_segments: int = 32,
                      device="cpu") -> StreamBridgeState:
    d, m = cfg.hidden_size, cfg.num_memory_tokens
    return StreamBridgeState(
        memory=torch.zeros((1, m, d), dtype=dtype, device=device),
        cache=torch.zeros((1, cache_segments * m, d), dtype=dtype, device=device),
        count=torch.zeros((), dtype=torch.long, device=device))


@torch.no_grad()
def rmt_r_stream_step(bridge: RMTRBridge, cfg: BridgeConfig, features: torch.Tensor,
                      frame_mask: torch.Tensor, state: StreamBridgeState
                      ) -> Tuple[torch.Tensor, torch.Tensor, StreamBridgeState]:
    """One segment of the Memory Bridge recurrence with carried state.

    ``features`` (F, n, d) are one segment's tower features, ``frame_mask``
    (F,) its valid frames. The math of one step of
    :func:`rmt_r_video_forward`, except that the retrieval cache is a ring:
    once full it rolls left by one segment, so retrieval covers the newest
    ``cache_segments`` memories (a live stream needs constant memory).

    Returns (tokens (F*P, lm_d), token_mask (F*P,), new state).
    """
    f = features.shape[0]
    m = cfg.num_memory_tokens
    p = cfg.tokens_per_frame
    d = cfg.hidden_size
    s_cache = state.cache.shape[1] // m

    _, pooled = pool_and_split(features, cfg)  # (F, P, d)
    tmask = frame_mask.bool().repeat_interleave(p)[None]  # (1, F*P)
    tokens = torch.where(tmask[..., None], pooled.reshape(1, f * p, d), 0.0)

    projector = bridge.projector
    first = state.count == 0
    mem_in = torch.where(first, projector.read_memory_emb[None].to(tokens.dtype), state.memory)
    proj, mem_out = projector_pass(projector, cfg, tokens, tmask, mem_in)

    cache = torch.where(state.count >= s_cache, torch.roll(state.cache, -m, dims=1), state.cache)
    slot = torch.clamp(state.count, max=s_cache - 1)
    rows = slot * m + torch.arange(m, device=cache.device)
    cache = cache.index_copy(1, rows, mem_out.to(cache.dtype))
    n_valid = torch.clamp(state.count + 1, max=s_cache)
    cache_mask = (torch.arange(s_cache * m, device=cache.device) < n_valid * m)[None]
    mem_new = retrieve(bridge.retrieval, cfg, mem_out, cache, cache_mask)
    return proj[0], tmask[0], StreamBridgeState(memory=mem_new, cache=cache,
                                                count=state.count + 1)


def rmt_r_image_forward(bridge: RMTRBridge, cfg: BridgeConfig,
                        features: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Image path: one bridge pass over the pooled (b, n, d) features.

    Returns (b, P, lm_d) projected tokens and (b, M, d) memories.
    """
    b = features.shape[0]
    _, pooled = pool_and_split(features, cfg)
    read = bridge.projector.read_memory_emb[None].to(pooled.dtype).expand(
        b, cfg.num_memory_tokens, cfg.hidden_size)
    return projector_pass(bridge.projector, cfg, pooled, None, read)


def fill_bridge_(module: nn.Module, g: torch.Generator) -> nn.Module:
    """Random weights drawn from ``g`` for a projector of any kind (in place):
    uniform Linear weights of variance 1/fan_in and small uniform biases,
    N(0, 1) memory tokens, zero ``read_memory_emb`` and ``query_tokens`` (as
    the JAX package sets them), unit LayerNorms."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            if "layernorm" in name:
                p.fill_(1.0 if name.endswith("weight") else 0.0)
            elif name.endswith(("read_memory_emb", "query_tokens")):
                p.zero_()
            elif name.endswith("memory_tokens"):
                p.normal_(0.0, 1.0, generator=g)
            elif name.endswith("bias"):
                limit = 1.0 / p.shape[0] ** 0.5
                p.uniform_(-limit, limit, generator=g)
            else:
                fill_dense_(p, g)
    return module


def init_rmt_r_params(cfg: BridgeConfig, lm_hidden_size: int, *, seed: int = 0,
                      dtype=torch.float32, device="cpu") -> RMTRBridge:
    """Bridge with seeded random weights (:func:`fill_bridge_`)."""
    return fill_bridge_(empty_module(lambda: RMTRBridge(cfg, lm_hidden_size), device, dtype),
                        generator(device, seed))
