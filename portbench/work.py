"""Operations and bytes of the kernels and of the model step, from shapes.

Bytes count each input read once and each output written once, whatever a
kernel reads again; operations count multiply and add as two. A kernel's
least time is the larger of its bytes over the HBM rate and its operations
over the peak rate of its operand type (``harness.PEAKS``).

Each roofline operation (``portbench/ops/<op>.json``) names one function of
this module by ``work``; it takes the traced window's facts and the cell's
configuration and returns (operations, bytes) summed over that window's
launches of the operation.
"""

from __future__ import annotations

from typing import Iterable, Sequence, Tuple

BF16 = 2
F32 = 4

# --------------------------------------------------------------------------- one launch


def k1_launch(frames: int, tokens: int = 257, width: int = 1024, heads: int = 16
              ) -> Tuple[float, float]:
    """Spatial attention (K1) over ``frames`` frames of ``tokens`` tokens: the
    packed (frames, tokens, width) q, k, v in bf16 and the output."""
    e = width // heads
    ops = 4.0 * frames * heads * tokens * tokens * e
    return ops, 4.0 * frames * tokens * width * BF16


def k2_launch(windows: int, frames: int = 8, tokens: int = 257, width: int = 1024,
              heads: int = 16) -> Tuple[float, float]:
    """Temporal attention (K2) over (windows, frames, tokens): the packed
    [q | k | v] operand of 3 x width and the output, bf16."""
    e = width // heads
    ops = 4.0 * windows * tokens * heads * frames * frames * e
    return ops, windows * frames * tokens * 4 * width * BF16


def k4_launch(lengths: Sequence[int], heads: int, kv_heads: int, head_dim: int,
              pages_per_seq: int) -> Tuple[float, float]:
    """Gathered int8 paged attention (K4) of one layer: each slot's resident
    tokens read once (int8 K and V rows with one f32 scale per kv head), f32
    queries in, f32 outputs and softmax statistics out, the page table."""
    tokens = sum(int(x) for x in lengths)
    slots = len(lengths)
    per_token = 2 * kv_heads * head_dim + 2 * kv_heads * F32
    nbytes = (tokens * per_token + 2 * slots * heads * head_dim * F32
              + 2 * slots * heads * F32 + slots * pages_per_seq * 4)
    return 4.0 * tokens * heads * head_dim, float(nbytes)


# --------------------------------------------------------------------------- model steps


def tower_frame_ops(vis: dict, layers: int) -> float:
    """Operations of one frame through ``layers`` tower layers and the patch
    embedding: per layer 8 n d^2 (spatial q, k, v, out), 4 n d i (the MLP),
    4 n^2 d (spatial scores and product), and with temporal attention 8 n d^2
    (its q, k, v, out) and 4 n t d (its scores and product over t frames)."""
    d, i = vis["hidden_size"], vis["intermediate_size"]
    p = vis["patch_size"]
    g = vis["image_size"] // p
    n = g * g + 1
    per_layer = 8 * n * d * d + 4 * n * d * i + 4 * n * n * d
    if vis.get("add_time_attn"):
        t = vis["num_frames"]
        per_layer += 8 * n * d * d + 4 * n * t * d
    return float(layers * per_layer + 2 * g * g * 3 * p * p * d)


def bridge_clip_ops(br: dict, lm_width: int) -> float:
    """Operations of the RMT-R bridge over one clip: each segment's projector
    layer over [memory, tokens] (q, k, v, dense; scores and product; MLP and
    its dense), the projection to the LM width, then the retrieval."""
    d, inter, m = br["hidden_size"], br["intermediate_size"], br["num_memory_tokens"]
    segs = br["segment_topk"] + 1
    tok = br["max_frames_per_segment"] * br["pool_h"] * br["pool_w"]
    n = m + tok
    layer = 8 * n * d * d + 4 * n * n * d + 4 * n * d * inter
    total = 0.0
    for s in range(segs):
        keys = (s + 1) * m
        retrieval = 4 * m * d * d + 4 * keys * d * d + 4 * m * keys * d
        total += br["depth"] * layer + 2 * tok * d * lm_width + retrieval
    return total


def lm_token_ops(lm: dict) -> float:
    """Operations of the LM's products for one token, without attention and
    without the head."""
    d, i = lm["hidden_size"], lm["intermediate_size"]
    h, hkv = lm["num_attention_heads"], lm["num_key_value_heads"]
    dh = d // h
    per_layer = 2 * (d * h * dh + 2 * d * hkv * dh + h * dh * d + 3 * d * i)
    return float(lm["num_hidden_layers"] * per_layer)


def lm_attention_ops(lm: dict, pairs: float) -> float:
    """Scores and product over ``pairs`` (query, key) pairs in every layer."""
    d, h = lm["hidden_size"], lm["num_attention_heads"]
    return 4.0 * lm["num_hidden_layers"] * h * (d // h) * pairs


def lm_head_ops(lm: dict) -> float:
    return 2.0 * lm["hidden_size"] * lm["vocab_size"]


def prefill_ops(lm: dict, prompt_len: int) -> float:
    """A causal prefill of ``prompt_len`` tokens with the head at its last position."""
    s = prompt_len
    return s * lm_token_ops(lm) + lm_attention_ops(lm, s * (s + 1) / 2) + lm_head_ops(lm)


def decode_ops(lm: dict, context: int) -> float:
    """One token decoded at position ``context`` (it attends context + 1 keys)."""
    return lm_token_ops(lm) + lm_attention_ops(lm, context + 1) + lm_head_ops(lm)


def videollamb_admission_ops(cfg: dict, frames: int, prompt_len: int) -> float:
    """Tower, bridge and prefill of one admitted request."""
    vis = cfg["vision"]
    layers = vis["num_hidden_layers"] + vis["select_layer"] + 1
    return (frames * tower_frame_ops(vis, layers)
            + bridge_clip_ops(cfg["bridge"], cfg["lm"]["hidden_size"])
            + prefill_ops(cfg["lm"], prompt_len))


def embed_clip_ops(cfg: dict, frames: int) -> float:
    """One clip through the LanguageBind video encoder and its projection."""
    vis = cfg["vision"]
    return (frames * tower_frame_ops(vis, vis["num_hidden_layers"])
            + 2.0 * vis["hidden_size"] * cfg["projection_dim"])


# --------------------------------------------------------------------------- roofline ops
def _sum(parts: Iterable[Tuple[float, float]]) -> Tuple[float, float]:
    ops = nbytes = 0.0
    for o, b in parts:
        ops += o
        nbytes += b
    return ops, nbytes


def k1(facts: dict, cfg: dict) -> Tuple[float, float]:
    """K1 launches of the traced window: one per tower layer of each encode."""
    vis = cfg["vision"]
    g = vis["image_size"] // vis["patch_size"]
    return _sum(k1_launch(frames, g * g + 1, vis["hidden_size"], vis["num_attention_heads"])
                for frames, layers in facts.get("encodes", ()) for _ in range(layers))


def k2(facts: dict, cfg: dict) -> Tuple[float, float]:
    """K2 launches of the traced window: one per tower layer of each encode
    of more than one frame, over its windows of ``num_frames`` frames."""
    vis = cfg["vision"]
    g = vis["image_size"] // vis["patch_size"]
    t = vis["num_frames"]
    return _sum(k2_launch(frames // t, t, g * g + 1, vis["hidden_size"],
                          vis["num_attention_heads"])
                for frames, layers in facts.get("encodes", ()) if frames > 1
                for _ in range(layers))


def k4(facts: dict, cfg: dict) -> Tuple[float, float]:
    """K4 launches of the traced window: one per LM layer of each decode step,
    over every slot's resident length at that step."""
    lm = cfg["lm"]
    h, hkv = lm["num_attention_heads"], lm["num_key_value_heads"]
    dh = lm["hidden_size"] // h
    pps = facts["pages_per_seq"]
    return _sum(k4_launch(lengths, h, hkv, dh, pps)
                for lengths in facts.get("decode_lengths", ())
                for _ in range(lm["num_hidden_layers"]))
