"""Operations and bytes of the DeepSeek-V3-family LM (latent attention,
routed experts), from its configuration's shapes, as ``work.py`` counts them
for the Llama family: multiply and add count two; bytes count each input
read once and each output written once.

The admission's prefill runs attention unabsorbed (``kv_b_proj`` over every
cached row, scores over 192 dims and outputs over 128 a head); the decode
step runs it absorbed (``W_UK`` and ``W_UV`` folded into the query and the
output, scores over the 576-wide latent rows, outputs over their 512
latent dims). Every token goes through ``num_experts_per_tok`` routed
experts, the shared experts and the router in each MoE layer, the dense
MLP in the leading layers, and the head at the positions whose logits are
kept.
"""

from __future__ import annotations

from typing import Optional, Tuple

from portbench import work
from portbench.harness import HBM_BYTES_PER_S, PEAKS, load_json, op_path

BF16 = 2


def _dims(lm: dict):
    h = lm["num_attention_heads"]
    nope, rope, dv = lm["qk_nope_head_dim"], lm["qk_rope_head_dim"], lm["v_head_dim"]
    return lm["hidden_size"], h, nope, rope, dv, lm["kv_lora_rank"]


def layer_counts(lm: dict) -> Tuple[int, int]:
    """(dense layers, MoE layers)."""
    dense = lm["first_k_dense_replace"]
    return dense, lm["num_hidden_layers"] - dense


def expert_ops(lm: dict) -> float:
    """One token through one routed expert (gate, up, down)."""
    return 6.0 * lm["hidden_size"] * lm["moe_intermediate_size"]


def token_ops(lm: dict, absorbed: bool) -> float:
    """Operations of one token's products in every layer, without the
    attention over its keys and without the head."""
    d, h, nope, rope, dv, rank = _dims(lm)
    attn = 2.0 * (d * h * (nope + rope) + d * (rank + rope) + h * dv * d)
    attn += 2.0 * h * rank * (nope + dv) if absorbed else 2.0 * rank * h * (nope + dv)
    dense_l, moe_l = layer_counts(lm)
    n_exp, k = lm["n_routed_experts"], lm["num_experts_per_tok"]
    moe = (2.0 * d * n_exp + k * expert_ops(lm)
           + 6.0 * d * lm["moe_intermediate_size"] * lm["n_shared_experts"])
    return lm["num_hidden_layers"] * attn + dense_l * 6.0 * d * lm["intermediate_size"] \
        + moe_l * moe


def attention_ops(lm: dict, pairs: float, absorbed: bool) -> float:
    """Scores and outputs over ``pairs`` (query, key) pairs in every layer."""
    d, h, nope, rope, dv, rank = _dims(lm)
    per = 2.0 * h * ((rank + rope) + rank) if absorbed else 2.0 * h * ((nope + rope) + dv)
    return lm["num_hidden_layers"] * per * pairs


def prefill_ops(lm: dict, prompt_len: int) -> float:
    """A causal prefill, unabsorbed, with the head at its last position."""
    s = prompt_len
    return (s * token_ops(lm, absorbed=False) + attention_ops(lm, s * (s + 1) / 2, False)
            + work.lm_head_ops(lm))


def decode_ops(lm: dict, context: int) -> float:
    """One token decoded at position ``context``, absorbed (context + 1 keys)."""
    return token_ops(lm, absorbed=True) + attention_ops(lm, context + 1, True) \
        + work.lm_head_ops(lm)


def admission_ops(cfg: dict, frames: int, prompt_len: int) -> float:
    """Tower, bridge and prefill of one admitted request."""
    vis = cfg["vision"]
    layers = vis["num_hidden_layers"] + vis["select_layer"] + 1
    return (frames * work.tower_frame_ops(vis, layers)
            + work.bridge_clip_ops(cfg["bridge"], cfg["lm"]["hidden_size"])
            + prefill_ops(cfg["lm"], prompt_len))


# --------------------------------------------------------------------------- roofline ops
def experts(facts: dict, cfg: dict) -> Tuple[float, float]:
    """The routed experts' grouped products over the traced steps, from the
    engine's expert counters read around each step call: operations of every
    routed token; bytes of each expert's weights once per forward in which
    it had a token, and of every routed row's input, intermediate and output."""
    loads = facts.get("expert_load") or ()
    if not loads:
        return 0.0, 0.0
    lm = cfg["lm"]
    d, inter = lm["hidden_size"], lm["moe_intermediate_size"]
    ops = nbytes = 0.0
    for load in loads:
        tokens, touched = float(load[0].sum()), float(load[1].sum())
        ops += tokens * expert_ops(lm)
        nbytes += touched * 3 * d * inter * BF16 + tokens * (2 * d + 3 * inter) * BF16
    return ops, nbytes


def roofline(view, op: str) -> Optional[float]:
    """``readers.roofline`` for an operation whose work this module counts."""
    if view.trace is None or not hasattr(view.cell, "trace_facts"):
        return None
    spec = load_json(op_path(op))
    ops, nbytes = globals()[spec["work"]](view.cell.trace_facts(view.trace.attempt), view.cfg)
    kernel_s = view.trace.matching(spec["kernels"])
    if ops <= 0 or kernel_s <= 0:
        return None
    least = max(nbytes / HBM_BYTES_PER_S, ops / PEAKS[spec["peak"]])
    return 100.0 * least / kernel_s
