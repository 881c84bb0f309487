"""Speculative decoding: prompt lookup and a draft model, greedy-exact.

Port of ``videollamb_tpu/models/speculative.py``. Candidate continuations
come from matching the last n-gram of the context against earlier context
(prompt lookup) or from a draft LM (for instance an int8 copy of the target),
and are verified in ONE cache-extend forward of the target.

- Verification reuses :func:`llama_extend`: the chunk is written into the
  running KV cache at its true positions, and a rejected suffix is rolled
  back by shrinking ``cache.length`` only. Slots past the length are never
  attended and are overwritten by the next write.
- A verify step reads every weight once, like a decode step, so on a card
  whose decode is bound by weight reads the tokens per weight read rise with
  the mean accepted length.
- The output is the target's greedy chain: acceptance keeps only tokens that
  match its argmax. That is exact in f32 (the tests assert it token for
  token, rollbacks included). In bf16 a verify step (S = k) and a decode
  step (S = 1) run products of different shapes, and with int4 weights
  kernel K7 at a different M, so an argmax near a tie may break differently
  and the chains may part there.

As elsewhere in the port, the caches are written in place; a function
returns the cache with its new ``length``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from videollamb_torch.config import LlamaConfig
from videollamb_torch.models.lm.llama import (
    KVCache,
    embed_tokens,
    llama_decode_step,
    llama_extend,
)


def propose_lookup(context: List[int], ngram: int = 3, k: int = 8) -> List[int]:
    """Most recent earlier occurrence of the final ``ngram`` tokens -> up to
    ``k`` tokens that followed it. Falls back to shorter n-grams; [] if
    nothing hits."""
    for n in range(ngram, 0, -1):
        if len(context) <= n:
            continue
        tail = context[-n:]
        # Search right to left, excluding the tail occurrence itself.
        for start in range(len(context) - n - 1, -1, -1):
            if context[start: start + n] == tail:
                cont = context[start + n: start + n + k]
                if cont:
                    return cont
                break
    return []


def _with_length(cache: KVCache, length: torch.Tensor) -> KVCache:
    return KVCache(k=cache.k, v=cache.v, length=length)


@torch.no_grad()
def verify_chunks_batched(model, cfg, chunks: torch.Tensor, chunk_mask: torch.Tensor,
                          cache: KVCache):
    """Batched greedy verification for the continuous-batching engine.

    chunks (B, k): ``[:, 0]`` is each row's committed-next token, the rest
    its proposals; chunk_mask (B, k): 1 = real token. One ragged cache-extend
    writes every slot's chunk at its own length, the longest argmax-matching
    prefix per row is accepted, and lengths roll back to start + accepted.

    Returns (accepted (B,), next_logits (B, V), next_argmax (B,), cache).
    ``accepted`` is in [0, k], 0 only for all-padding rows (inactive slots),
    whose length is untouched; ``next_logits`` predicts the position after
    each row's last accepted token.
    """
    start = cache.length
    embeds = embed_tokens(model.lm, chunks).to(cache.k.dtype)
    all_logits, cache = llama_extend(model.lm, cfg.lm, embeds, chunk_mask, cache,
                                     return_all=True)
    greedy = torch.argmax(all_logits, dim=-1)  # (B, k)
    valid = chunk_mask.bool()
    # chunk[:, 0] is already committed-next; position i's greedy output
    # verifies chunk[:, i + 1].
    match = torch.cat([valid[:, :1], (chunks[:, 1:] == greedy[:, :-1]) & valid[:, 1:]], dim=1)
    accepted = torch.cumprod(match.long(), dim=1).sum(dim=1)
    cache = _with_length(cache, start + accepted.to(start.dtype))
    rows = torch.arange(chunks.shape[0], device=chunks.device)
    acc_pos = (accepted - 1).clamp(min=0)
    return accepted, all_logits[rows, acc_pos].float(), greedy[rows, acc_pos], cache


@torch.no_grad()
def draft_propose_batched(draft_lm, draft_cfg: LlamaConfig, nxt0: torch.Tensor,
                          draft_cache: KVCache, k: int):
    """k greedy decode steps of the draft model, emitting the token WRITTEN at
    each step: the (B, k) result is [nxt0, p0, ..., p_{k-2}], the chunk layout
    :func:`verify_chunks_batched` expects, and the draft cache ends holding
    K/V for every chunk position. Roll it back with :func:`roll_draft_cache`."""
    tok = nxt0.long()
    written = []
    for _ in range(k):
        written.append(tok)
        emb = embed_tokens(draft_lm, tok[:, None]).to(draft_cache.k.dtype)
        logits, draft_cache = llama_decode_step(draft_lm, draft_cfg, emb, draft_cache)
        tok = torch.argmax(logits, dim=-1)
    return torch.stack(written, dim=1), draft_cache


def roll_draft_cache(draft_cache: KVCache, accepted: torch.Tensor, k: int) -> KVCache:
    """Roll the draft cache back over rejected proposals: the propose loop
    advanced every row by k; keep start + accepted (inactive rows have
    accepted == 0, so their length is unchanged)."""
    return _with_length(draft_cache,
                        draft_cache.length - k + accepted.to(draft_cache.length.dtype))


def _ids(tokens: List[int], k: int, device):
    """(1, k) ids and mask of ``tokens``, right-padded with zeros."""
    ids = torch.zeros((1, k), dtype=torch.long)
    mask = torch.zeros((1, k), dtype=torch.long)
    ids[0, : len(tokens)] = torch.as_tensor(tokens, dtype=torch.long)
    mask[0, : len(tokens)] = 1
    return ids.to(device), mask.to(device)


@torch.no_grad()
def _verify_chunk(lm, cfg: LlamaConfig, cache: KVCache, chunk: List[int], k: int, done):
    """One cache-extend verify pass: write ``chunk`` (padded to k) into the
    target cache and accept the longest greedy-matching prefix. Returns
    (accepted, cache, all_logits, start_len); the caller rolls back."""
    ids, mask = _ids(chunk, k, cache.k.device)
    start_len = int(cache.length[0])
    all_logits, cache = llama_extend(lm, cfg, embed_tokens(lm, ids).to(cache.k.dtype), mask,
                                     cache, return_all=True)
    greedy = torch.argmax(all_logits[0, : len(chunk)], dim=-1).tolist()
    # chunk[0] is already verified (it WAS the greedy token); position i
    # verifies chunk[i + 1].
    accepted = [chunk[0]]
    for i in range(1, len(chunk)):
        if done(accepted[-1]) or greedy[i - 1] != chunk[i]:
            break
        accepted.append(chunk[i])
    return accepted, cache, all_logits, start_len


def _length_of(cache: KVCache, n: int) -> torch.Tensor:
    return torch.full_like(cache.length, n)


@torch.no_grad()
def _decode_one(lm, cfg: LlamaConfig, cache: KVCache, token: int):
    ids = torch.tensor([[token]], dtype=torch.long, device=cache.k.device)
    return llama_decode_step(lm, cfg, embed_tokens(lm, ids).to(cache.k.dtype), cache)


def _lm_of(model):
    return getattr(model, "lm", model)


@torch.no_grad()
def speculative_decode(model, cfg: LlamaConfig, cache: KVCache, first_logits: torch.Tensor,
                       context_ids: List[int], *, max_new_tokens: int, eos_token_id: int,
                       stop_ids: Optional[set] = None, ngram: int = 3,
                       k: int = 8) -> Tuple[List[int], KVCache, torch.Tensor, Dict[str, float]]:
    """Greedy decode with prompt-lookup speculation (B=1).

    ``model`` is the whole model or its LM; ``first_logits`` (1, V) predicts
    the next position. Returns (tokens, cache, next_logits, stats): the
    tokens of plain greedy decode; ``next_logits`` predicts the position
    after the last returned token.
    """
    stop_ids = stop_ids or set()
    lm = _lm_of(model)
    toks: List[int] = []
    logits = first_logits
    steps = proposed_total = accepted_total = 0

    def done(t: int) -> bool:
        return t == eos_token_id or t in stop_ids

    while len(toks) < max_new_tokens:
        t1 = int(torch.argmax(logits[0]))
        if done(t1):
            break
        draft = propose_lookup(context_ids + toks + [t1], ngram, k - 1)
        chunk = [t1] + draft[: max(0, min(len(draft), max_new_tokens - len(toks) - 1))]
        steps += 1
        proposed_total += len(chunk) - 1

        if len(chunk) == 1:
            toks.append(t1)
            logits, cache = _decode_one(lm, cfg, cache, t1)
            continue

        accepted, cache, all_logits, start_len = _verify_chunk(lm, cfg, cache, chunk, k, done)
        accepted_total += len(accepted) - 1
        toks.extend(accepted)
        if done(accepted[-1]):
            toks.pop()
            # Roll the cache back past the stop token too.
            cache = _with_length(cache, _length_of(cache, start_len + len(accepted) - 1))
            break
        # Roll back the rejected suffix: shrink the length only.
        cache = _with_length(cache, _length_of(cache, start_len + len(accepted)))
        logits = all_logits[:, len(accepted) - 1]

    stats = {"steps": steps, "tokens": len(toks), "proposed": proposed_total,
             "accepted": accepted_total, "tokens_per_step": len(toks) / max(steps, 1)}
    return toks, cache, logits, stats


@torch.no_grad()
def speculative_decode_draft(model, cfg: LlamaConfig, cache: KVCache,
                             first_logits: torch.Tensor, *, draft_params,
                             draft_cfg: LlamaConfig, draft_cache: KVCache,
                             max_new_tokens: int, eos_token_id: int,
                             stop_ids: Optional[set] = None, k: int = 8
                             ) -> Tuple[List[int], KVCache, torch.Tensor, Dict[str, float]]:
    """Greedy decode with a DRAFT MODEL proposing chunks (B=1).

    The draft LM proposes ``k - 1`` tokens one by one, the target verifies
    the chunk in one cache-extend forward and keeps the longest
    greedy-matching prefix, so the output is the target's greedy chain
    whatever the draft proposes. ``draft_cache`` is prefilled over the same
    context as ``cache``; each round it is synced with the tokens the target
    committed (one padded k-wide extend) and rolled back over its own
    proposals by shrinking ``length``.

    Returns (tokens, cache, next_logits, stats); ``stats['accept_rate']`` is
    the share of proposed tokens the target kept.
    """
    stop_ids = stop_ids or set()
    lm, dlm = _lm_of(model), _lm_of(draft_params)
    toks: List[int] = []
    logits = first_logits
    steps = draft_steps = proposed_total = accepted_total = 0
    # Committed tokens not yet written into the draft cache: at most k a round.
    pending: List[int] = []

    def done(t: int) -> bool:
        return t == eos_token_id or t in stop_ids

    while len(toks) < max_new_tokens:
        t1 = int(torch.argmax(logits[0]))
        if done(t1):
            break
        budget = max_new_tokens - len(toks)
        steps += 1

        # Draft phase: sync the committed tokens, then propose greedily.
        pending.append(t1)
        ids, mask = _ids(pending, k, draft_cache.k.device)
        d_all, draft_cache = llama_extend(
            dlm, draft_cfg, embed_tokens(dlm, ids).to(draft_cache.k.dtype), mask, draft_cache,
            return_all=True)
        draft_len = int(draft_cache.length[0])  # context + all committed + t1
        d_logits = d_all[:, len(pending) - 1]
        pending = []

        d_toks: List[int] = []
        for _ in range(max(0, min(k - 1, budget - 1))):
            dt = int(torch.argmax(d_logits[0]))
            if done(dt):
                break
            d_toks.append(dt)
            draft_steps += 1
            d_logits, draft_cache = _decode_one(dlm, draft_cfg, draft_cache, dt)
        # Roll the draft back over its own proposals (they are uncommitted).
        draft_cache = _with_length(draft_cache, _length_of(draft_cache, draft_len))
        proposed_total += len(d_toks)

        # Target verify phase.
        chunk = [t1] + d_toks
        if len(chunk) == 1:
            toks.append(t1)
            logits, cache = _decode_one(lm, cfg, cache, t1)
            continue

        accepted, cache, all_logits, start_len = _verify_chunk(lm, cfg, cache, chunk, k, done)
        accepted_total += len(accepted) - 1
        toks.extend(accepted)
        pending = accepted[1:]  # the draft already holds t1
        if done(accepted[-1]):
            toks.pop()
            cache = _with_length(cache, _length_of(cache, start_len + len(accepted) - 1))
            break
        cache = _with_length(cache, _length_of(cache, start_len + len(accepted)))
        logits = all_logits[:, len(accepted) - 1]

    stats = {"steps": steps, "draft_steps": draft_steps, "tokens": len(toks),
             "proposed": proposed_total, "accepted": accepted_total,
             "accept_rate": accepted_total / max(proposed_total, 1),
             "tokens_per_step": len(toks) / max(steps, 1)}
    return toks, cache, logits, stats
