"""Generation engine: multimodal prefill, then cached decode.

Port of ``videollamb_tpu/models/engine.py``. The JAX version runs the
decode loop as one compiled ``lax.while_loop``; here it is a Python loop
over :func:`llama_decode_step`, stopping when every row has emitted EOS or
the budget is spent. Greedy, temperature and nucleus (top-p) sampling have
the JAX semantics; sampling draws from a ``torch.Generator``, so sampled
tokens differ from the JAX package's (its keys are ``jax.random``). Over a
model sharded by ``parallel/sharding.shard_params`` every rank runs the same
call over its own heads and gets the same tokens.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from videollamb_torch.config import ModelConfig
from videollamb_torch.models.assembly import (
    MultimodalBatch,
    VideoLLaMB,
    prepare_multimodal_embeds,
)
from videollamb_torch.models.lm.llama import (
    embed_tokens,
    init_kv_cache,
    llama_decode_step,
    llama_prefill,
)
from videollamb_torch.models.splice import SplicedBatch
from videollamb_torch.parallel.sharding import gathered


def sample_token(logits: torch.Tensor, generator: Optional[torch.Generator], *,
                 do_sample: bool, temperature: float, top_p: float) -> torch.Tensor:
    """Next tokens (B,) from (B, V) f32 logits; greedy when not sampling or temp == 0."""
    if not do_sample or temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / temperature
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        keep_sorted = (torch.cumsum(probs, dim=-1) - probs) < top_p
        threshold = torch.where(keep_sorted, sorted_logits, torch.inf).amin(dim=-1, keepdim=True)
        logits = torch.where(logits >= threshold, logits, -torch.inf)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


class GenerateResult(NamedTuple):
    tokens: torch.Tensor   # (B, max_new_tokens) int64, pad_token_id after EOS
    lengths: torch.Tensor  # (B,) generated length including EOS


@torch.no_grad()
def generate(model: VideoLLaMB, cfg: ModelConfig, batch: MultimodalBatch,
             generator: Optional[torch.Generator] = None, *, max_new_tokens: int = 128,
             do_sample: bool = False, temperature: float = 0.2, top_p: float = 1.0,
             eos_token_id: int = 2, pad_token_id: int = 0,
             max_seq_len: int = 4096) -> GenerateResult:
    """Multimodal generation: splice, prefill, decode."""
    spliced = prepare_multimodal_embeds(model, cfg, batch)
    return generate_spliced(
        model, cfg, spliced, generator, max_new_tokens=max_new_tokens,
        do_sample=do_sample, temperature=temperature, top_p=top_p,
        eos_token_id=eos_token_id, pad_token_id=pad_token_id, max_seq_len=max_seq_len)


@torch.no_grad()
def generate_spliced(model: VideoLLaMB, cfg: ModelConfig, spliced: SplicedBatch,
                     generator: Optional[torch.Generator] = None, *,
                     max_new_tokens: int = 128, do_sample: bool = False,
                     temperature: float = 0.2, top_p: float = 1.0, eos_token_id: int = 2,
                     pad_token_id: int = 0, max_seq_len: int = 4096) -> GenerateResult:
    """Generation from an already-spliced batch."""
    b = spliced.embeds.shape[0]
    if max_seq_len < cfg.max_length + max_new_tokens:
        raise ValueError(
            f"max_seq_len={max_seq_len} must cover the spliced buffer "
            f"(cfg.max_length={cfg.max_length}) plus max_new_tokens={max_new_tokens}")
    dev = spliced.embeds.device
    cache = init_kv_cache(cfg.lm, b, max_seq_len, dtype=spliced.embeds.dtype, device=dev,
                          lm=model.lm)
    tokens = torch.full((b, max_new_tokens), pad_token_id, dtype=torch.long, device=dev)
    finished = torch.zeros((b,), dtype=torch.bool, device=dev)
    lengths = torch.zeros((b,), dtype=torch.long, device=dev)
    # One gather of an FSDP-sharded root (embeddings, head) for the request.
    with gathered(model.lm):
        logits, cache = llama_prefill(model.lm, cfg.lm, spliced.embeds,
                                      spliced.attention_mask, cache)
        for step in range(max_new_tokens):
            nxt = sample_token(logits, generator, do_sample=do_sample,
                               temperature=temperature, top_p=top_p)
            nxt = torch.where(finished, pad_token_id, nxt)
            tokens[:, step] = nxt
            lengths += (~finished).long()
            finished |= nxt == eos_token_id
            if step + 1 == max_new_tokens or bool(finished.all()):
                break
            tok_embeds = embed_tokens(model.lm, nxt[:, None])
            logits, cache = llama_decode_step(model.lm, cfg.lm, tok_embeds, cache)
    return GenerateResult(tokens=tokens, lengths=lengths)
