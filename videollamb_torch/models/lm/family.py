"""The dense-cache functions of each LM family the engines serve, by config.

The Llama family (``models/lm/llama.py``: Llama, Vicuna, Mistral) and the
DeepSeek-V3 family (``models/lm/mla.py``: latent attention, routed
experts) give their dense B-row caches and cached prefills the same
contract; the engines pick them with :func:`dense_ops`.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

from videollamb_torch.config import is_mla
from videollamb_torch.models.lm import llama, mla


class DenseOps(NamedTuple):
    init_cache: Callable       # (cfg, batch, max_len, dtype=, device=, lm=) -> cache
    chunked_prefill: Callable  # (lm, cfg, embeds, mask, cache, lengths=) -> (logits, cache)
    extend: Callable           # (lm, cfg, embeds, mask, cache) -> (logits, cache)


LLAMA = DenseOps(llama.init_kv_cache, llama.chunked_prefill, llama.llama_extend)
MLA = DenseOps(mla.init_latent_cache, mla.chunked_prefill, mla.mla_extend)


def dense_ops(lm_cfg) -> DenseOps:
    return MLA if is_mla(lm_cfg) else LLAMA
