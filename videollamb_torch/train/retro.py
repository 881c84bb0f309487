"""RMT-loss ("retro") training: the LM loss of every recurrent segment.

Port of ``videollamb_tpu/train/retro.py`` (reference
LlavaLlamaForCausalLMRMT, llava/model/language_model/llava_llama_retro.py:93-224,
and prepare_retro_inputs_labels_for_multimodal, llava_arch.py:663-824). Each
SceneTilling segment's bridge tokens are spliced into the text and run
through the LM; the segments' logits and labels are concatenated along the
sequence and take one shifted cross-entropy.

As in the JAX package, the segment forwards are independent, so the segment
axis folds into the batch: one LM call over (S * B, L) instead of S calls.
Padding labels are IGNORE_INDEX, so the shifted positions at the segment
joins add no loss.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from videollamb_torch.config import ModelConfig
from videollamb_torch.models.assembly import (
    MultimodalBatch,
    VideoLLaMB,
    causal_lm_loss,
    encode_videos_retro,
)
from videollamb_torch.models.lm.llama import (
    embed_tokens,
    llama_forward,
    llama_forward_with_hidden,
)
from videollamb_torch.models.splice import splice_multimodal


def _segment_splices(model: VideoLLaMB, cfg: ModelConfig, batch: MultimodalBatch,
                     generator: Optional[torch.Generator]):
    if batch.videos is None:
        raise ValueError("the retro path takes video batches only")
    text_embeds = embed_tokens(model.lm, batch.input_ids)
    all_tokens, all_masks = encode_videos_retro(model, cfg, batch.videos, generator)
    return [splice_multimodal(batch.input_ids, batch.attention_mask, batch.labels,
                              text_embeds, all_tokens[:, s], all_masks[:, s], cfg.max_length)
            for s in range(all_tokens.shape[1])]


def videollamb_retro_forward(model: VideoLLaMB, cfg: ModelConfig, batch: MultimodalBatch,
                             generator: Optional[torch.Generator] = None, remat: bool = False,
                             attn_impl: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (logits (B, S*L, V), labels (B, S*L))."""
    spliced = _segment_splices(model, cfg, batch, generator)
    s, (b, l) = len(spliced), spliced[0].attention_mask.shape
    embeds = torch.cat([sp.embeds for sp in spliced])  # (S*B, L, D), segment-major
    mask = torch.cat([sp.attention_mask for sp in spliced])
    logits = llama_forward(model.lm, cfg.lm, embeds, mask, remat=remat, attn_impl=attn_impl)
    v = logits.shape[-1]
    logits = logits.reshape(s, b, l, v).transpose(0, 1).reshape(b, s * l, v)
    labels = torch.stack([sp.labels for sp in spliced], dim=1).reshape(b, s * l)
    return logits, labels


def init_lm_memory(generator: torch.Generator, cfg: ModelConfig, embed_std: float = 0.02,
                   num_mem_tokens: int = 32, dtype=torch.float32) -> torch.Tensor:
    """Learned LM-space memory tokens (reference llava_llama_retro_lm.py:63-71:
    randn times the embedding std), (M, D) on the generator's device."""
    return torch.randn((num_mem_tokens, cfg.lm.hidden_size), generator=generator,
                       device=generator.device, dtype=dtype) * embed_std


def videollamb_retro_lm_forward(model: VideoLLaMB, cfg: ModelConfig, batch: MultimodalBatch,
                                generator: Optional[torch.Generator] = None,
                                remat: bool = False, attn_impl: str = "auto"
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """LM-memory retro variant (reference llava_llama_retro_lm.py:93-224).

    ``model.lm_memory`` (M, D) (:func:`init_lm_memory`) are memory tokens
    inside the LM: each segment's spliced sequence is wrapped as [memory,
    segment, memory], and the hidden states at the trailing memory become the
    next segment's memory. Only the first hand-off keeps its gradient (the
    reference detaches the memory after segment 0).
    -> (logits (B, S*L, V), labels (B, S*L)) over the unwrapped positions."""
    spliced = _segment_splices(model, cfg, batch, generator)
    memory = model.lm_memory
    b, m = batch.input_ids.shape[0], memory.shape[0]
    state = memory[None].expand(b, m, memory.shape[-1])
    seg_logits, seg_labels = [], []
    for seg, sp in enumerate(spliced):
        mem = state.to(sp.embeds.dtype)
        wrapped = torch.cat([mem, sp.embeds, mem], dim=1)
        ones = torch.ones((b, m), dtype=sp.attention_mask.dtype, device=wrapped.device)
        wrapped_mask = torch.cat([ones, sp.attention_mask, ones], dim=1)
        logits, hidden = llama_forward_with_hidden(model.lm, cfg.lm, wrapped, wrapped_mask,
                                                   remat=remat, attn_impl=attn_impl)
        state = hidden[:, -m:].to(state.dtype)
        if seg != 0:
            state = state.detach()
        seg_logits.append(logits[:, m:-m])
        seg_labels.append(sp.labels)
    return torch.cat(seg_logits, dim=1), torch.cat(seg_labels, dim=1)


def retro_loss(model: VideoLLaMB, cfg: ModelConfig, batch: MultimodalBatch,
               generator: Optional[torch.Generator] = None, remat: bool = True,
               attn_impl: str = "chunked") -> Tuple[torch.Tensor, torch.Tensor]:
    logits, labels = videollamb_retro_forward(model, cfg, batch, generator, remat=remat,
                                              attn_impl=attn_impl)
    return causal_lm_loss(logits, labels)
