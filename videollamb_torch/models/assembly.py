"""VideoLLaMB assembly: tower -> Memory Bridge -> splice -> Llama.

Port of the video and text paths of ``videollamb_tpu/models/assembly.py``
(reference llava_arch.py:331-348 and :492-660). :class:`VideoLLaMB` holds
the three parts under the names of the JAX parameter tree (``video_tower``,
``mm_projector``, ``lm``); each part loads its reference state dict by
name (see ``models/convert.py``). Image, anyres and mixed-modality batches
are not ported yet.

Training enters through :func:`videollamb_forward` (packed rows included,
with ``segment_ids``) and :func:`causal_lm_loss`; a ``torch.Generator``
passed to them turns the bridge's dropout on. Nothing here freezes or
detaches: which parameters take gradients is their ``requires_grad``,
set by ``train/step.apply_trainable_mask``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from videollamb_torch.config import ModelConfig
from videollamb_torch.constants import IGNORE_INDEX
from videollamb_torch.models.bridge.rmt_r import RMTRBridge, rmt_r_video_forward
from videollamb_torch.models.lm.llama import LlamaForCausalLM, embed_tokens, llama_forward
from videollamb_torch.models.splice import (
    SplicedBatch,
    splice_multimodal,
    splice_multimodal_packed,
)
from videollamb_torch.models.vision.clip_vit import CLIPVisionTower, vision_encode


class VideoLLaMB(nn.Module):
    def __init__(self, video_tower: Optional[CLIPVisionTower], mm_projector: RMTRBridge,
                 lm: LlamaForCausalLM):
        super().__init__()
        self.video_tower = video_tower
        self.mm_projector = mm_projector
        self.lm = lm


class MultimodalBatch(NamedTuple):
    """Host-assembled batch; ``videos`` is None for text-only batches.

    input_ids carry the VIDEO sentinel (-201) on multimodal rows.
    """

    input_ids: torch.Tensor                 # (B, T)
    attention_mask: torch.Tensor            # (B, T)
    labels: Optional[torch.Tensor] = None   # (B, T)
    videos: Optional[torch.Tensor] = None   # (B, T_v, C, H, W); packed: (B, K, T_v, C, H, W)
    # Packed rows (train/dataset.PackedCollator): segments 1..S per row, 0 =
    # padding; the k-th sentinel of a row binds video slot k where
    # video_block_mask (B, K) is true.
    segment_ids: Optional[torch.Tensor] = None       # (B, T)
    video_block_mask: Optional[torch.Tensor] = None  # (B, K) bool


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.tower is not None or cfg.bridge.kind != "rmt_r_transformer":
        raise NotImplementedError(
            "the port runs the LanguageBind CLIP tower with the rmt_r_transformer "
            f"bridge only (got tower={cfg.tower!r}, bridge={cfg.bridge.kind!r})")


def _bridge_outputs(model: VideoLLaMB, cfg: ModelConfig, videos: torch.Tensor,
                    generator: Optional[torch.Generator]):
    _check_supported(cfg)
    if model.video_tower is None:
        raise ValueError("the model was loaded without a video tower")
    feats = vision_encode(model.video_tower, videos, cfg.vision)  # (B, T, N, D)
    return [rmt_r_video_forward(model.mm_projector, cfg.bridge, f, generator) for f in feats]


def encode_videos(model: VideoLLaMB, cfg: ModelConfig, videos: torch.Tensor,
                  generator: Optional[torch.Generator] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, T, C, H, W) -> final-segment bridge tokens (B, N, lm_d) and mask (B, N)."""
    outs = _bridge_outputs(model, cfg, videos, generator)
    return (torch.stack([o.tokens for o in outs]),
            torch.stack([o.token_mask for o in outs]))


def encode_videos_retro(model: VideoLLaMB, cfg: ModelConfig, videos: torch.Tensor,
                        generator: Optional[torch.Generator] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every segment's bridge tokens, for the RMT-loss path (reference
    encode_videos_retro, llava_arch.py:428): (B, S, F*P, lm_d), (B, S, F*P)."""
    outs = _bridge_outputs(model, cfg, videos, generator)
    return (torch.stack([o.all_tokens for o in outs]),
            torch.stack([o.all_masks for o in outs]))


def _no_visual(text_embeds: torch.Tensor, *lead: int):
    """A zero visual block that inserts nothing, for batches without videos."""
    return (text_embeds.new_zeros((*lead, 1, text_embeds.shape[-1])),
            torch.zeros((*lead, 1), dtype=torch.bool, device=text_embeds.device))


def _prepare(model: VideoLLaMB, cfg: ModelConfig, batch: MultimodalBatch,
             generator: Optional[torch.Generator] = None) -> SplicedBatch:
    text_embeds = embed_tokens(model.lm, batch.input_ids)
    if batch.videos is not None:
        x_embeds, x_mask = encode_videos(model, cfg, batch.videos, generator)
    else:
        x_embeds, x_mask = _no_visual(text_embeds, batch.input_ids.shape[0])
    return splice_multimodal(batch.input_ids, batch.attention_mask, batch.labels,
                             text_embeds, x_embeds, x_mask, cfg.max_length)


@torch.no_grad()
def prepare_multimodal_embeds(model: VideoLLaMB, cfg: ModelConfig,
                              batch: MultimodalBatch) -> SplicedBatch:
    """Encode the videos, embed the text, splice into a ``cfg.max_length`` buffer."""
    return _prepare(model, cfg, batch)


def prepare_packed_embeds(model: VideoLLaMB, cfg: ModelConfig, batch: MultimodalBatch,
                          generator: Optional[torch.Generator] = None):
    """Packed rows: encode each row's K video slots, splice with segment
    tracking. Returns (spliced, segment_ids (B, L), position_ids (B, L))."""
    text_embeds = embed_tokens(model.lm, batch.input_ids)
    b = batch.input_ids.shape[0]
    if batch.videos is not None:
        bb, k = batch.videos.shape[:2]
        tok, msk = encode_videos(model, cfg, batch.videos.flatten(0, 1), generator)
        x_embeds = tok.reshape(bb, k, *tok.shape[1:])
        x_mask = msk.reshape(bb, k, *msk.shape[1:])
        if batch.video_block_mask is not None:
            x_mask = x_mask & batch.video_block_mask[:, :, None].bool()
    else:
        x_embeds, x_mask = _no_visual(text_embeds, b, 1)
    return splice_multimodal_packed(batch.input_ids, batch.attention_mask, batch.labels,
                                    batch.segment_ids, text_embeds, x_embeds, x_mask,
                                    cfg.max_length)


def videollamb_forward(model: VideoLLaMB, cfg: ModelConfig, batch: MultimodalBatch,
                       generator: Optional[torch.Generator] = None, remat: bool = False,
                       attn_impl: str = "auto") -> Tuple[torch.Tensor, SplicedBatch]:
    """Full multimodal forward -> (logits (B, L, V) f32, spliced batch).

    Batches with ``segment_ids`` take the packed route: attention within each
    segment and per-segment RoPE positions, so packed conversations train as
    if each had its own row. Training passes ``attn_impl="chunked"`` (the
    differentiable attention), ``remat`` and a ``generator`` (dropout)."""
    if batch.segment_ids is not None:
        spliced, seg, pos = prepare_packed_embeds(model, cfg, batch, generator)
        logits = llama_forward(model.lm, cfg.lm, spliced.embeds, spliced.attention_mask,
                               position_ids=pos, remat=remat, attn_impl=attn_impl,
                               segment_ids=seg)
        return logits, spliced
    spliced = _prepare(model, cfg, batch, generator)
    logits = llama_forward(model.lm, cfg.lm, spliced.embeds, spliced.attention_mask,
                           remat=remat, attn_impl=attn_impl)
    return logits, spliced


def causal_lm_loss(logits: torch.Tensor, labels: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shifted cross-entropy over the labels that are not IGNORE_INDEX.
    Returns (mean loss, token count), the count at least 1."""
    shift_logits = logits[:, :-1].float()
    shift_labels = labels[:, 1:]
    valid = shift_labels != IGNORE_INDEX
    safe = torch.where(valid, shift_labels, 0).long()
    logp = torch.log_softmax(shift_logits, dim=-1)
    token_logp = torch.gather(logp, -1, safe[..., None])[..., 0]
    n = valid.sum().clamp(min=1)
    return -torch.where(valid, token_logp, 0.0).sum() / n, n


def measure_block_tokens(cfg: ModelConfig, modality: str = "video") -> int:
    """Spliced tokens one media block expands to, the packing budget unit
    (``train/dataset.PackedCollator``): the final segment's F x P tokens for a
    video, P for an image."""
    if modality == "video":
        return cfg.bridge.tokens_per_segment
    return cfg.bridge.tokens_per_frame
