"""VideoLLaMB assembly: tower -> Memory Bridge -> splice -> Llama.

Port of the video, image, mixed-modality and text paths of
``videollamb_tpu/models/assembly.py`` (reference llava_arch.py:265-348 and
:492-660). :class:`VideoLLaMB` holds the parts under the names of the JAX
parameter tree (``video_tower``, ``mm_projector``, ``lm`` and the optional
``image_tower``); each part loads its reference state dict by name (see
``models/convert.py``). The projector is any kind of the factory
(``models/bridge/builder.py``): every encoder dispatches through
``bridge_apply``, one sample at a time. An image goes through the image
tower when the model has one, else through the video tower at T = 1 (no
temporal attention), then through the projector's image branch. A mixed row
(``MultimodalBatch.blocks``) encodes each block with its own encoder and
binds the k-th block to the k-th sentinel; audio blocks (mel images) ride
the image path, as in the JAX package. Anyres rows (5-D ``images`` with
``image_specs``) go through :func:`encode_images_anyres`: every patch
through the tower and a grid-preserving projector, then the static-shape
merge of ``models/anyres.py``. A research tower (``cfg.tower``, a
``models/vision/builder.TowerSpec``) encodes through ``tower_encode``. The
per-segment RMT loss (:func:`encode_videos_retro`) is the RMT-R bridge's, as
in the JAX package.

Training enters through :func:`videollamb_forward` (packed rows included,
with ``segment_ids``) and :func:`causal_lm_loss`; a ``torch.Generator``
passed to them turns the bridge's dropout on. Nothing here freezes or
detaches: which parameters take gradients is their ``requires_grad``,
set by ``train/step.apply_trainable_mask``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from videollamb_torch.config import ModelConfig
from videollamb_torch.constants import IGNORE_INDEX
from videollamb_torch.models.bridge.builder import RMT_R, bridge_apply, bridge_token_count
from videollamb_torch.models.bridge.rmt_r import rmt_r_video_forward
from videollamb_torch.models.lm.llama import LlamaForCausalLM, embed_tokens, llama_forward
from videollamb_torch.models.seeded import generator
from videollamb_torch.models.splice import (
    SplicedBatch,
    splice_multimodal,
    splice_multimodal_packed,
)
from videollamb_torch.models.vision.clip_vit import vision_encode
from videollamb_torch.parallel.sharding import gathered
from videollamb_torch.utils.profiling import span


class VideoLLaMB(nn.Module):
    """``image_newline`` is the learned row terminator of 'spatial_unpad'
    anyres merges (:func:`init_image_newline`); without it the merge writes
    zeros, as the JAX package does."""

    def __init__(self, video_tower: Optional[nn.Module], mm_projector: nn.Module,
                 lm: LlamaForCausalLM, image_tower: Optional[nn.Module] = None,
                 image_newline: Optional[torch.Tensor] = None):
        super().__init__()
        self.video_tower = video_tower
        self.mm_projector = mm_projector
        self.lm = lm
        self.image_tower = image_tower
        self.image_newline = None if image_newline is None else nn.Parameter(image_newline)

    def forward(self, fn, *args, **kwargs):
        """``fn(self, *args, **kwargs)`` through the module's call, so that
        hooks on the model run around it: the sharded train step
        (``parallel/sharding.py``) calls ``model(videollamb_forward, ...)``,
        and FSDP gathers the root's weights there."""
        return fn(self, *args, **kwargs)


class MultimodalBatch(NamedTuple):
    """Host-assembled batch; ``videos`` and ``images`` are None for text-only
    batches.

    input_ids carry X sentinels on multimodal rows (-200 image, -201 video,
    -202 audio; up to K per row, the k-th binding visual block k).
    """

    input_ids: torch.Tensor                 # (B, T)
    attention_mask: torch.Tensor            # (B, T)
    labels: Optional[torch.Tensor] = None   # (B, T)
    videos: Optional[torch.Tensor] = None   # (B, T_v, C, H, W); packed: (B, K, T_v, C, H, W)
    # (B, C, H, W); multi-image rows (B, K, C, H, W); anyres patch stacks
    # (B, P, C, H, W) with image_specs (B, 4) int (models/anyres.anyres_spec).
    images: Optional[torch.Tensor] = None
    image_specs: Optional[torch.Tensor] = None
    # A mixed-modality row (B = 1): ordered ("VIDEO"|"IMAGE"|"AUDIO", pixels)
    # blocks, video (T, C, H, W), image and audio (C, H, W); block k binds
    # the k-th sentinel (mm_utils.tokenizer_multi_x_token).
    blocks: Optional[Tuple[Tuple[str, torch.Tensor], ...]] = None
    # Packed rows (train/dataset.PackedCollator): segments 1..S per row, 0 =
    # padding; the k-th sentinel of a row binds slot k: packed ``videos`` are
    # (B, K, T_v, C, H, W) with video_block_mask (B, K) marking the slots
    # that hold a video, packed ``images`` (B, K, C, H, W) with
    # image_block_mask. A batch may carry both (disjoint masks).
    segment_ids: Optional[torch.Tensor] = None       # (B, T)
    video_block_mask: Optional[torch.Tensor] = None  # (B, K) bool
    image_block_mask: Optional[torch.Tensor] = None  # (B, K) bool


def _tower_features(model: VideoLLaMB, cfg: ModelConfig, pixels: torch.Tensor,
                    tower_key: str = "video_tower") -> torch.Tensor:
    """(B, T, C, H, W) -> (B, T', N, D) tower features. An image (T = 1) with
    no image tower goes through the video tower, whose temporal attention a
    single frame skips. With ``cfg.tower`` set, the research tower's
    ``tower_encode`` runs instead of the CLIP family's ``vision_encode``.
    The call is the ``encode.tower`` span."""
    tower = getattr(model, tower_key)
    if tower is None:
        tower = model.video_tower
    if tower is None:
        raise ValueError("the model was loaded without a video tower")
    with span("encode.tower"):
        if cfg.tower is not None:
            from videollamb_torch.models.vision.builder import tower_encode

            return tower_encode(cfg.tower, tower, pixels)
        return vision_encode(tower, pixels, cfg.vision)


def _stack(outs) -> Tuple[torch.Tensor, torch.Tensor]:
    return torch.stack([t for t, _ in outs]), torch.stack([m for _, m in outs])


def encode_videos(model: VideoLLaMB, cfg: ModelConfig, videos: torch.Tensor,
                  generator: Optional[torch.Generator] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, T, C, H, W) -> each video's projector tokens (B, N, lm_d) and mask
    (B, N); for the RMT-R bridge the final segment's (reference
    encode_videos, llava_arch.py:331-338). Each video's bridge (SceneTilling,
    the RMT-R recurrence, retrieval) is an ``encode.bridge`` span."""
    feats = _tower_features(model, cfg, videos)  # (B, T, N, D)
    outs = []
    for f in feats:
        with span("encode.bridge"):
            outs.append(bridge_apply(model.mm_projector, cfg.bridge, f, modality="video",
                                     generator=generator))
    return _stack(outs)


def encode_videos_retro(model: VideoLLaMB, cfg: ModelConfig, videos: torch.Tensor,
                        generator: Optional[torch.Generator] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every segment's bridge tokens, for the RMT-loss path (reference
    encode_videos_retro, llava_arch.py:428): (B, S, F*P, lm_d), (B, S, F*P).
    The RMT-R bridge's only, as in the JAX package."""
    if cfg.bridge.kind != RMT_R:
        raise ValueError(f"the per-segment RMT loss needs the {RMT_R} bridge's segments; "
                         f"this model's projector is {cfg.bridge.kind!r}")
    feats = _tower_features(model, cfg, videos)
    outs = [rmt_r_video_forward(model.mm_projector, cfg.bridge, f, generator) for f in feats]
    return _stack([(o.all_tokens, o.all_masks) for o in outs])


def encode_images(model: VideoLLaMB, cfg: ModelConfig, images: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, C, H, W) -> the projector's image tokens (B, P, lm_d) and mask
    (B, P) (reference encode_images, llava_arch.py:265); for the RMT-R bridge
    one pass over each image's pooled features, every token valid."""
    feats = _tower_features(model, cfg, images[:, None], "image_tower")[:, 0]  # (B, N, D)
    return _stack([bridge_apply(model.mm_projector, cfg.bridge, f, modality="image")
                   for f in feats])


def encode_images_anyres(model: VideoLLaMB, cfg: ModelConfig, images: torch.Tensor,
                         image_specs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Anyres patch encode + merge (reference encode_images 'spatial*'
    branch, llava_arch.py:265-331): images (B, P, C, H, W), the base
    resized image then the grid patches, with image_specs (B, 4) from
    ``models/anyres.anyres_spec``. Every patch goes through the tower (one
    batch of B*P frames) and the projector, then the static-shape spatial
    merge with unpad and newline tokens.

    Needs a grid-preserving projector (identity / linear / mlp), as the
    reference asserts (llava_arch.py:291).
    Returns (B, N_max, lm_d) tokens and (B, N_max) mask."""
    from videollamb_torch.models.anyres import anyres_merge

    if cfg.bridge.kind not in ("identity", "linear", "mlp"):
        raise ValueError(
            "anyres spatial merge needs a grid-preserving projector "
            f"(got {cfg.bridge.kind!r}); reference asserts height*width == "
            "base_image_feature.shape[0] (llava_arch.py:291)")
    b, p = images.shape[:2]
    # feature_select('patch') drops CLS: (B*P, n_patches, d_vis)
    feats = _tower_features(model, cfg, images.reshape(b * p, 1, *images.shape[2:]),
                            "image_tower")[:, 0, 1:]
    tokens = torch.stack([bridge_apply(model.mm_projector, cfg.bridge, f, modality="image")[0]
                          for f in feats])
    tokens = tokens.reshape(b, p, cfg.vision.num_patches, -1)
    newline = model.image_newline
    if newline is None:
        newline = tokens.new_zeros(tokens.shape[-1])
    return _stack([anyres_merge(tok, spec, newline, cfg.vision.num_patches_per_side,
                                cfg.mm_patch_merge_type)
                   for tok, spec in zip(tokens, image_specs)])


def init_image_newline(lm_hidden_size: int, *, seed: int = 0, dtype=torch.float32,
                       device="cpu") -> torch.Tensor:
    """Learned row terminator for 'spatial_unpad' (reference
    LlavaMetaModel.__init__: randn(hidden) / sqrt(hidden))."""
    g = generator(device, seed)
    x = torch.randn(lm_hidden_size, generator=g, device=device) / lm_hidden_size ** 0.5
    return x.to(dtype)


def encode_mixed(model: VideoLLaMB, cfg: ModelConfig,
                 blocks: Tuple[Tuple[str, torch.Tensor], ...],
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The blocks of one mixed row -> the K-block splice input: each block
    through its own encoder, right-padded to the widest block.

    Returns x_embeds (1, K, N_max, lm_d) and x_mask (1, K, N_max)."""
    outs = []
    for modality, pixels in blocks:
        if modality == "VIDEO":
            e, m = encode_videos(model, cfg, pixels[None], generator)
        elif modality in ("IMAGE", "AUDIO"):
            e, m = encode_images(model, cfg, pixels[None])
        else:
            raise ValueError(f"unknown modality {modality!r}")
        outs.append((e[0], m[0].bool()))
    n_max = max(e.shape[0] for e, _ in outs)
    first = outs[0][0]
    x_embeds = first.new_zeros((1, len(outs), n_max, first.shape[-1]))
    x_mask = torch.zeros((1, len(outs), n_max), dtype=torch.bool, device=first.device)
    for i, (e, m) in enumerate(outs):
        x_embeds[0, i, : e.shape[0]] = e
        x_mask[0, i, : m.shape[0]] = m
    return x_embeds, x_mask


def _no_visual(text_embeds: torch.Tensor, *lead: int):
    """A zero visual block that inserts nothing, for batches without media."""
    return (text_embeds.new_zeros((*lead, 1, text_embeds.shape[-1])),
            torch.zeros((*lead, 1), dtype=torch.bool, device=text_embeds.device))


def _prepare(model: VideoLLaMB, cfg: ModelConfig, batch: MultimodalBatch,
             generator: Optional[torch.Generator] = None) -> SplicedBatch:
    text_embeds = embed_tokens(model.lm, batch.input_ids)
    if batch.blocks is not None:
        x_embeds, x_mask = encode_mixed(model, cfg, batch.blocks, generator)
    elif batch.videos is not None:
        x_embeds, x_mask = encode_videos(model, cfg, batch.videos, generator)
    elif batch.images is not None and batch.images.dim() == 5 and batch.image_specs is not None:
        x_embeds, x_mask = encode_images_anyres(model, cfg, batch.images, batch.image_specs)
    elif batch.images is not None and batch.images.dim() == 5:
        # Multi-image rows: image k of a row binds its k-th sentinel.
        b, k = batch.images.shape[:2]
        tok, msk = encode_images(model, cfg, batch.images.flatten(0, 1))
        x_embeds = tok.reshape(b, k, *tok.shape[1:])
        x_mask = msk.reshape(b, k, *msk.shape[1:])
    elif batch.images is not None:
        x_embeds, x_mask = encode_images(model, cfg, batch.images)
    else:
        x_embeds, x_mask = _no_visual(text_embeds, batch.input_ids.shape[0])
    with span("splice"):
        return splice_multimodal(batch.input_ids, batch.attention_mask, batch.labels,
                                 text_embeds, x_embeds, x_mask, cfg.max_length)


@torch.no_grad()
def prepare_multimodal_embeds(model: VideoLLaMB, cfg: ModelConfig,
                              batch: MultimodalBatch) -> SplicedBatch:
    """Encode the media, embed the text, splice into a ``cfg.max_length`` buffer.

    Over an FSDP-sharded model the root unit (the towers' embeddings, the
    bridge, the token table) is gathered for the call; the tower layers,
    units of their own, gather around their module calls."""
    with gathered(model):
        return _prepare(model, cfg, batch)


def prepare_packed_embeds(model: VideoLLaMB, cfg: ModelConfig, batch: MultimodalBatch,
                          generator: Optional[torch.Generator] = None):
    """Packed rows: encode each row's K video and image slots, splice with
    segment tracking. Returns (spliced, segment_ids (B, L), position_ids (B, L))."""
    text_embeds = embed_tokens(model.lm, batch.input_ids)
    b = batch.input_ids.shape[0]
    vid = img = None
    if batch.videos is not None:
        bb, k = batch.videos.shape[:2]
        tok, msk = encode_videos(model, cfg, batch.videos.flatten(0, 1), generator)
        vid = [tok.reshape(bb, k, *tok.shape[1:]), msk.reshape(bb, k, *msk.shape[1:])]
        if batch.video_block_mask is not None:
            vid[1] = vid[1] & batch.video_block_mask[:, :, None].bool()
    if batch.images is not None:
        bb, k = batch.images.shape[:2]
        tok, msk = encode_images(model, cfg, batch.images.flatten(0, 1))
        img = [tok.reshape(bb, k, *tok.shape[1:]), msk.reshape(bb, k, *msk.shape[1:])]
        blk = (batch.image_block_mask if batch.image_block_mask is not None
               else batch.video_block_mask)
        if blk is not None:
            img[1] = img[1] & blk[:, :, None].bool()
    if vid is not None and img is not None:
        # Mixed packing: slot k of a row is a video or an image (disjoint
        # block masks), so after padding both to one width the masked sum
        # selects per slot.
        n = max(vid[0].shape[2], img[0].shape[2])
        (vt, vm), (it, im) = [(F.pad(t, (0, 0, 0, n - t.shape[2])), F.pad(m, (0, n - m.shape[2])))
                              for t, m in (vid, img)]
        x_embeds = vt * vm[..., None].to(vt.dtype) + it * im[..., None].to(it.dtype)
        x_mask = vm | im
    elif vid is not None or img is not None:
        x_embeds, x_mask = vid if vid is not None else img
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


def causal_lm_loss_sum(logits: torch.Tensor, labels: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of the shifted cross-entropies over the labels that are not
    IGNORE_INDEX, their count): the parts of :func:`causal_lm_loss`, which
    sharded steps reduce over the ranks before they divide."""
    shift_labels = labels[:, 1:]
    valid = shift_labels != IGNORE_INDEX
    safe = torch.where(valid, shift_labels, 0).long()
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    token_logp = torch.gather(logp, -1, safe[..., None])[..., 0]
    return -torch.where(valid, token_logp, 0.0).sum(), valid.sum()


def causal_lm_loss(logits: torch.Tensor, labels: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shifted cross-entropy over the labels that are not IGNORE_INDEX.
    Returns (mean loss, token count), the count at least 1."""
    total, n = causal_lm_loss_sum(logits, labels)
    n = n.clamp(min=1)
    return total / n, n


def measure_block_tokens(cfg: ModelConfig, modality: str = "video") -> int:
    """Spliced tokens one media block expands to, the packing budget unit
    (``train/dataset.PackedCollator``): for the RMT-R bridge the final
    segment's F x P tokens for a video, P for an image; a video has
    ``cfg.num_frames`` frames. A research tower (``cfg.tower``) gives its own
    token count per frame and frame count."""
    frames = cfg.num_frames if modality == "video" else 1
    n_tokens = 1 + (cfg.vision.image_size // cfg.vision.patch_size) ** 2
    if cfg.tower is not None:
        from videollamb_torch.models.vision.builder import tower_output_shape

        frames, n_tokens = tower_output_shape(cfg.tower, frames, cfg.vision.image_size)
    return bridge_token_count(cfg.bridge, n_tokens, frames, modality)
