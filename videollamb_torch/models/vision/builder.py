"""Vision tower factory: name-based dispatch matching the reference.

Port of ``videollamb_tpu/models/vision/builder.py`` (reference
llava/model/multimodal_encoder/builder.py:14-61). The CLIP family (OpenAI
CLIP, frame-wise CLIP video, LanguageBind image / video / audio / depth /
thermal) shares ``clip_vit``; the research towers (ViT / MAE / ViViT /
VideoMAE, the RMT memory encoder, DeformCLIP, Deformable-DETR, EgoVLP) have
modules of their own. ``ModelConfig.tower`` holds a :class:`TowerSpec`, and
``models/assembly`` then encodes through :func:`tower_encode`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Tuple

import torch
from torch import nn

from videollamb_torch.config import VisionConfig
from videollamb_torch.models.vision.clip_vit import init_vision_params, vision_encode

VIT_KINDS = ("vit", "vitmae", "vivit", "videomae")


@dataclasses.dataclass(frozen=True)
class TowerSpec:
    kind: str
    config: Any  # VisionConfig, or the research tower's own config
    frame_wise: bool  # encode each frame on its own (no temporal attention)


_CLIP_L14 = dict(hidden_size=1024, intermediate_size=4096, num_hidden_layers=24,
                 num_attention_heads=16, image_size=224, patch_size=14)
_CLIP_L14_336 = dict(_CLIP_L14, image_size=336)
# Audio tower: the same ViT-L/14 trunk over a rectangular mel grid.
_CLIP_L14_AUDIO = {k: v for k, v in _CLIP_L14.items() if k != "image_size"}


def resolve_tower(name: str, *, select_layer: int = -2,
                  select_feature: str = "patch") -> TowerSpec:
    """Map a tower name or path (reference naming) to a TowerSpec, testing the
    names in the JAX package's order."""
    base = dict(select_layer=select_layer, select_feature=select_feature)
    if "RMTLanguageBind_Video" in name:
        # The memory-token encoder (rmt_clip_vit.py): 128 read memories per
        # step, frame recurrence for clips.
        return TowerSpec("rmt_languagebind_video",
                         VisionConfig(add_time_attn=False, **_CLIP_L14, **base), frame_wise=False)
    if "LanguageBind_Video" in name:
        return TowerSpec("languagebind_video",
                         VisionConfig(add_time_attn=True, **_CLIP_L14, **base), frame_wise=False)
    if "LanguageBind_Image" in name:
        return TowerSpec("languagebind_image",
                         VisionConfig(add_time_attn=False, **_CLIP_L14, **base), frame_wise=True)
    if "LanguageBind_Audio" in name:
        from videollamb_torch.models.vision.modalities import audio_tower_config

        return TowerSpec("languagebind_audio", audio_tower_config(**_CLIP_L14_AUDIO, **base),
                         frame_wise=True)
    if "LanguageBind_Depth" in name:
        return TowerSpec("languagebind_depth",
                         VisionConfig(add_time_attn=False, **_CLIP_L14, **base), frame_wise=True)
    if "LanguageBind_Thermal" in name:
        return TowerSpec("languagebind_thermal",
                         VisionConfig(add_time_attn=False, **_CLIP_L14, **base), frame_wise=True)
    if "deform_clip" in name.lower() or "deform-clip" in name.lower():
        # Before the generic CLIP match ('deform_clip' contains 'clip').
        from videollamb_torch.models.vision.deform_clip import DeformCLIPConfig

        return TowerSpec("deform_clip", DeformCLIPConfig(select_layer=select_layer),
                         frame_wise=True)
    if "clip" in name.lower():
        dims = _CLIP_L14_336 if "336" in name else _CLIP_L14
        return TowerSpec("clip", VisionConfig(add_time_attn=False, **dims, **base),
                         frame_wise=True)
    if "EgoVLP" in name or "egovlp" in name:
        from videollamb_torch.models.vision.egovlp import EgoVLPConfig

        return TowerSpec("egovlp", EgoVLPConfig(), frame_wise=False)
    # The reference's rmt_clip / rmt_vivit entries load plain CLIP / Vivit.
    if "rmt_clip" in name:
        return TowerSpec("clip", VisionConfig(add_time_attn=False, **_CLIP_L14, **base),
                         frame_wise=True)
    from videollamb_torch.models.vision.vit import ViTFamilyConfig

    if "rmt_vivit" in name:
        return TowerSpec("vivit", ViTFamilyConfig.vivit_base(select_layer=select_layer),
                         frame_wise=False)
    for key, kind in [("videomae", "videomae"), ("vivit", "vivit"), ("mae", "vitmae"),
                      ("vit", "vit")]:
        if key in name:
            if kind == "vivit":
                cfg = ViTFamilyConfig.vivit_base(select_layer=select_layer)
            elif kind == "videomae":
                cfg = ViTFamilyConfig.videomae_base(select_layer=select_layer)
            else:
                cfg = ViTFamilyConfig.vit_base(select_layer=select_layer)
            return TowerSpec(kind, cfg, frame_wise=(kind in ("vit", "vitmae")))
    if "deformable" in name or "deform" in name:
        from videollamb_torch.models.vision.deformable import DeformableConfig

        return TowerSpec("deformable", DeformableConfig(), frame_wise=True)
    raise ValueError(f"Unknown tower: {name}")


def init_tower(spec: TowerSpec, *, seed: int = 0, dtype=torch.float32,
               device="cpu") -> nn.Module:
    """A seeded tower module of ``spec.kind``."""
    kw = dict(seed=seed, dtype=dtype, device=device)
    if spec.kind == "rmt_languagebind_video":
        from videollamb_torch.models.vision.rmt_clip_vit import init_rmt_vision_params

        return init_rmt_vision_params(spec.config, **kw)
    if spec.kind == "egovlp":
        from videollamb_torch.models.vision.egovlp import init_egovlp_params

        return init_egovlp_params(spec.config, **kw)
    if spec.kind == "deform_clip":
        from videollamb_torch.models.vision.deform_clip import init_deform_clip_params

        return init_deform_clip_params(spec.config, **kw)
    if spec.kind == "deformable":
        from videollamb_torch.models.vision.deformable import init_deformable_params

        return init_deformable_params(spec.config, **kw)
    if spec.kind in VIT_KINDS:
        from videollamb_torch.models.vision.vit import init_vit_params

        return init_vit_params(spec.config, **kw)
    return init_vision_params(spec.config, **kw)


def build_image_tower(name: str, state_dict: Optional[Mapping[str, torch.Tensor]] = None, *,
                      seed: int = 0, dtype=torch.float32,
                      device="cpu") -> Tuple[TowerSpec, nn.Module]:
    """(spec, tower): a tower dir's ``vision_model.*`` state dict loads by name,
    as the JAX package's loads through its CLIP converter; without one the
    tower is seeded (tests). The ViT-family and EgoVLP checkpoints have
    converters of their own (``convert_vit_state_dict``,
    ``convert_egovlp_state_dict``)."""
    from videollamb_torch.models.convert import tower_state

    spec = resolve_tower(name)
    tower = init_tower(spec, seed=seed, dtype=dtype, device=device)
    if state_dict is not None:
        tower.load_state_dict(tower_state(state_dict), strict=True)
    return spec, tower


build_video_tower = build_image_tower


def _half(h: int, k: int, stride: int, pad: int) -> int:
    return (h + 2 * pad - k) // stride + 1


def tower_output_shape(spec: TowerSpec, frames: int, size: int) -> Tuple[int, int]:
    """(T', N) of :func:`tower_encode`'s (B, T', N, D) output for ``frames``
    frames of ``size`` pixels, from the shapes alone."""
    c = spec.config
    if spec.kind == "egovlp":
        return frames, c.patches_per_frame
    if spec.kind == "deform_clip":
        return frames, c.seq_len
    if spec.kind in VIT_KINDS:
        t = frames if spec.frame_wise else frames // c.tubelet_t
        return t, 1 + c.tokens_per_frame_group
    if spec.kind == "deformable":
        h = _half(_half(size, 7, 2, 3), 3, 2, 1)  # the embedder and its max pool
        sides = []
        for si in range(len(c.backbone_depths)):
            h = h if si == 0 else _half(h, 3, 2, 1)
            if si in c.backbone_out:
                sides.append(h)
        while len(sides) < c.num_feature_levels:
            sides.append(_half(sides[-1], 3, 2, 1))
        return frames, sum(s * s for s in sides)
    return frames, c.seq_len


def tower_encode(spec: TowerSpec, tower: nn.Module, pixels: torch.Tensor) -> torch.Tensor:
    """Encode (B, T, C, H, W) with the tower's temporal semantics ->
    (B, T', 1+n, D), a CLS (or CLS-like) slot at 0 where the kind has one:
    frame-wise towers fold T into the batch, LanguageBind video runs 8-frame
    temporal windows, the RMT encoder its frame recurrence, the tubelet
    models group their tokens per frame pair."""
    b, t = pixels.shape[:2]
    if spec.kind == "rmt_languagebind_video":
        from videollamb_torch.models.vision.rmt_clip_vit import rmt_vision_encode

        return rmt_vision_encode(tower, pixels, spec.config)[0]
    if spec.kind == "egovlp":
        from videollamb_torch.models.vision.egovlp import egovlp_encode

        hidden = egovlp_encode(tower, pixels, spec.config)  # (B, 1+F*N, D)
        return hidden[:, 1:].reshape(b, t, -1, hidden.shape[-1])
    if spec.kind == "deform_clip":
        from videollamb_torch.models.vision.deform_clip import deform_clip_encode

        h = deform_clip_encode(tower, pixels.reshape(b * t, *pixels.shape[2:]), spec.config)
        return h.reshape(b, t, *h.shape[1:])  # CLS at 0, as the bridges expect
    if spec.kind == "deformable":
        from videollamb_torch.models.vision.deformable import deformable_encode

        states = deformable_encode(tower, pixels.reshape(b * t, *pixels.shape[2:]), spec.config)
        h = states[spec.config.encoder_layers]  # the final layer
        return h.reshape(b, t, *h.shape[1:])
    if spec.kind in VIT_KINDS:
        from videollamb_torch.models.vision.vit import vit_encode

        if spec.frame_wise:  # vit / vitmae: per-frame image models with CLS
            h = vit_encode(tower, pixels.reshape(b * t, 1, *pixels.shape[2:]), spec.config)
            return h.reshape(b, t, *h.shape[1:])
        # vivit / videomae: clip models over tubelets. Regroup the hidden
        # states per frame group and give each group a CLS slot (the group
        # mean; VideoMAE has no CLS, ViViT one global CLS) so every kind
        # keeps the bridges' (B, T', 1+n, D) contract.
        h = vit_encode(tower, pixels, spec.config)
        if spec.config.use_cls_token:
            h = h[:, 1:]
        n = spec.config.tokens_per_frame_group
        groups = h.reshape(b, h.shape[1] // n, n, h.shape[-1])
        return torch.cat([groups.mean(dim=2, keepdim=True), groups], dim=2)
    if spec.frame_wise:
        feats = vision_encode(tower, pixels.reshape(b * t, 1, *pixels.shape[2:]), spec.config)
        return feats.reshape(b, t, *feats.shape[2:])
    return vision_encode(tower, pixels, spec.config)
