"""The program's models, built from a configuration file with seeded weights.

The modules are the program's own, constructed on the meta device and
allocated on the card without their initialisers. Every parameter is then a
view into one flat buffer filled by ONE uniform draw of a generator on the
device, seeded by the run's seed; the leaves are laid out by scale class, so
that a few in-place products give each class its scale. The same tensors,
by their state-dict names, are what the reference reads.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch

from portbench.harness import config_path, load_json


def _scale_class(name: str, shape: Tuple[int, ...]) -> Tuple[float, float]:
    """(offset, half-width) of the uniform distribution a leaf is drawn from."""
    if "norm" in name:
        return (1.0, 0.1) if name.endswith("weight") else (0.0, 0.02)
    if name.endswith("bias"):
        return (0.0, 0.02)
    if name.endswith("embed_tokens.weight") or "memory" in name:
        return (0.0, math.sqrt(3.0))  # unit variance
    if name.endswith("patch_embedding.weight"):
        return (0.0, math.sqrt(3.0 / math.prod(shape[1:])))
    if "embedding" in name or name.endswith("query_tokens"):
        return (0.0, math.sqrt(3.0 / shape[-1]))
    if len(shape) >= 2:
        return (0.0, math.sqrt(3.0 / shape[1]))  # variance 1 / fan-in
    return (0.0, math.sqrt(3.0 / shape[0]))


def fill_seeded(module: torch.nn.Module, seed: int) -> Dict[str, torch.Tensor]:
    """Every parameter of ``module`` a view of one seeded draw; returns them by name."""
    params = dict(module.named_parameters())
    first = next(iter(params.values()))
    dev, dtype = first.device, first.dtype
    order = sorted(params, key=lambda n: (_scale_class(n, tuple(params[n].shape)), n))
    total = sum(params[n].numel() for n in order)
    g = torch.Generator(device=dev).manual_seed(seed % (2 ** 63))
    flat = torch.empty(total, dtype=dtype, device=dev).uniform_(-1.0, 1.0, generator=g)
    off, start, cls = 0, 0, None
    with torch.no_grad():
        for n in order + [None]:
            c = None if n is None else _scale_class(n, tuple(params[n].shape))
            if c != cls and cls is not None:  # scale the finished class in one product
                seg = flat[start:off]
                seg.mul_(cls[1])
                if cls[0]:
                    seg.add_(cls[0])
                start = off
            if n is None:
                break
            cls = c
            p = params[n]
            p.data = flat[off:off + p.numel()].view(p.shape)
            off += p.numel()
    return {n: params[n].data for n in params}


def _fields(cls, d: dict) -> dict:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


def model_config(cfg: dict):
    """The program's ``ModelConfig`` of a videollamb configuration file."""
    from videollamb_torch.config import BridgeConfig, LlamaConfig, ModelConfig, VisionConfig

    return ModelConfig(vision=VisionConfig(**_fields(VisionConfig, cfg["vision"])),
                       bridge=BridgeConfig(**_fields(BridgeConfig, cfg["bridge"])),
                       lm=LlamaConfig(**_fields(LlamaConfig, cfg["lm"])),
                       max_length=cfg["max_length"], num_frames=cfg["vision"]["num_frames"],
                       dtype=cfg["dtype"])


def _dtype(cfg: dict) -> torch.dtype:
    return getattr(torch, cfg["dtype"])


def build_videollamb(cfg: dict, seed: int, device):
    """(VideoLLaMB module, its ModelConfig, weights by state-dict name)."""
    from videollamb_torch.models.assembly import VideoLLaMB
    from videollamb_torch.models.bridge.rmt_r import RMTRBridge
    from videollamb_torch.models.lm.llama import LlamaForCausalLM
    from videollamb_torch.models.vision.clip_vit import CLIPVisionTower

    mcfg = model_config(cfg)
    with torch.device("meta"):
        model = VideoLLaMB(CLIPVisionTower(mcfg.vision),
                           RMTRBridge(mcfg.bridge, mcfg.lm.hidden_size),
                           LlamaForCausalLM(mcfg.lm))
    model = model.to(dtype=_dtype(cfg)).to_empty(device=device).eval()
    return model, mcfg, fill_seeded(model, seed)


def build_languagebind(cfg: dict, seed: int, device):
    """(LanguageBind module with a video modality, its VisionConfig, weights by name)."""
    from videollamb_torch.config import VisionConfig
    from videollamb_torch.models.binding import LanguageBind, TextConfig

    vcfg = VisionConfig(**_fields(VisionConfig, cfg["vision"]))
    tcfg = TextConfig(**_fields(TextConfig, cfg["text"]))
    with torch.device("meta"):
        model = LanguageBind({"video": vcfg}, tcfg, cfg["projection_dim"])
    model = model.to(dtype=_dtype(cfg)).to_empty(device=device).eval()
    weights = fill_seeded(model, seed)
    scale = model.modalities["video"].logit_scale
    scale.fill_(cfg["logit_scale"])
    weights["modalities.video.logit_scale"] = scale
    return model, vcfg, weights


def load_config(name: str) -> dict:
    return load_json(config_path(name))
