"""LanguageBind joint-embedding meta-model.

Port of ``videollamb_tpu/models/binding.py`` (reference
llava/model/multimodal_encoder/languagebind/__init__.py:57-88): one CLIP
encoder, visual projection and logit scale per modality, plus the shared
language branch, producing L2-normalised embeddings in one space:

    out[m] = normalize(proj_m(encoder_m(x_m))) * exp(logit_scale_m)
    out['language'] = normalize(text_proj(text_encoder(ids)))

Every vision modality runs through the port's ``CLIPVisionTower`` (video
with temporal attention, kernel K2; every modality's spatial attention is
kernel K1; audio on the rectangular mel grid). Vision pooling is CLS per
frame, averaged over frames, then post-LN, as HF
``CLIPVisionModelWithProjection``. The text branch is a CLIP text
transformer (causal additive mask, EOT pooling) in plain PyTorch: its
attention is plain XLA in the JAX package too.

Module and parameter names follow the HF checkpoints: a modality's tower
holds ``vision_model.*``, the text encoder ``text_model.*``, and the
projections are bias-free ``nn.Linear`` in (out, in) orientation
(``visual_projection.weight`` / ``text_projection.weight``).
``models/convert.py`` maps the JAX tree both ways.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from dataclasses import dataclass
from typing import Dict, Mapping, Tuple

import torch
from torch import nn

from videollamb_torch.config import VisionConfig
from videollamb_torch.models.bridge.layers import _act
from videollamb_torch.models.seeded import empty_module, fill_dense_, generator
from videollamb_torch.models.vision.clip_vit import (
    CLIPAttention,
    CLIPMLP,
    CLIPVisionTower,
    init_vision_params,
    vision_encode,
)
from videollamb_torch.ops.temporal_attention import _layer_norm


@dataclass(frozen=True)
class TextConfig:
    """OpenCLIP ViT-L text branch (LanguageBind text encoders)."""

    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    vocab_size: int = 49408
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"


# ---------------------------------------------------------------------------
# CLIP text transformer
# ---------------------------------------------------------------------------


class CLIPTextEmbeddings(nn.Module):
    def __init__(self, cfg: TextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)


class CLIPTextLayer(nn.Module):
    def __init__(self, cfg: TextConfig):
        super().__init__()
        d = cfg.hidden_size
        self.self_attn = CLIPAttention(d)
        self.layer_norm1 = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.mlp = CLIPMLP(d, cfg.intermediate_size)
        self.layer_norm2 = nn.LayerNorm(d, eps=cfg.layer_norm_eps)


class CLIPTextEncoder(nn.Module):
    def __init__(self, cfg: TextConfig):
        super().__init__()
        self.layers = nn.ModuleList(CLIPTextLayer(cfg) for _ in range(cfg.num_hidden_layers))


class CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: TextConfig):
        super().__init__()
        self.embeddings = CLIPTextEmbeddings(cfg)
        self.encoder = CLIPTextEncoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class CLIPTextModel(nn.Module):
    """Text checkpoint root: parameters under ``text_model.*``."""

    def __init__(self, cfg: TextConfig):
        super().__init__()
        self.text_model = CLIPTextTransformer(cfg)


def _text_attention(attn: CLIPAttention, x: torch.Tensor, num_heads: int,
                    mask: torch.Tensor) -> torch.Tensor:
    """CLIPAttention with an additive mask (causal for text); f32 scores."""
    b, n, d = x.shape
    head_dim = d // num_heads

    def split(v):
        return v.reshape(b, n, num_heads, head_dim).transpose(1, 2)

    q = split(attn.q_proj(x) * head_dim ** -0.5)
    k = split(attn.k_proj(x))
    v = split(attn.v_proj(x))
    scores = torch.einsum("bhqe,bhke->bhqk", q.float(), k.float()) + mask
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bhke->bhqe", probs.float(), v.float()).to(x.dtype)
    return attn.out_proj(out.transpose(1, 2).reshape(b, n, d))


def text_encode(encoder: CLIPTextModel, input_ids: torch.Tensor, cfg: TextConfig) -> torch.Tensor:
    """(B, T) token ids -> (B, D) pooled text features: the final-LN hidden
    state at the EOT position, the per-row argmax id (HF CLIPTextModel
    pooling)."""
    tm = encoder.text_model
    b, t = input_ids.shape
    x = (tm.embeddings.token_embedding.weight[input_ids]
         + tm.embeddings.position_embedding.weight[None, :t])
    pos = torch.arange(t, device=input_ids.device)
    causal = torch.where(pos[:, None] >= pos[None, :], 0.0, -1e30).to(torch.float32)
    eps = cfg.layer_norm_eps
    for layer in tm.encoder.layers:
        h = _layer_norm(layer.layer_norm1, x, eps)
        x = x + _text_attention(layer.self_attn, h, cfg.num_attention_heads, causal)
        h = _layer_norm(layer.layer_norm2, x, eps)
        x = x + layer.mlp.fc2(_act(cfg.hidden_act, layer.mlp.fc1(h)))
    x = _layer_norm(tm.final_layer_norm, x, eps)
    eot = input_ids.argmax(dim=-1)  # highest id == EOT (CLIP BPE)
    return x[torch.arange(b, device=x.device), eot]


# ---------------------------------------------------------------------------
# Meta-model
# ---------------------------------------------------------------------------


class BindingModality(nn.Module):
    """One modality: tower, visual projection, logit scale (kept in f32)."""

    def __init__(self, cfg: VisionConfig, projection_dim: int):
        super().__init__()
        self.tower = CLIPVisionTower(cfg)
        self.projection = nn.Linear(cfg.hidden_size, projection_dim, bias=False)
        self.register_buffer("logit_scale", torch.zeros((), dtype=torch.float32))

    def _apply(self, fn, recurse=True):
        # Casts leave the logit scale in f32, as the JAX tree keeps it; it
        # only follows the module's device.
        scale = self.logit_scale
        super()._apply(fn, recurse)
        dev = self.projection.weight.device
        self.logit_scale = (torch.empty((), dtype=torch.float32, device=dev) if scale.is_meta
                            else scale.to(dev, torch.float32))
        return self


class BindingText(nn.Module):
    def __init__(self, cfg: TextConfig, projection_dim: int):
        super().__init__()
        self.encoder = CLIPTextModel(cfg)
        self.projection = nn.Linear(cfg.hidden_size, projection_dim, bias=False)


class LanguageBind(nn.Module):
    """Per-modality towers and the shared language branch."""

    def __init__(self, vision_cfgs: Mapping[str, VisionConfig], text_cfg: TextConfig = TextConfig(),
                 projection_dim: int = 768):
        super().__init__()
        self.modalities = nn.ModuleDict(
            {name: BindingModality(vcfg, projection_dim)
             for name, vcfg in sorted(vision_cfgs.items())})
        self.text = BindingText(text_cfg, projection_dim)


def convert_text_state_dict(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """HF ``CLIPTextModel`` state dict -> the state of :class:`CLIPTextModel`
    (the same names: the ``text_model.*`` entries, without buffers)."""
    return {k: torch.as_tensor(v) for k, v in sd.items()
            if k.startswith("text_model.") and not k.endswith("position_ids")}


def text_config_from_json(model_dir: str) -> TextConfig:
    """config.json ``text_config`` sub-dict -> TextConfig (LanguageBind /
    CLIP checkpoints are dual encoders with both sub-configs)."""
    path = os.path.join(model_dir, "config.json")
    if not os.path.exists(path):
        return TextConfig()
    with open(path) as f:
        raw = json.load(f)
    tc = raw.get("text_config", raw)
    return TextConfig(
        hidden_size=tc.get("hidden_size", 768),
        intermediate_size=tc.get("intermediate_size", 3072),
        num_hidden_layers=tc.get("num_hidden_layers", 12),
        num_attention_heads=tc.get("num_attention_heads", 12),
        vocab_size=tc.get("vocab_size", 49408),
        max_position_embeddings=tc.get("max_position_embeddings", 77),
        layer_norm_eps=tc.get("layer_norm_eps", 1e-5),
        hidden_act=tc.get("hidden_act", "quick_gelu"),
    )


def load_binding_checkpoints(paths: Dict[str, str], dtype=torch.float32, device="cuda"
                             ) -> Tuple[LanguageBind, Dict[str, VisionConfig], TextConfig]:
    """Modality name -> HF LanguageBind/CLIP dual-encoder checkpoint dir
    (e.g. {"video": ".../LanguageBind_Video_merge"}) -> (model, vision
    configs, text config). Each dir carries ``vision_model.*`` and
    ``visual_projection.weight`` (and ``logit_scale``); the shared language
    branch (``text_model.*`` and ``text_projection.weight``) comes from the
    first sorted dir that has one, as the reference builds it
    (languagebind/__init__.py:57-77)."""
    from videollamb_torch.models.builder import (
        load_state_dict,
        resolve_device,
        vision_config_from_tower_json,
    )
    from videollamb_torch.models.convert import tower_state

    device = resolve_device(device)
    vision_cfgs: Dict[str, VisionConfig] = {}
    text_cfg = TextConfig()
    state: Dict[str, torch.Tensor] = {}
    text_found = False
    for name in sorted(paths):
        sd = load_state_dict(paths[name])
        vcfg = vision_config_from_tower_json(paths[name]) or VisionConfig()
        # Trust the weights over the config default: plain CLIP encoders
        # (image towers) have no temporal layers.
        has_t = any(".temporal_attn." in k for k in sd if k.startswith("vision_model."))
        if vcfg.add_time_attn != has_t:
            vcfg = dataclasses.replace(vcfg, add_time_attn=has_t)
        vision_cfgs[name] = vcfg
        state.update({f"modalities.{name}.tower.{k}": v for k, v in tower_state(sd).items()})
        state[f"modalities.{name}.projection.weight"] = sd["visual_projection.weight"]
        scale = sd.get("logit_scale")
        state[f"modalities.{name}.logit_scale"] = torch.tensor(
            float(scale) if scale is not None else math.log(1 / 0.07), dtype=torch.float32)
        if not text_found and any(k.startswith("text_model.") for k in sd):
            state.update({f"text.encoder.{k}": v for k, v in convert_text_state_dict(sd).items()})
            state["text.projection.weight"] = sd["text_projection.weight"]
            text_cfg = text_config_from_json(paths[name])
            text_found = True
    if not text_found:
        raise ValueError(
            "no checkpoint dir carried a text branch (text_model.* keys): "
            "LanguageBind embeddings need the shared language encoder")
    projection_dim = state["text.projection.weight"].shape[0]
    model = empty_module(lambda: LanguageBind(vision_cfgs, text_cfg, projection_dim),
                         device, dtype)
    model.load_state_dict(state, strict=True)
    return model.eval(), vision_cfgs, text_cfg


def init_binding_params(vision_cfgs: Mapping[str, VisionConfig], text_cfg: TextConfig = TextConfig(),
                        projection_dim: int = 768, *, seed: int = 0, dtype=torch.float32,
                        device="cpu") -> LanguageBind:
    """Seeded random binding model (one tower, projection and logit scale per
    modality, plus the language branch; reference __init__.py:59-77): towers
    as ``init_vision_params``, uniform Linear weights of variance 1/fan_in,
    projections normal with std fan_in ** -0.5, token / position embeddings
    normal with std 0.02 / 0.01, unit LayerNorms, logit scales log(1/0.07)."""
    model = empty_module(lambda: LanguageBind(vision_cfgs, text_cfg, projection_dim),
                         device, dtype)
    g = generator(device, seed)
    with torch.no_grad():
        for i, (name, mod) in enumerate(model.modalities.items()):
            tower = init_vision_params(vision_cfgs[name], seed=seed + 1 + i, dtype=dtype,
                                       device=device)
            mod.tower.load_state_dict(tower.state_dict())
            w = mod.projection.weight
            w.normal_(0.0, w.shape[1] ** -0.5, generator=g)
            mod.logit_scale.fill_(math.log(1 / 0.07))
        for pname, p in model.text.named_parameters():
            if "norm" in pname:
                p.fill_(1.0 if pname.endswith("weight") else 0.0)
            elif pname.endswith("bias"):
                p.zero_()
            elif pname.endswith("token_embedding.weight"):
                p.normal_(0.0, 0.02, generator=g)
            elif pname.endswith("position_embedding.weight"):
                p.normal_(0.0, 0.01, generator=g)
            elif pname == "projection.weight":
                p.normal_(0.0, p.shape[1] ** -0.5, generator=g)
            else:
                fill_dense_(p, g)
    return model.eval()


def binding_encode_modality(model: LanguageBind, name: str, pixels: torch.Tensor,
                            cfg: VisionConfig, use_temp: bool = True) -> torch.Tensor:
    """pixels (B, T, C, H, W) -> (B, projection_dim) normalised embedding
    (reference forward, __init__.py:79-88: CLS pooled, post-LN, projection,
    L2 norm, scaled by exp(logit_scale))."""
    mod = model.modalities[name]
    layers = mod.tower.vision_model.encoder.layers
    feats = vision_encode(mod.tower, pixels, cfg, select_layer=len(layers))
    pooled = feats[:, :, 0].mean(dim=1)  # CLS per frame, frame-averaged
    pooled = _layer_norm(mod.tower.vision_model.post_layernorm, pooled, cfg.layer_norm_eps)
    emb = pooled @ mod.projection.weight.to(pooled.dtype).t()
    emb = emb / torch.linalg.vector_norm(emb.float(), dim=-1, keepdim=True).to(emb.dtype)
    if use_temp:
        emb = emb * torch.exp(mod.logit_scale).to(emb.dtype)
    return emb


def binding_encode_text(model: LanguageBind, input_ids: torch.Tensor,
                        cfg: TextConfig = TextConfig()) -> torch.Tensor:
    pooled = text_encode(model.text.encoder, input_ids, cfg)
    emb = pooled @ model.text.projection.weight.to(pooled.dtype).t()
    return emb / torch.linalg.vector_norm(emb.float(), dim=-1, keepdim=True).to(emb.dtype)


def language_bind_forward(model: LanguageBind, inputs: Dict[str, torch.Tensor],
                          vision_cfgs: Mapping[str, VisionConfig],
                          text_cfg: TextConfig = TextConfig(),
                          use_temp: bool = True) -> Dict[str, torch.Tensor]:
    """Dict of modality inputs -> dict of joint-space embeddings (reference
    LanguageBind.forward, __init__.py:79-88)."""
    out = {}
    for name, value in inputs.items():
        if name == "language":
            out[name] = binding_encode_text(model, value, text_cfg)
        else:
            out[name] = binding_encode_modality(model, name, value, vision_cfgs[name],
                                                use_temp=use_temp)
    return out
