"""Checkpoint loading: ``load_pretrained_model`` for reference-format dirs.

Port of ``videollamb_tpu/models/builder.py`` (reference
llava/model/builder.py:26-195): a model dir with ``config.json`` and
``*.safetensors`` or ``pytorch_model*.bin`` shards (LM under ``model.*`` /
``lm_head``, bridge under ``model.mm_projector.*``), and a LanguageBind
tower dir with its own ``config.json`` and ``vision_model.*`` weights.
Safetensors shards are preferred, as in the JAX package, and read with
``safetensors.torch.load_file`` (imported only when a dir holds them);
``.bin`` shards with ``torch.load(weights_only=True)``. With
``model_base`` the checkpoint is a PEFT LoRA dir (``adapter_config.json``;
merged into the base at load, with ``non_lora_trainables.bin`` on top) or a
projector-only dir (``mm_projector.bin`` over the base). ``load_8bit``
quantises the LM to weight-only int8 after the cast
(``models/lm/quant.quantize_llama_params``). ``device_preprocess`` gives a
``DeviceVideoProcessor`` (``data/device_preprocess.py``: resize, crop and
normalise on the model's device) in place of the host ``VideoProcessor``.

The LM family comes from config.json's ``model_type``: ``deepseek_v3``
builds the DeepSeek-V3 family (``models/lm/mla.py``: latent attention,
routed and shared experts; Moonlight-16B-A3B's settings), whose experts'
weights are allocated stacked and loaded into place; anything else the
Llama decoder (Llama, Vicuna, Mistral). ``load_8bit`` is Llama-only.

``image_tower_path`` loads a LanguageBind image tower dir as
``VideoLLaMB.image_tower`` (with temporal layers only where its weights
have them); the ViT dims come from the video tower's config.json, else the
image tower's, as in the JAX package. The model loads onto the card unless
the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
from typing import Any, Dict, Optional, Tuple

import torch

from videollamb_torch.config import (
    BridgeConfig,
    LlamaConfig,
    MLAConfig,
    ModelConfig,
    RopeScaling,
    VisionConfig,
    is_mla,
)
from videollamb_torch.models.assembly import VideoLLaMB
from videollamb_torch.models.bridge.builder import RMT_R, bridge_module, init_bridge_params
from videollamb_torch.models.convert import split_reference_state, tower_state
from videollamb_torch.models.lm.llama import LlamaForCausalLM
from videollamb_torch.models.lm.mla import empty_mla_lm
from videollamb_torch.models.seeded import empty_module
from videollamb_torch.models.vision.clip_vit import CLIPVisionTower
from videollamb_torch.data.processing import ImageProcessor, VideoProcessor


def load_state_dict(model_dir: str) -> Dict[str, torch.Tensor]:
    """All tensors of the checkpoint shards in ``model_dir``: the
    ``*.safetensors`` shards when there are any, else the
    ``pytorch_model*.bin`` shards. Tensors keep their stored dtype."""
    sd: Dict[str, torch.Tensor] = {}
    st_files = sorted(glob.glob(os.path.join(model_dir, "*.safetensors")))
    if st_files:
        try:
            from safetensors.torch import load_file
        except ImportError as exc:
            raise ImportError(
                f"{model_dir} holds *.safetensors shards; reading them needs the "
                "safetensors package") from exc
        for f in st_files:
            sd.update(load_file(f, device="cpu"))
        return sd
    files = sorted(glob.glob(os.path.join(model_dir, "pytorch_model*.bin")))
    if not files:
        raise FileNotFoundError(f"no *.safetensors or pytorch_model*.bin in {model_dir}")
    for f in files:
        sd.update(torch.load(f, map_location="cpu", weights_only=True))
    return sd


def config_from_json(model_dir: str) -> ModelConfig:
    """The typed ModelConfig from a reference-format config.json."""
    with open(os.path.join(model_dir, "config.json")) as f:
        raw = json.load(f)
    lm = mla_config_from_json(raw) if raw.get("model_type") == "deepseek_v3" else LlamaConfig(
        vocab_size=raw.get("vocab_size", 32000),
        hidden_size=raw.get("hidden_size", 4096),
        intermediate_size=raw.get("intermediate_size", 11008),
        num_hidden_layers=raw.get("num_hidden_layers", 32),
        num_attention_heads=raw.get("num_attention_heads", 32),
        num_key_value_heads=raw.get("num_key_value_heads",
                                    raw.get("num_attention_heads", 32)),
        max_position_embeddings=raw.get("max_position_embeddings", 4096),
        rms_norm_eps=raw.get("rms_norm_eps", 1e-5),
        rope_theta=raw.get("rope_theta", 10000.0),
        rope_scaling=RopeScaling.from_hf(raw.get("rope_scaling")),
        sliding_window=(raw.get("sliding_window")
                        if raw.get("model_type") == "mistral" else None),
    )
    bridge = BridgeConfig.from_projector_type(
        raw.get("mm_projector_type", "rmt_r_transformer1x"),
        hidden_size=raw.get("mm_hidden_size", 1024))
    vision = VisionConfig(
        hidden_size=raw.get("mm_hidden_size", 1024),
        select_layer=raw.get("mm_vision_select_layer", -2),
        select_feature=raw.get("mm_vision_select_feature", "patch"))
    return ModelConfig(
        vision=vision, bridge=bridge, lm=lm,
        max_length=raw.get("tokenizer_model_max_length",
                           raw.get("max_sequence_length", 2048)),
        num_frames=raw.get("num_frames", 8),
        use_video_tower=bool(raw.get("mm_video_tower")),
        use_image_tower=bool(raw.get("mm_image_tower")))


def mla_config_from_json(raw: Dict[str, Any]) -> MLAConfig:
    """The DeepSeek-V3 family's settings of an HF config.json (defaults:
    Moonlight-16B-A3B's)."""
    keys = [f.name for f in dataclasses.fields(MLAConfig) if f.name != "rope_scaling"]
    return MLAConfig(rope_scaling=RopeScaling.from_hf(raw.get("rope_scaling")),
                     **{k: raw[k] for k in keys if k in raw})


def vision_config_from_tower_json(tower_dir: str) -> Optional[VisionConfig]:
    """A LanguageBind tower's config.json (``vision_config`` sub-dict) as a
    VisionConfig; None when the dir has no config.json."""
    path = os.path.join(tower_dir, "config.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        raw = json.load(f)
    vc = raw.get("vision_config", raw)
    return VisionConfig(
        hidden_size=vc.get("hidden_size", 1024),
        intermediate_size=vc.get("intermediate_size", 4096),
        num_hidden_layers=vc.get("num_hidden_layers", 24),
        num_attention_heads=vc.get("num_attention_heads", 16),
        image_size=vc.get("image_size", 224),
        patch_size=vc.get("patch_size", 14),
        num_frames=vc.get("num_frames", 8),
        add_time_attn=vc.get("add_time_attn", True),
        hidden_act=vc.get("hidden_act", "quick_gelu"),
        layer_norm_eps=vc.get("layer_norm_eps", 1e-5))


def resolve_device(device) -> torch.device:
    """The torch device to run on; a CUDA device must exist (no CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: videollamb_torch runs on the GPU by default; pass "
            "device='cpu' (--device cpu on the command line) to run on the CPU")
    return dev


def _merge_lora(base_sd: Dict[str, torch.Tensor], lora_dir: str,
                scaling: Optional[float] = None) -> Dict[str, torch.Tensor]:
    """Merge PEFT LoRA adapter weights into a base state dict
    (``merge_and_unload``): ``W += (B @ A) * lora_alpha / r``."""
    with open(os.path.join(lora_dir, "adapter_config.json")) as f:
        acfg = json.load(f)
    if scaling is None:
        scaling = acfg["lora_alpha"] / acfg["r"]
    lora_sd = load_state_dict(lora_dir)
    # Keys: base_model.model.<name>.lora_A.weight / lora_B.weight
    for k in [k for k in lora_sd if k.endswith("lora_A.weight")]:
        b_key = k.replace("lora_A.weight", "lora_B.weight")
        target = k.replace("base_model.model.", "").replace(".lora_A.weight", ".weight")
        if target not in base_sd:
            continue
        delta = (lora_sd[b_key].float() @ lora_sd[k].float()) * scaling
        base_sd[target] = base_sd[target] + delta.to(base_sd[target].dtype)
    return base_sd


def _resolve_state(model_path: str, model_base: Optional[str]) -> Dict[str, torch.Tensor]:
    """The full state dict of a checkpoint: LoRA dir over its base, projector
    file over its base, or a full checkpoint."""
    is_lora = os.path.exists(os.path.join(model_path, "adapter_config.json"))
    projector_bin = os.path.join(model_path, "mm_projector.bin")
    if model_base is not None and os.path.exists(projector_bin):
        full_sd = load_state_dict(model_base)
        full_sd.update(torch.load(projector_bin, map_location="cpu", weights_only=True))
        return full_sd
    if is_lora:
        base_sd = load_state_dict(model_base)
        extra = os.path.join(model_path, "non_lora_trainables.bin")
        if os.path.exists(extra):
            for k, v in torch.load(extra, map_location="cpu", weights_only=True).items():
                base_sd[k.replace("base_model.model.", "").replace("base_model.", "")] = v
        return _merge_lora(base_sd, model_path)
    return load_state_dict(model_path)


def _load(factory, state, device, dtype) -> torch.nn.Module:
    module = empty_module(factory, device, dtype)
    module.load_state_dict(state, strict=True)
    return module


def load_pretrained_model(
    model_path: str,
    model_base: Optional[str] = None,
    *,
    video_tower_path: Optional[str] = None,
    image_tower_path: Optional[str] = None,
    dtype: str = "bfloat16",
    load_8bit: bool = False,
    load_tokenizer: bool = True,
    device_preprocess: bool = False,
    device="cuda",
    bridge_seed: Optional[int] = None,
    projector_type: Optional[str] = None,
) -> Tuple[Any, VideoLLaMB, ModelConfig, Dict[str, Any], int]:
    """Resolve a checkpoint (full, base + projector, or LoRA) into a model.

    - ``model_base`` set and ``adapter_config.json`` present: LoRA merge;
    - ``model_base`` set and ``mm_projector.bin`` present: projector only;
    - else a full checkpoint.

    A checkpoint without a projector (a base LM, the start of stage-1
    training) gets a new seeded one of any kind when ``bridge_seed`` is
    given, and fails to load otherwise (unless its kind has no parameters).
    The new projector is built from ``projector_type``
    (``--mm_projector_type``) when given, else from config.json, and the
    returned config says which. Checkpoint projector weights load for the
    RMT-R bridge only, as in the JAX package.

    Returns (tokenizer, model, config, processors, context_len), the tuple
    the reference returns; the tokenizer is None unless ``load_tokenizer``.
    """
    device = resolve_device(device)
    wanted = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    is_lora = os.path.exists(os.path.join(model_path, "adapter_config.json"))
    based = model_base is not None and (
        is_lora or os.path.exists(os.path.join(model_path, "mm_projector.bin")))
    cfg_dir = model_base if based and os.path.exists(
        os.path.join(model_base, "config.json")) else model_path
    cfg = config_from_json(cfg_dir)
    lm_sd, bridge_sd = split_reference_state(_resolve_state(model_path, model_base))

    # Tower dirs carry the ViT dims (config.json only knows mm_hidden_size);
    # the towers rebuild from their own config (languagebind/__init__.py:248-251).
    tower_cfg_dir = video_tower_path or image_tower_path
    if tower_cfg_dir:
        vision = vision_config_from_tower_json(tower_cfg_dir)
        if vision is not None:
            cfg = dataclasses.replace(cfg, vision=dataclasses.replace(
                vision, select_layer=cfg.vision.select_layer,
                select_feature=cfg.vision.select_feature))
    video_tower = image_tower = None
    if video_tower_path:
        video_tower = _load(lambda: CLIPVisionTower(cfg.vision),
                            tower_state(load_state_dict(video_tower_path)), device, wanted)
    if image_tower_path:
        state = tower_state(load_state_dict(image_tower_path))
        # An image encodes at T = 1, which never runs temporal attention:
        # the module has temporal layers only where the checkpoint does.
        icfg = dataclasses.replace(
            cfg.vision, add_time_attn=any(".temporal_attn." in k for k in state))
        image_tower = _load(lambda: CLIPVisionTower(icfg), state, device, wanted)
    if is_mla(cfg.lm):
        if load_8bit:
            raise ValueError("int8 weights (load_8bit) are for the Llama family; the "
                             "DeepSeek-V3 family loads in bf16 or f32")
        lm = empty_mla_lm(cfg.lm, device, wanted)
        lm.load_state_dict(lm_sd, strict=True)
    else:
        lm = _load(lambda: LlamaForCausalLM(cfg.lm), lm_sd, device, wanted)
    if bridge_sd and cfg.bridge.kind != RMT_R:
        # The JAX package converts projector keys as RMT-R's only (and fails
        # with a KeyError on another kind's).
        raise ValueError(
            f"{model_path} carries mm_projector weights for a {cfg.bridge.kind!r} "
            f"projector (mm_projector_type {cfg.bridge.projector_type!r}); projector "
            f"weights load for the {RMT_R} bridge only")
    if bridge_sd or bridge_seed is None:
        bridge = _load(lambda: bridge_module(cfg.bridge, cfg.lm.hidden_size), bridge_sd,
                       device, wanted)
    else:
        if projector_type is not None:
            cfg = dataclasses.replace(cfg, bridge=BridgeConfig.from_projector_type(
                projector_type, hidden_size=cfg.bridge.hidden_size))
        bridge = init_bridge_params(cfg.bridge, cfg.lm.hidden_size, seed=bridge_seed,
                                    dtype=wanted, device=device)
    if load_8bit:  # weight-only int8 LM, quantised where it lies
        from videollamb_torch.models.lm.quant import quantize_llama_params

        lm = quantize_llama_params(lm)
    model = VideoLLaMB(video_tower, bridge, lm, image_tower)

    tokenizer = None
    if load_tokenizer:
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(model_base or model_path, use_fast=True)
    if device_preprocess:
        from videollamb_torch.data.device_preprocess import DeviceVideoProcessor

        video_proc: Any = DeviceVideoProcessor(size=cfg.vision.image_size, device=device)
    else:
        video_proc = VideoProcessor(size=cfg.vision.image_size)
    processors = {"VIDEO": video_proc, "IMAGE": ImageProcessor(size=cfg.vision.image_size)}
    return tokenizer, model, cfg, processors, cfg.max_length
