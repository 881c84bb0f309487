"""Typed model configuration of the port.

A copy of the model dataclasses of ``videollamb_tpu/config.py`` with the
same names, fields and defaults, so one ``ModelConfig`` (or one
checkpoint's ``config.json``) describes the same model in both packages,
and of its ``TrainConfig``. The sharding and generation configs stay with
the JAX package.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple, Union


@dataclass(frozen=True)
class VisionConfig:
    """LanguageBind-style CLIP ViT with optional per-layer temporal attention.

    Defaults are CLIP-ViT-L/14 @224 as used by LanguageBind video/image
    towers (reference: llava/model/multimodal_encoder/languagebind/video/
    configuration_video.py ``CLIPVisionConfig``).
    """

    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    image_size: int = 224
    patch_size: int = 14
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"
    # Temporal attention (video tower). The reference hard-codes t=8
    # (modeling_video.py:92-93): a learned (1, 8, d) temporal embedding and a
    # temporal self-attention before each spatial attention.
    add_time_attn: bool = True
    num_frames: int = 8
    # Which hidden state feeds the projector: -2 == penultimate layer output
    # (reference: mm_vision_select_layer default).
    select_layer: int = -2
    select_feature: str = "patch"  # 'patch' keeps CLS+patches per frame
    # Rectangular input grid (audio tower: mel-spectrogram "images" of
    # [num_mel_bins, target_length], reference modeling_audio.py:808-812
    # resize_pos). None -> square image_size x image_size.
    image_size_hw: Optional[Tuple[int, int]] = None

    @property
    def grid_hw(self) -> Tuple[int, int]:
        if self.image_size_hw is not None:
            return (self.image_size_hw[0] // self.patch_size,
                    self.image_size_hw[1] // self.patch_size)
        side = self.image_size // self.patch_size
        return (side, side)

    @property
    def num_patches_per_side(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        gh, gw = self.grid_hw
        return gh * gw

    @property
    def seq_len(self) -> int:
        return self.num_patches + 1  # + CLS

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


@dataclass(frozen=True)
class BridgeConfig:
    """Memory Bridge (recurrent-memory transformer projector) configuration.

    Mirrors the hard-coded reference values (llava/model/llava_arch.py:187-195
    and multimodal_projector/rmt_r_transformer_projector.py:186-288):
    1024-d bridge with 8 heads, GELU, 32 memory tokens, 12x12 pooled frames.
    """

    kind: str = "rmt_r_transformer"  # identity|linear|mlp|transformer|rmt_transformer|rmt_r_transformer|qformer|spatial_pool|mlp_transformer
    depth: int = 1
    hidden_size: int = 1024  # == vision tower hidden size (mm_hidden_size)
    num_attention_heads: int = 8
    intermediate_size: int = 4096
    hidden_act: str = "gelu"
    layer_norm_eps: float = 1e-12
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    num_memory_tokens: int = 32
    # Spatial pooling target (reference: rmt_r_transformer_projector.py:287).
    pool_h: int = 12
    pool_w: int = 12
    # SceneTilling segmentation: prod uses fixed top-k=3 boundaries
    # (rmt_r_transformer_projector.py:350); +1 for the appended final frame.
    segment_topk: int = 3
    # Frames per segment fed to the bridge (linspace subsample cap,
    # rmt_r_transformer_projector.py:370).
    max_frames_per_segment: int = 8
    # MLP-family depth (mlp2x_gelu etc.).
    mlp_depth: int = 2
    # QFormer variant params (qformer{layers}_{queries}).
    qformer_layers: int = 2
    qformer_queries: int = 32

    @property
    def max_segments(self) -> int:
        return self.segment_topk + 1

    @property
    def tokens_per_frame(self) -> int:
        return self.pool_h * self.pool_w

    @property
    def tokens_per_segment(self) -> int:
        return self.max_frames_per_segment * self.tokens_per_frame

    @staticmethod
    def from_projector_type(projector_type: str, **overrides: Any) -> "BridgeConfig":
        """Parse a reference-style projector type string.

        Accepts the full grammar of the reference factory
        (multimodal_projector/builder.py:13-53): ``identity``, ``linear``,
        ``mlp{N}x_gelu``, ``spatial_pool``, ``transformer{N}x``,
        ``mlp_transformer{N}x``, ``rmt_transformer{N}x``,
        ``rmt_r_transformer{N}x``, ``qformer{L}_{Q}``.
        """
        cfg = dict(overrides)
        m = re.match(r"^qformer(\d+)_(\d+)$", projector_type)
        if m:
            return BridgeConfig(kind="qformer", qformer_layers=int(m.group(1)),
                                qformer_queries=int(m.group(2)), **cfg)
        m = re.match(r"^mlp(\d+)x_gelu$", projector_type)
        if m:
            return BridgeConfig(kind="mlp", mlp_depth=int(m.group(1)), **cfg)
        m = re.match(r"^(rmt_r_transformer|rmt_transformer|mlp_transformer|transformer)(\d+)x$", projector_type)
        if m:
            return BridgeConfig(kind=m.group(1), depth=int(m.group(2)), **cfg)
        m = re.match(r"^retention_transformer(\d+)x$", projector_type)
        if m:
            # Our name — the reference never registers its retention module
            # in the factory. The module hard-codes 128 memory tokens
            # (retent_transformer_projector.py:480).
            cfg.setdefault("num_memory_tokens", 128)
            return BridgeConfig(kind="retention", depth=int(m.group(1)), **cfg)
        if projector_type in ("identity", "linear", "spatial_pool"):
            return BridgeConfig(kind=projector_type, **cfg)
        raise ValueError(f"Unknown projector type: {projector_type!r}")

    @property
    def projector_type(self) -> str:
        """Reference-style name (for checkpoint config round-tripping)."""
        if self.kind == "qformer":
            return f"qformer{self.qformer_layers}_{self.qformer_queries}"
        if self.kind == "mlp":
            return f"mlp{self.mlp_depth}x_gelu"
        if self.kind in ("identity", "linear", "spatial_pool"):
            return self.kind
        if self.kind == "retention":
            return f"retention_transformer{self.depth}x"
        return f"{self.kind}{self.depth}x"


@dataclass(frozen=True)
class RopeScaling:
    """Long-context RoPE scaling (HF ``rope_scaling`` parity).

    The reference caps its LLM context at 2048 and never scales RoPE;
    modern Llama-family checkpoints (e.g. Llama-3.1) ship scaled rope
    configs, so loading them needs this. Types:

    - ``linear``: positions interpolate by 1/factor (inv_freq / factor);
    - ``dynamic``: NTK-aware base rescaling. HF recomputes the table per
      current sequence length; XLA needs a STATIC table, so ours is
      computed once for ``target_length`` (default: the model's
      max_position_embeddings, where HF's formula reduces to the UNSCALED
      base — so default behavior matches HF exactly for every sequence up
      to the trained maximum, the common regime). Set ``target_length``
      explicitly when actually running contexts beyond the trained
      maximum; the two then agree exactly at that length;
    - ``llama3``: frequency-dependent wavelength interpolation (the
      Llama-3.1 scheme: long wavelengths scale by 1/factor, short ones
      keep, mid band blends).
    """

    rope_type: str = "linear"  # 'linear' | 'dynamic' | 'llama3'
    factor: float = 1.0
    # llama3 only:
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position_embeddings: int = 8192
    # dynamic only: the static sequence length the NTK base is computed
    # for (None -> the model's max_position_embeddings).
    target_length: Optional[int] = None

    @staticmethod
    def from_hf(d: Optional[dict]) -> Optional["RopeScaling"]:
        """Map an HF config.json ``rope_scaling`` dict (old 'type' or new
        'rope_type' key). Returns None for null/'default'."""
        if not d:
            return None
        t = d.get("rope_type", d.get("type", "default"))
        if t == "default":
            return None
        return RopeScaling(
            rope_type=t,
            factor=float(d.get("factor", 1.0)),
            low_freq_factor=float(d.get("low_freq_factor", 1.0)),
            high_freq_factor=float(d.get("high_freq_factor", 4.0)),
            original_max_position_embeddings=int(
                d.get("original_max_position_embeddings", 8192)),
        )


@dataclass(frozen=True)
class LlamaConfig:
    """Llama-family LM backbone (Vicuna-7B defaults)."""

    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    # Mistral-style sliding-window attention (None = full causal).
    sliding_window: Optional[int] = None
    # Long-context rope scaling (None = unscaled).
    rope_scaling: Optional[RopeScaling] = None

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @staticmethod
    def mistral_7b(**overrides: Any) -> "LlamaConfig":
        """Mistral-7B-v0.1 dims (reference LlavaMistralForCausalLM backbone,
        llava/model/language_model/llava_mistral.py:42 — same decoder as
        Llama with GQA + sliding window)."""
        base = dict(vocab_size=32000, hidden_size=4096, intermediate_size=14336,
                    num_hidden_layers=32, num_attention_heads=32,
                    num_key_value_heads=8, max_position_embeddings=32768,
                    rms_norm_eps=1e-5, rope_theta=10000.0, sliding_window=4096)
        base.update(overrides)
        return LlamaConfig(**base)

    @staticmethod
    def tiny(**overrides: Any) -> "LlamaConfig":
        base = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                    num_hidden_layers=2, num_attention_heads=4,
                    num_key_value_heads=2, max_position_embeddings=512)
        base.update(overrides)
        return LlamaConfig(**base)


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V3-family LM backbone (HF ``model_type: deepseek_v3``):
    multi-head latent attention and sigmoid-routed experts with shared
    experts (``models/lm/mla.py``). Defaults are Moonlight-16B-A3B's
    published config.json. Only the settings that model uses are supported:
    no q compression (``q_lora_rank`` None), one routing group, unscaled
    RoPE."""

    vocab_size: int = 163840
    hidden_size: int = 2048
    intermediate_size: int = 11264       # the leading dense layers' MLP
    moe_intermediate_size: int = 1408    # each routed expert; shared: x n_shared_experts
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    kv_lora_rank: int = 512
    q_lora_rank: Optional[int] = None
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    first_k_dense_replace: int = 1
    moe_layer_freq: int = 1
    routed_scaling_factor: float = 2.446
    norm_topk_prob: bool = True
    scoring_func: str = "sigmoid"
    topk_method: str = "noaux_tc"
    n_group: int = 1
    topk_group: int = 1
    max_position_embeddings: int = 8192
    rms_norm_eps: float = 1e-5
    rope_theta: float = 50000.0
    tie_word_embeddings: bool = False
    rope_scaling: Optional[RopeScaling] = None

    def __post_init__(self):
        unsupported = []
        if self.q_lora_rank is not None:
            unsupported.append(f"q_lora_rank={self.q_lora_rank} (q compression)")
        if self.scoring_func != "sigmoid" or self.topk_method != "noaux_tc":
            unsupported.append(f"routing {self.scoring_func}/{self.topk_method}")
        if self.n_group != 1 or self.topk_group != 1:
            unsupported.append(f"{self.n_group} routing groups")
        if self.rope_scaling is not None or self.moe_layer_freq != 1:
            unsupported.append("rope_scaling / moe_layer_freq != 1")
        if unsupported:
            raise ValueError("MLAConfig supports Moonlight-style DeepSeek-V3 settings only; "
                             "got " + ", ".join(unsupported))

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent_dim(self) -> int:
        """Width of one cached row a token and layer: the kv latent and the roped key."""
        return self.kv_lora_rank + self.qk_rope_head_dim

    @property
    def softmax_scale(self) -> float:
        return self.qk_head_dim ** -0.5

    @property
    def head_dim(self) -> int:  # the RoPE tables' width (models/lm/rope.rope_cos_sin_cfg)
        return self.qk_rope_head_dim

    def is_moe_layer(self, i: int) -> bool:
        return i >= self.first_k_dense_replace

    @property
    def num_moe_layers(self) -> int:
        return self.num_hidden_layers - self.first_k_dense_replace

    @staticmethod
    def tiny(**overrides: Any) -> "MLAConfig":
        base = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                    moe_intermediate_size=32, num_hidden_layers=3, num_attention_heads=4,
                    kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=16, v_head_dim=16,
                    n_routed_experts=8, n_shared_experts=1, num_experts_per_tok=2,
                    max_position_embeddings=1024)
        base.update(overrides)
        return MLAConfig(**base)


def is_mla(lm_cfg) -> bool:
    """Whether an LM config is the latent-attention / routed-expert family."""
    return isinstance(lm_cfg, MLAConfig)


@dataclass(frozen=True)
class ModelConfig:
    """Full multimodal model assembly."""

    vision: VisionConfig = field(default_factory=VisionConfig)
    bridge: BridgeConfig = field(default_factory=BridgeConfig)
    # LlamaConfig (Llama, Vicuna, Mistral) or MLAConfig (DeepSeek-V3 family).
    lm: Union[LlamaConfig, MLAConfig] = field(default_factory=LlamaConfig)
    # Optional non-CLIP tower routing: a models.vision.builder.TowerSpec.
    # When set, assembly encodes pixels via tower_encode(tower, ...) instead
    # of the default CLIP-family vision_encode — this is how the research
    # towers (ViT/MAE/ViViT/VideoMAE, EgoVLP, deformable, RMT encoder) run
    # end-to-end (reference wires them via mm_vision_tower name dispatch,
    # multimodal_encoder/builder.py:14-61).
    tower: Optional[Any] = None
    # Max tokens after multimodal splice (reference: --model_max_length 2048,
    # truncation at llava_arch.py:610-613).
    max_length: int = 2048
    num_frames: int = 8
    dtype: str = "bfloat16"
    # Which modalities this checkpoint handles.
    use_image_tower: bool = True
    use_video_tower: bool = True
    # Anyres multi-patch images (reference llava_arch.py:265-331 +
    # mm_utils.py:120-146): 'flat' | 'spatial' | 'spatial_unpad'.
    mm_patch_merge_type: str = "flat"
    image_aspect_ratio: str = "square"  # 'square' | 'pad' | 'anyres'
    # ((w, h), ...) pinpoint resolutions for anyres patching.
    image_grid_pinpoints: Optional[Tuple[Tuple[int, int], ...]] = None

    @staticmethod
    def tiny(**overrides: Any) -> "ModelConfig":
        """A small config for tests: same topology, tiny dims."""
        base = dict(
            vision=VisionConfig(hidden_size=32, intermediate_size=64,
                                num_hidden_layers=2, num_attention_heads=4,
                                image_size=56, patch_size=14),
            bridge=BridgeConfig(hidden_size=32, num_attention_heads=4,
                                intermediate_size=64, num_memory_tokens=8,
                                pool_h=2, pool_w=2),
            lm=LlamaConfig.tiny(),
            max_length=512,
            dtype="float32",
        )
        base.update(overrides)
        return ModelConfig(**base)


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 2e-5
    mm_projector_lr: Optional[float] = None
    weight_decay: float = 0.0
    warmup_ratio: float = 0.03
    lr_schedule: str = "cosine"
    num_train_epochs: int = 1
    per_device_batch_size: int = 8
    gradient_accumulation_steps: int = 1
    seed: int = 42
    bf16: bool = True
    gradient_checkpointing: bool = True
    max_grad_norm: float = 1.0
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    # Which parameters train: 'full', 'adapter' (mm_projector only,
    # reference --tune_mm_mlp_adapter), or 'lora'.
    tune_mode: str = "full"
    # RMT-loss (retro) training: per-segment LM loss through the recurrence.
    rmt_loss: bool = False
    lora_r: int = 128
    lora_alpha: int = 256
    lora_dropout: float = 0.05
    save_steps: int = 50000
    save_total_limit: int = 1
    logging_steps: int = 1
    output_dir: str = "./checkpoints"
    # Packed-sequence training (train/dataset.PackedCollator): each step
    # consumes per_device_batch_size * pack_factor samples packed into
    # per_device_batch_size rows under segment-ID block-causal attention.
    pack_sequences: bool = False
    pack_factor: int = 2
