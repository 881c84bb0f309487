"""Shared helpers of the PyTorch port's parity tests, and tests of the helpers.

The parity tests feed the same seeded parameters and inputs (numpy) to the
JAX package (CPU backend) and to ``videollamb_torch`` and compare the
outputs. The helpers here build those parameters, load them into the
port, and write a seeded reference-format checkpoint (model dir + tower
dir) that both packages' loaders read.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from videollamb_tpu.config import BridgeConfig, LlamaConfig, ModelConfig, VisionConfig  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def port_config(jcfg: ModelConfig):
    """The port's ModelConfig with the same fields as a JAX ModelConfig: the
    packages keep separate dataclasses, so compare them with ``asdict``."""
    from videollamb_torch import config as pc

    fields = dataclasses.asdict(jcfg)
    lm = dict(fields.pop("lm"))
    rope = lm.pop("rope_scaling")
    return pc.ModelConfig(
        vision=pc.VisionConfig(**fields.pop("vision")),
        bridge=pc.BridgeConfig(**fields.pop("bridge")),
        lm=pc.LlamaConfig(**lm, rope_scaling=pc.RopeScaling(**rope) if rope else None),
        **fields)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def jax_params(cfg: ModelConfig, seed: int = 0) -> dict:
    """Seeded f32 JAX parameter tree (numpy leaves) of the whole model."""
    from videollamb_tpu.models.bridge.rmt_r import init_rmt_r_params
    from videollamb_tpu.models.lm.llama import init_llama_params
    from videollamb_tpu.models.vision.clip_vit import init_vision_params

    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    return np_tree({
        "video_tower": init_vision_params(k1, cfg.vision),
        "mm_projector": init_rmt_r_params(k2, cfg.bridge, cfg.lm.hidden_size),
        "lm": init_llama_params(k3, cfg.lm),
    })


def _draw(rng, path, shape) -> np.ndarray:
    """A random leaf at a scale that keeps activations of order one: He
    convolutions, 1/sqrt(fan_in) dense kernels, norms (a dict's ``scale``,
    an array named for a norm) and BatchNorm statistics near identity, small
    biases, embeddings and stacked LM projections."""
    name = str(getattr(path[-1], "key", ""))
    x = rng.normal(size=shape)
    if name == "kernel":
        fan_in = int(np.prod(shape[1:])) if len(shape) == 4 else shape[0]
        x = x * (2.0 / fan_in) ** 0.5
    elif name == "var":
        x = 1.0 + 0.1 * np.abs(x)
    elif name == "scale" or "norm" in name:
        x = 1.0 + 0.1 * x
    else:
        x = 0.05 * x
    return x.astype(np.float32)


def drawn_tree(init, seed: int = 0) -> dict:
    """The tree ``init(key)`` builds, every leaf drawn from a numpy seed
    (``jax.eval_shape``: nothing of the initialiser runs, which op by op
    costs seconds of compiles)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(init, jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map_with_path(lambda path, a: _draw(rng, path, a.shape), shapes)


def drawn_params(cfg: ModelConfig, seed: int = 0) -> dict:
    """``jax_params``' tree with every leaf drawn by :func:`drawn_tree`."""
    from videollamb_tpu.models.bridge.rmt_r import init_rmt_r_params
    from videollamb_tpu.models.lm.llama import init_llama_params
    from videollamb_tpu.models.vision.clip_vit import init_vision_params

    def init(key):
        k1, k2, k3 = jax.random.split(key, 3)
        return {"video_tower": init_vision_params(k1, cfg.vision),
                "mm_projector": init_rmt_r_params(k2, cfg.bridge, cfg.lm.hidden_size),
                "lm": init_llama_params(k3, cfg.lm)}

    return drawn_tree(init, seed)


def port_model(cfg: ModelConfig, tree: dict):
    """The port's f32 CPU model holding the JAX tree's parameters."""
    from videollamb_torch.models.assembly import VideoLLaMB
    from videollamb_torch.models.bridge.rmt_r import RMTRBridge
    from videollamb_torch.models.convert import from_jax_params
    from videollamb_torch.models.lm.llama import LlamaForCausalLM
    from videollamb_torch.models.vision.clip_vit import CLIPVisionTower

    cfg = port_config(cfg)
    model = VideoLLaMB(CLIPVisionTower(cfg.vision),
                       RMTRBridge(cfg.bridge, cfg.lm.hidden_size), LlamaForCausalLM(cfg.lm))
    model.load_state_dict(from_jax_params(tree), strict=True)
    return model.eval()


def export_vision_state_dict(tree: dict, prefix: str = "vision_model.") -> dict:
    """Inverse of ``videollamb_tpu.models.vision.convert.convert_vision_state_dict``:
    JAX tower tree -> LanguageBind tower state dict (numpy)."""
    out = {}

    def dense(node, key):
        out[f"{key}.weight"] = np.asarray(node["kernel"]).T.copy()
        out[f"{key}.bias"] = np.asarray(node["bias"]).copy()

    def ln(node, key):
        out[f"{key}.weight"] = np.asarray(node["scale"]).copy()
        out[f"{key}.bias"] = np.asarray(node["bias"]).copy()

    def attn(node, key):
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            dense(node[name], f"{key}.{name}")

    emb = tree["embeddings"]
    kernel = np.asarray(emb["patch_embedding"]["kernel"])
    d = kernel.shape[1]
    p = int(round((kernel.shape[0] // 3) ** 0.5))
    out["embeddings.class_embedding"] = np.asarray(emb["class_embedding"]).copy()
    out["embeddings.patch_embedding.weight"] = kernel.T.reshape(d, 3, p, p).copy()
    out["embeddings.position_embedding.weight"] = np.asarray(emb["position_embedding"]).copy()
    ln(tree["pre_layrnorm"], "pre_layrnorm")
    ln(tree["post_layernorm"], "post_layernorm")
    for i, layer in enumerate(tree["layers"]):
        key = f"encoder.layers.{i}"
        ln(layer["layer_norm1"], f"{key}.layer_norm1")
        ln(layer["layer_norm2"], f"{key}.layer_norm2")
        attn(layer["self_attn"], f"{key}.self_attn")
        dense(layer["mlp"]["fc1"], f"{key}.mlp.fc1")
        dense(layer["mlp"]["fc2"], f"{key}.mlp.fc2")
        if "temporal_attn" in layer:
            attn(layer["temporal_attn"], f"{key}.temporal_attn")
            ln(layer["temporal_layer_norm1"], f"{key}.temporal_layer_norm1")
            out[f"{key}.temporal_embedding"] = np.asarray(layer["temporal_embedding"])[None].copy()
    return {prefix + k: v for k, v in out.items()}


# A small checkpoint with the topology of VideoLLaMB-7B: the bridge keeps
# the dims config.json cannot override (12x12 pooling, 32 memory tokens,
# 8 heads), the LM uses grouped-query attention.
CKPT_VISION = VisionConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                           num_attention_heads=4, image_size=56, patch_size=14)
CKPT_LM = LlamaConfig(vocab_size=512, hidden_size=64, intermediate_size=128,
                      num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2)
CKPT_MAX_LENGTH = 2048


def checkpoint_config() -> ModelConfig:
    return ModelConfig(vision=CKPT_VISION, lm=CKPT_LM, max_length=CKPT_MAX_LENGTH,
                       bridge=BridgeConfig.from_projector_type("rmt_r_transformer1x",
                                                              hidden_size=32),
                       dtype="float32")


def write_reference_checkpoint(root: str, seed: int = 0):
    """Seeded reference-format checkpoint: (model_dir, tower_dir)."""
    from videollamb_tpu.models.bridge.convert import export_rmt_r_state_dict
    from videollamb_tpu.models.lm.convert import export_llama_state_dict

    cfg = checkpoint_config()
    tree = jax_params(cfg, seed)
    model_dir = os.path.join(root, "checkpoint")
    tower_dir = os.path.join(root, "LanguageBind_Video_merge")
    os.makedirs(model_dir, exist_ok=True)
    os.makedirs(tower_dir, exist_ok=True)
    sd = export_llama_state_dict(tree["lm"])
    sd.update(export_rmt_r_state_dict(tree["mm_projector"], prefix="model.mm_projector."))
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
               os.path.join(model_dir, "pytorch_model.bin"))
    lm = cfg.lm
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump({
            "vocab_size": lm.vocab_size, "hidden_size": lm.hidden_size,
            "intermediate_size": lm.intermediate_size,
            "num_hidden_layers": lm.num_hidden_layers,
            "num_attention_heads": lm.num_attention_heads,
            "num_key_value_heads": lm.num_key_value_heads,
            "mm_projector_type": "rmt_r_transformer1x",
            "mm_hidden_size": cfg.vision.hidden_size, "mm_video_tower": tower_dir,
            "mm_vision_select_layer": -2, "num_frames": 8,
            "tokenizer_model_max_length": CKPT_MAX_LENGTH,
        }, f)
    tower_sd = export_vision_state_dict(tree["video_tower"])
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in tower_sd.items()},
               os.path.join(tower_dir, "pytorch_model.bin"))
    v = cfg.vision
    with open(os.path.join(tower_dir, "config.json"), "w") as f:
        json.dump({"vision_config": {
            "hidden_size": v.hidden_size, "intermediate_size": v.intermediate_size,
            "num_hidden_layers": v.num_hidden_layers,
            "num_attention_heads": v.num_attention_heads, "image_size": v.image_size,
            "patch_size": v.patch_size, "num_frames": v.num_frames,
            "add_time_attn": True, "hidden_act": "quick_gelu"}}, f)
    return model_dir, tower_dir


def write_image_tower(root: str, seed: int) -> str:
    """A reference-format LanguageBind image tower dir (no temporal layers)."""
    from videollamb_tpu.models.vision.clip_vit import init_vision_params

    vision = dataclasses.replace(checkpoint_config().vision, add_time_attn=False)
    tree = np_tree(init_vision_params(jax.random.PRNGKey(seed), vision))
    path = os.path.join(root, "LanguageBind_Image")
    os.makedirs(path, exist_ok=True)
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in export_vision_state_dict(tree).items()},
               os.path.join(path, "pytorch_model.bin"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"vision_config": {
            "hidden_size": vision.hidden_size, "intermediate_size": vision.intermediate_size,
            "num_hidden_layers": vision.num_hidden_layers,
            "num_attention_heads": vision.num_attention_heads,
            "image_size": vision.image_size, "patch_size": vision.patch_size,
            "hidden_act": "quick_gelu"}}, f)
    return path


def load_both(model_dir: str, tower_dir: str):
    """(JAX params, JAX cfg, port model, port cfg) of one checkpoint, f32 on the
    CPU. The configs say float32 too: the JAX engines take their cache and
    compute dtype from ``cfg.dtype`` (config.json does not set it), the
    port's from the weights."""
    from videollamb_tpu.models.builder import load_pretrained_model as jax_load
    from videollamb_torch.models.builder import load_pretrained_model

    _, params, jcfg, _, _ = jax_load(model_dir, video_tower_path=tower_dir, dtype="float32",
                                     load_tokenizer=False)
    _, model, cfg, _, _ = load_pretrained_model(model_dir, video_tower_path=tower_dir,
                                                dtype="float32", load_tokenizer=False,
                                                device="cpu")
    return (params, dataclasses.replace(jcfg, dtype="float32"), model,
            dataclasses.replace(cfg, dtype="float32"))


def video_rows(cfg, seeds, text_len: int = 8, frames: int = 16, video_seed: int = 100):
    """(ids, mask, videos) numpy rows of B=1 video requests: text ids from
    each seed with the VIDEO sentinel at 2, one shared clip (so every
    request has the same spliced length)."""
    from videollamb_tpu.constants import VIDEO_TOKEN_INDEX

    img = cfg.vision.image_size
    video = np.random.default_rng(video_seed).normal(
        size=(1, frames, 3, img, img)).astype(np.float32)
    rows = []
    for seed in seeds:
        ids = np.random.default_rng(seed).integers(
            4, cfg.lm.vocab_size, size=(1, text_len)).astype(np.int32)
        ids[:, 2] = VIDEO_TOKEN_INDEX
        rows.append((ids, np.ones((1, text_len), np.int32), video))
    return rows


def jax_requests(rows, max_new: int):
    import jax.numpy as jnp

    from videollamb_tpu.models.assembly import MultimodalBatch
    from videollamb_tpu.serve.server import Request

    return [Request(uid=i, batch=MultimodalBatch(jnp.asarray(ids), jnp.asarray(mask), None,
                                                 jnp.asarray(video), None),
                    max_new_tokens=max_new, temperature=0.0)
            for i, (ids, mask, video) in enumerate(rows)]


def port_requests(rows, max_new: int):
    from videollamb_torch.models.assembly import MultimodalBatch
    from videollamb_torch.serve.server import Request

    return [Request(uid=i, batch=MultimodalBatch(torch.from_numpy(ids).long(),
                                                 torch.from_numpy(mask).long(),
                                                 videos=torch.from_numpy(video)),
                    max_new_tokens=max_new, temperature=0.0)
            for i, (ids, mask, video) in enumerate(rows)]


def tiny_models(max_length: int = 64, seed: int = 0):
    """(JAX cfg, JAX params, port model, port cfg) of ``ModelConfig.tiny`` in
    f32 from one seeded parameter tree: enough for text-only requests."""
    cfg = ModelConfig.tiny(max_length=max_length)
    tree = jax_params(cfg, seed)
    return cfg, tree, port_model(cfg, tree), port_config(cfg)


def text_requests(vocab_size: int, seeds, budget: int, prompt_len: int = 6, **fields):
    """(JAX requests, port requests) of text-only prompts: the same seeded ids
    and request fields on both sides. A callable field value is called with
    the side ("jax" or "torch") for objects each package builds itself
    (grammar cursors)."""
    import jax.numpy as jnp

    from videollamb_torch.models.assembly import MultimodalBatch as PortBatch
    from videollamb_torch.serve.server import Request as PortRequest
    from videollamb_tpu.models.assembly import MultimodalBatch
    from videollamb_tpu.serve.server import Request

    out = {"jax": [], "torch": []}
    for uid, seed in enumerate(seeds):
        ids = np.random.default_rng(seed).integers(4, vocab_size, size=(1, prompt_len))
        mask = np.ones((1, prompt_len), np.int64)
        for side in out:
            kw = {k: (v(side) if callable(v) else v) for k, v in fields.items()}
            if side == "jax":
                batch = MultimodalBatch(jnp.asarray(ids, jnp.int32), jnp.asarray(mask, jnp.int32),
                                        None, None, None)
                out[side].append(Request(uid=uid, batch=batch, max_new_tokens=budget, **kw))
            else:
                batch = PortBatch(torch.from_numpy(ids), torch.from_numpy(mask))
                out[side].append(PortRequest(uid=uid, batch=batch, max_new_tokens=budget, **kw))
    return out["jax"], out["torch"]


def serve(engine, requests, k: int):
    for r in requests:
        engine.submit(r)
    done = engine.run_until_drained(k=k)
    assert sorted(r.uid for r in done) == sorted(r.uid for r in requests)
    return [r.tokens for r in requests]


def tiny_tokenizer(directory: str):
    """The tiny BPE tokenizer of scripts/parity_rehearsal.py (HF fast format)."""
    import importlib.util

    pytest.importorskip("transformers")
    spec = importlib.util.spec_from_file_location(
        "parity_rehearsal", os.path.join(REPO, "scripts", "parity_rehearsal.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.build_tokenizer(directory)


def test_tower_export_inverts_convert():
    from videollamb_tpu.models.vision.convert import convert_vision_state_dict

    tree = jax_params(ModelConfig.tiny())["video_tower"]
    back = convert_vision_state_dict(export_vision_state_dict(tree))
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), leaf)


@pytest.mark.parametrize("cfg", [ModelConfig.tiny(), checkpoint_config(), ModelConfig()],
                         ids=["tiny", "checkpoint", "7b"])
def test_port_config_has_the_jax_fields(cfg):
    from videollamb_torch import config as pc

    port = port_config(cfg)
    assert type(port) is pc.ModelConfig and type(port.lm) is pc.LlamaConfig
    assert dataclasses.asdict(port) == dataclasses.asdict(cfg)
    assert port.lm.head_dim == cfg.lm.head_dim
    assert port.bridge.tokens_per_frame == cfg.bridge.tokens_per_frame


@pytest.mark.parametrize("cfg", [ModelConfig.tiny(), checkpoint_config()],
                         ids=["tiny", "checkpoint"])
def test_from_jax_params_fills_every_parameter(cfg):
    """from_jax_params names exactly the port's parameters, with their shapes."""
    from videollamb_torch.models.convert import from_jax_params

    tree = jax_params(cfg)
    state = from_jax_params(tree)
    model = port_model(cfg, tree)
    want = model.state_dict()
    assert set(state) == set(want)
    for k, v in state.items():
        assert v.shape == want[k].shape, k


# Projector kinds (tests/test_torch_projector*.py): ModelConfig.tiny with the
# bridge of one kind, a 1-layer, 8-query Q-Former and dropout off.
PROJECTOR_KINDS = ["identity", "linear", "mlp", "transformer", "mlp_transformer",
                   "rmt_transformer", "rmt_r_transformer", "rmt_r_transformer_cap", "qformer",
                   "spatial_pool", "retention"]
# The kinds whose tokens feed the LM (the JAX package's
# test_assembly_all_projectors list).
LM_PROJECTOR_KINDS = ["linear", "mlp", "transformer", "mlp_transformer", "rmt_transformer",
                      "rmt_r_transformer", "qformer", "retention"]


def projector_config(kind: str) -> ModelConfig:
    base = ModelConfig.tiny(max_length=128)
    return dataclasses.replace(base, bridge=dataclasses.replace(
        base.bridge, kind=kind, qformer_layers=1, qformer_queries=8,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0))


def projector_tree(cfg: ModelConfig, seed: int = 0) -> dict:
    """The JAX package's seeded ``init_bridge_params`` tree (numpy leaves)."""
    from videollamb_tpu.models.bridge.builder import init_bridge_params

    return np_tree(init_bridge_params(jax.random.PRNGKey(seed), cfg.bridge, cfg.lm.hidden_size))


def port_projector(cfg: ModelConfig, tree: dict):
    """The port's projector module of ``cfg.bridge.kind`` holding ``tree``."""
    from videollamb_torch.models.bridge.builder import bridge_module
    from videollamb_torch.models.convert import from_jax_params

    module = bridge_module(port_config(cfg).bridge, cfg.lm.hidden_size)
    state = from_jax_params({"mm_projector": tree})
    module.load_state_dict({k[len("mm_projector."):]: v for k, v in state.items()}, strict=True)
    return module


def projector_models(kind: str, seed: int = 0):
    """(cfg, JAX params, port model) of the whole tiny model with a ``kind``
    projector, f32 on the CPU."""
    from videollamb_tpu.models.lm.llama import init_llama_params
    from videollamb_tpu.models.vision.clip_vit import init_vision_params
    from videollamb_torch.models.assembly import VideoLLaMB
    from videollamb_torch.models.bridge.builder import bridge_module
    from videollamb_torch.models.convert import from_jax_params
    from videollamb_torch.models.lm.llama import LlamaForCausalLM
    from videollamb_torch.models.vision.clip_vit import CLIPVisionTower

    cfg = projector_config(kind)
    k1, _, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    tree = np_tree({"video_tower": init_vision_params(k1, cfg.vision),
                    "mm_projector": projector_tree(cfg, seed + 1),
                    "lm": init_llama_params(k3, cfg.lm)})
    pcfg = port_config(cfg)
    model = VideoLLaMB(CLIPVisionTower(pcfg.vision),
                       bridge_module(pcfg.bridge, cfg.lm.hidden_size), LlamaForCausalLM(pcfg.lm))
    model.load_state_dict(from_jax_params(tree), strict=True)
    return cfg, jax.tree.map(np.asarray, tree), model.eval()


def video_batch(cfg, seed=0, b=2, t=20, frames=8, labels=True):
    """(jax batch, port batch) of ``b`` right-padded video rows with labels."""
    import jax.numpy as jnp

    from videollamb_torch.models.assembly import MultimodalBatch as PortBatch
    from videollamb_tpu.constants import IGNORE_INDEX, VIDEO_TOKEN_INDEX
    from videollamb_tpu.models.assembly import MultimodalBatch

    rng = np.random.default_rng(seed)
    ids = rng.integers(4, cfg.lm.vocab_size, size=(b, t)).astype(np.int32)
    ids[:, 2] = VIDEO_TOKEN_INDEX
    mask = (np.arange(t)[None] < np.array([[t], [t - 6]])[:b]).astype(np.int32)
    lab = np.where(mask > 0, ids, IGNORE_INDEX).astype(np.int32)
    lab[:, :4] = IGNORE_INDEX
    img = cfg.vision.image_size
    videos = rng.normal(size=(b, frames, 3, img, img)).astype(np.float32)
    jb = MultimodalBatch(jnp.asarray(ids), jnp.asarray(mask),
                         jnp.asarray(lab) if labels else None, jnp.asarray(videos), None)
    pb = PortBatch(torch.from_numpy(ids).long(), torch.from_numpy(mask).long(),
                   torch.from_numpy(lab).long() if labels else None, torch.from_numpy(videos))
    return jb, pb


def base_lm_checkpoint(root: str, seed: int = 1):
    """The seeded tiny checkpoint without its projector weights and without a
    projector type in config.json: a base LM, stage 1's start."""
    model_dir, tower_dir = write_reference_checkpoint(root, seed=seed)
    path = os.path.join(model_dir, "pytorch_model.bin")
    sd = torch.load(path, weights_only=True)
    torch.save({k: v for k, v in sd.items() if "mm_projector" not in k}, path)
    with open(os.path.join(model_dir, "config.json")) as f:
        raw = json.load(f)
    raw.pop("mm_projector_type")
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(raw, f)
    return model_dir, tower_dir
