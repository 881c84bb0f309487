"""The research towers of the port (``models/vision/builder.py`` and the
towers behind ``cfg.tower``) against the JAX package, on the CPU in f32 at
tiny widths, from the same seeded JAX trees carried across by
``models/convert.research_tower_from_jax``:

- ``resolve_tower``: equal kinds, frame-wise flags and configs for the JAX
  tests' names;
- ``tower_encode`` for every kind: features within ENCODE_TOL of the JAX
  package's, relative to their largest magnitude;
- each kind through ``videollamb_forward`` with an ``mlp2x_gelu`` projector
  of the tower's width: logits within LOGITS_TOL; greedy ``generate``
  tokens equal for ``vit``, ``rmt_languagebind_video`` and ``deformable``;
- DeformCLIP's gradients (pixels and every weight) against ``jax.vjp``;
- ``research_tower_to_jax`` inverts ``research_tower_from_jax``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from test_torch_parity_utils import drawn_tree, np_tree, port_config  # noqa: E402

from videollamb_tpu.config import BridgeConfig, ModelConfig  # noqa: E402
from videollamb_tpu.models.vision import builder as jbuilder  # noqa: E402
from videollamb_torch.models.vision import builder as pbuilder  # noqa: E402

# f32 on both sides; the sums run in other orders than XLA's.
ENCODE_TOL = 1e-5
LOGITS_TOL = dict(rtol=1e-5, atol=1e-5)
KINDS = ["vit", "vitmae", "vivit", "videomae", "rmt_languagebind_video", "clip",
         "deform_clip", "deformable", "egovlp"]
# Frames each kind's tests feed (the tubelet models' learned positions fix 8,
# EgoVLP's temporal table 4).
FRAMES = {"vivit": 8, "videomae": 8, "egovlp": 4}
NAMES = ["google/vit-base-patch16-224", "facebook/vit-mae-base",
         "google/vivit-b-16x2-kinetics400", "MCG-NJU/videomae-base", "rmt_vivit",
         "rmt_clip", "LanguageBind/RMTLanguageBind_Video", "LanguageBind/LanguageBind_Video",
         "LanguageBind/LanguageBind_Image", "LanguageBind/LanguageBind_Audio",
         "LanguageBind/LanguageBind_Depth", "LanguageBind/LanguageBind_Thermal",
         "openai/clip-vit-large-patch14-336", "deform_clip-vit-large", "EgoVLP",
         "deformable-detr"]


def _configs(kind: str):
    """(JAX config, port config, image size) of ``kind`` at tiny width."""
    from videollamb_torch import config as pc
    from videollamb_torch.models.vision import deform_clip, deformable, egovlp, vit
    from videollamb_tpu import config as jc
    from videollamb_tpu.models.vision import deform_clip as jdc
    from videollamb_tpu.models.vision import deformable as jdf
    from videollamb_tpu.models.vision import egovlp as jeg
    from videollamb_tpu.models.vision import vit as jvit

    tiny_vit = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                    intermediate_size=64, image_size=32, patch_size=16)
    if kind in ("vit", "vitmae"):
        kw = tiny_vit
    elif kind == "vivit":
        kw = dict(tiny_vit, tubelet_t=2, num_frames=8, layer_norm_eps=1e-6)
    elif kind == "videomae":
        kw = dict(tiny_vit, tubelet_t=2, num_frames=8, use_cls_token=False, pos_embed="sincos",
                  qkv_bias="qv_only")
    if kind in ("vit", "vitmae", "vivit", "videomae"):
        return jvit.ViTFamilyConfig(**kw), vit.ViTFamilyConfig(**kw), 32
    if kind in ("rmt_languagebind_video", "clip"):
        kw = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                  num_attention_heads=4, image_size=28, patch_size=14, add_time_attn=False)
        return jc.VisionConfig(**kw), pc.VisionConfig(**kw), 28
    if kind == "deform_clip":
        return jdc.DeformCLIPConfig.tiny(), deform_clip.DeformCLIPConfig.tiny(), 28
    if kind == "deformable":
        # 128 pixels and 64 channels: each GroupNorm(32) group normalises 2
        # channels over at least a 2 x 2 map (over one value it is
        # degenerate, its output the bias).
        kw = dict(d_model=64, encoder_layers=1, encoder_attention_heads=4, encoder_ffn_dim=64,
                  num_feature_levels=3, encoder_n_points=2, backbone_embed_channels=8,
                  backbone_depths=(1, 1, 1, 1), backbone_channels=(16, 32, 64, 128),
                  backbone_out=(2, 3))
        return jdf.DeformableConfig(**kw), deformable.DeformableConfig(**kw), 128
    kw = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4, image_size=32,
              patch_size=16, num_frames=4, mlp_ratio=2.0)
    return jeg.EgoVLPConfig(**kw), egovlp.EgoVLPConfig(**kw), 32


def _specs(kind: str):
    jcfg, pcfg, size = _configs(kind)
    frame_wise = kind in ("vit", "vitmae", "clip", "deform_clip", "deformable")
    return (jbuilder.TowerSpec(kind, jcfg, frame_wise),
            pbuilder.TowerSpec(kind, pcfg, frame_wise), size)


@functools.lru_cache(maxsize=None)
def _jax_tree(spec, seed: int = 0) -> dict:
    """The seeded JAX tree of a tower (numpy leaves; shared, not to be mutated)."""
    from videollamb_tpu.models.vision import deform_clip, deformable, egovlp, vit
    from videollamb_tpu.models.vision.clip_vit import init_vision_params
    from videollamb_tpu.models.vision.rmt_clip_vit import init_rmt_vision_params

    init = {"rmt_languagebind_video": lambda k, c: init_rmt_vision_params(
                k, c, num_memory_tokens=8),
            "clip": init_vision_params, "deform_clip": deform_clip.init_deform_clip_params,
            "deformable": deformable.init_deformable_params,
            "egovlp": egovlp.init_egovlp_params}.get(spec.kind, vit.init_vit_params)
    # Every leaf drawn: some initialisers zero the deformable offset kernels
    # and EgoVLP's time attention, which would hide those paths.
    return drawn_tree(lambda k: init(k, spec.config), seed)


def _port_tower(spec, tree):
    from videollamb_torch.models.convert import research_tower_from_jax

    tower = pbuilder.init_tower(spec)
    if spec.kind == "rmt_languagebind_video":
        from videollamb_torch.models.vision.rmt_clip_vit import RMTCLIPVisionTower

        tower = RMTCLIPVisionTower(spec.config, num_memory_tokens=8)
    tower.load_state_dict(research_tower_from_jax(spec.kind, tree), strict=True)
    return tower.eval()


def _pixels(kind: str, size: int, b: int = 2, seed: int = 0) -> np.ndarray:
    t = FRAMES.get(kind, 2)
    return np.random.default_rng(seed).normal(size=(b, t, 3, size, size)).astype(np.float32)


@pytest.mark.parametrize("name", NAMES)
def test_resolve_tower_equal_jax(name):
    want, got = jbuilder.resolve_tower(name), pbuilder.resolve_tower(name)
    assert (got.kind, got.frame_wise) == (want.kind, want.frame_wise)
    assert type(got.config).__name__ == type(want.config).__name__
    assert dataclasses.asdict(got.config) == dataclasses.asdict(want.config)


@pytest.mark.parametrize("kind", KINDS)
def test_tower_encode_equal_jax(kind):
    jspec, pspec, size = _specs(kind)
    tree = _jax_tree(jspec)
    pixels = _pixels(kind, size)
    # Under jit: the deformable tower op by op pays a compile per op.
    encode = jax.jit(lambda p, x: jbuilder.tower_encode(jspec, p, x))
    want = np.asarray(encode(jax.tree.map(jnp.asarray, tree), jnp.asarray(pixels)))
    with torch.no_grad():
        got = pbuilder.tower_encode(pspec, _port_tower(pspec, tree),
                                    torch.from_numpy(pixels)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= ENCODE_TOL * np.abs(want).max()


def test_research_tower_state_round_trips():
    from videollamb_torch.models.convert import research_tower_from_jax, research_tower_to_jax

    for kind in KINDS:
        jspec, _, _ = _specs(kind)
        tree = _jax_tree(jspec)
        back = research_tower_to_jax(kind, research_tower_from_jax(kind, tree))
        leaves = jax.tree_util.tree_leaves_with_path(tree)
        got = dict(jax.tree_util.tree_leaves_with_path(back))
        assert len(got) == len(leaves), kind
        for path, leaf in leaves:
            np.testing.assert_array_equal(got[path], leaf, err_msg=f"{kind} {path}")


def _models(kind: str):
    """(JAX cfg, JAX params, port cfg, port model, image size): the tiny LM
    with an mlp2x_gelu projector of the tower's width."""
    from videollamb_torch.models.assembly import VideoLLaMB
    from videollamb_torch.models.bridge.builder import bridge_module
    from videollamb_torch.models.convert import from_jax_params
    from videollamb_torch.models.lm.llama import LlamaForCausalLM
    from videollamb_tpu.models.bridge.builder import init_bridge_params
    from videollamb_tpu.models.lm.llama import init_llama_params

    jspec, pspec, size = _specs(kind)
    width = getattr(jspec.config, "hidden_size", None) or jspec.config.d_model
    base = ModelConfig.tiny(max_length=128)
    base = dataclasses.replace(base, bridge=BridgeConfig(kind="mlp", mlp_depth=2,
                                                         hidden_size=width))
    tree = {"video_tower": _jax_tree(jspec), **drawn_tree(lambda k: {
        "mm_projector": init_bridge_params(k, base.bridge, base.lm.hidden_size),
        "lm": init_llama_params(k, base.lm)}, 1)}
    pcfg = dataclasses.replace(port_config(base), tower=pspec)
    model = VideoLLaMB(_port_tower(pspec, tree["video_tower"]),
                       bridge_module(pcfg.bridge, base.lm.hidden_size), LlamaForCausalLM(pcfg.lm))
    model.load_state_dict(from_jax_params(tree, tower=kind), strict=True)
    jcfg = dataclasses.replace(base, tower=jspec)
    return jcfg, jax.tree.map(jnp.asarray, tree), pcfg, model.eval(), size


def _batches(cfg, kind, size, seed=0, b=2, t=12):
    from videollamb_torch.models.assembly import MultimodalBatch as PortBatch
    from videollamb_tpu.constants import VIDEO_TOKEN_INDEX
    from videollamb_tpu.models.assembly import MultimodalBatch

    rng = np.random.default_rng(seed)
    ids = rng.integers(4, cfg.lm.vocab_size, size=(b, t)).astype(np.int32)
    ids[:, 2] = VIDEO_TOKEN_INDEX
    mask = (np.arange(t)[None] < np.array([[t], [t - 3]])[:b]).astype(np.int32)
    videos = _pixels(kind, size, b, seed + 1)
    return (MultimodalBatch(jnp.asarray(ids), jnp.asarray(mask), None, jnp.asarray(videos), None),
            PortBatch(torch.from_numpy(ids).long(), torch.from_numpy(mask).long(),
                      videos=torch.from_numpy(videos)))


@pytest.mark.parametrize("kind", KINDS)
def test_tower_forward_logits_equal_jax(kind):
    from videollamb_torch.models.assembly import videollamb_forward
    from videollamb_tpu.models.assembly import videollamb_forward as jax_forward

    jcfg, params, pcfg, model, size = _models(kind)
    jb, pb = _batches(jcfg, kind, size)
    want, jspliced = jax.jit(lambda p, b: jax_forward(p, jcfg, b))(params, jb)
    with torch.no_grad():
        got, spliced = videollamb_forward(model, pcfg, pb)
    np.testing.assert_array_equal(spliced.attention_mask.numpy(),
                                  np.asarray(jspliced.attention_mask))
    valid = spliced.attention_mask.numpy().astype(bool)
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid], **LOGITS_TOL)


@pytest.mark.parametrize("kind", ["vit", "rmt_languagebind_video", "deformable"])
def test_tower_greedy_tokens_equal_jax(kind):
    from videollamb_torch.models.engine import generate
    from videollamb_tpu.models.engine import generate as jax_generate

    jcfg, params, pcfg, model, size = _models(kind)
    jb, pb = _batches(jcfg, kind, size, seed=5, b=1)
    max_seq = jcfg.max_length + 16
    ref = jax_generate(params, jcfg, jb, jax.random.PRNGKey(0), max_new_tokens=8,
                       do_sample=False, max_seq_len=max_seq)
    out = generate(model, pcfg, pb, max_new_tokens=8, do_sample=False, max_seq_len=max_seq)
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))


def test_deform_clip_gradients_equal_jax():
    from videollamb_torch.models.convert import research_tower_to_jax
    from videollamb_torch.models.vision.deform_clip import deform_clip_encode
    from videollamb_tpu.models.vision.deform_clip import deform_clip_encode as jax_encode

    jspec, pspec, size = _specs("deform_clip")
    tree = _jax_tree(jspec)
    pixels = _pixels("deform_clip", size)[:, 0]
    params = jax.tree.map(jnp.asarray, tree)
    out, vjp = jax.vjp(lambda p, x: jax_encode(p, x, jspec.config), params, jnp.asarray(pixels))
    cot = np.random.default_rng(9).normal(size=out.shape).astype(np.float32)
    want_params, want_pixels = vjp(jnp.asarray(cot))

    tower = _port_tower(pspec, tree)
    x = torch.from_numpy(pixels).requires_grad_(True)
    got = deform_clip_encode(tower, x, pspec.config)
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), rtol=1e-5, atol=1e-5)

    def close(a, b, what):
        b = np.asarray(b)
        assert np.abs(a - b).max() <= 1e-5 * max(np.abs(b).max(), 1e-6), what

    close(x.grad.numpy(), want_pixels, "pixels")
    grads = research_tower_to_jax("deform_clip", {
        k: (p.grad if p.grad is not None else torch.zeros_like(p))
        for k, p in tower.named_parameters()})
    for path, leaf in jax.tree_util.tree_leaves_with_path(want_params):
        node = grads
        for k in path:
            node = node[getattr(k, "key", getattr(k, "idx", None))]
        close(node, leaf, jax.tree_util.keystr(path))


@pytest.mark.parametrize("kind", KINDS)
def test_tower_block_tokens_equal_jax(kind):
    """The packing budget of a research tower's block (``measure_block_tokens``,
    from the shapes alone) against JAX's, which traces the encoder."""
    from videollamb_torch.models.assembly import measure_block_tokens
    from videollamb_tpu.models.assembly import measure_block_tokens as jax_measure

    jspec, pspec, size = _specs(kind)
    base = ModelConfig.tiny()
    width = getattr(jspec.config, "hidden_size", None) or jspec.config.d_model
    jcfg = dataclasses.replace(base, vision=dataclasses.replace(base.vision, image_size=size),
                               bridge=BridgeConfig(kind="mlp", mlp_depth=2, hidden_size=width),
                               num_frames=FRAMES.get(kind, 2))
    pcfg = dataclasses.replace(port_config(jcfg), tower=pspec)
    from videollamb_tpu.models.bridge.builder import init_bridge_params

    params = {"video_tower": _jax_tree(jspec), "mm_projector": jax.eval_shape(
        lambda k: init_bridge_params(k, jcfg.bridge, jcfg.lm.hidden_size),
        jax.random.PRNGKey(0))}
    modalities = ["video"] + (["image"] if jspec.frame_wise or kind == "egovlp" else [])
    for modality in modalities:
        want = jax_measure(params, dataclasses.replace(jcfg, tower=jspec), modality)
        assert measure_block_tokens(pcfg, modality) == want, modality


def _hf_state(shapes, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.normal(size=v).astype(np.float32)) for k, v in shapes.items()}


@pytest.mark.parametrize("kind", ["vit", "vitmae", "vivit", "videomae"])
def test_convert_vit_state_dict_equal_jax(kind):
    """A seeded state dict under HF's ViT / ViTMAE / Vivit / VideoMAE names
    (with VideoMAE's q / v biases and a final layernorm) through the port's
    converter gives the JAX converter's leaves."""
    from videollamb_torch.models.convert import research_tower_from_jax
    from videollamb_torch.models.vision.vit import ViTTower, convert_vit_state_dict
    from videollamb_tpu.models.vision.vit import convert_vit_state_dict as jax_convert

    jspec, pspec, _ = _specs(kind)
    c = pspec.config
    d, p, n = c.hidden_size, c.patch_size, c.tokens_per_frame_group
    conv = (d, 3, c.tubelet_t, p, p) if c.tubelet_t > 1 else (d, 3, p, p)
    shapes = {"embeddings.patch_embeddings.projection.weight": conv,
              "embeddings.patch_embeddings.projection.bias": (d,),
              "layernorm.weight": (d,), "layernorm.bias": (d,)}
    if c.use_cls_token:
        shapes["embeddings.cls_token"] = (1, 1, d)
    if c.pos_embed == "learned":
        shapes["embeddings.position_embeddings"] = (
            1, max(c.num_frames // c.tubelet_t, 1) * n + int(c.use_cls_token), d)
    for i in range(c.num_hidden_layers):
        pre = f"encoder.layer.{i}."
        for name, (o, k) in {"attention.attention.query": (d, d),
                             "attention.attention.key": (d, d),
                             "attention.attention.value": (d, d),
                             "attention.output.dense": (d, d),
                             "intermediate.dense": (c.intermediate_size, d),
                             "output.dense": (d, c.intermediate_size),
                             "layernorm_before": (d, None), "layernorm_after": (d, None)}.items():
            shapes[f"{pre}{name}.weight"] = (o,) if k is None else (o, k)
            if not (c.qkv_bias == "qv_only" and "attention.attention" in name):
                shapes[f"{pre}{name}.bias"] = (o,)
        if c.qkv_bias == "qv_only":
            shapes[f"{pre}attention.attention.q_bias"] = (d,)
            shapes[f"{pre}attention.attention.v_bias"] = (d,)
    sd = _hf_state(shapes, 5)
    state = convert_vit_state_dict(sd, c)
    want = research_tower_from_jax(kind, jax_convert(sd, jspec.config))
    assert sorted(state) == sorted(want)
    for k, v in state.items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0, msg=k)
    ViTTower(c, final_layernorm=True).load_state_dict(state, strict=True)


def test_convert_egovlp_state_dict_equal_jax():
    """A reference-named SpaceTimeTransformer state dict (seeded) through the
    port's converter gives the JAX converter's leaves."""
    from videollamb_torch.models.convert import research_tower_from_jax
    from videollamb_torch.models.vision.egovlp import convert_egovlp_state_dict
    from videollamb_tpu.models.vision.egovlp import convert_egovlp_state_dict as jax_convert

    jspec, pspec, _ = _specs("egovlp")
    c = pspec.config
    d, inter, ps = c.hidden_size, int(c.hidden_size * c.mlp_ratio), c.patch_size
    shapes = {"patch_embed.proj.weight": (d, 3, ps, ps), "patch_embed.proj.bias": (d,),
              "cls_token": (1, 1, d), "pos_embed": (1, c.patches_per_frame + 1, d),
              "temporal_embed": (1, c.num_frames, d), "norm.weight": (d,), "norm.bias": (d,)}
    for i in range(c.num_hidden_layers):
        for name, (o, n) in {"norm1": (d, None), "norm2": (d, None), "norm3": (d, None),
                             "attn.qkv": (3 * d, d), "attn.proj": (d, d),
                             "timeattn.qkv": (3 * d, d), "timeattn.proj": (d, d),
                             "mlp.fc1": (inter, d), "mlp.fc2": (d, inter)}.items():
            shapes[f"blocks.{i}.{name}.weight"] = (o,) if n is None else (o, n)
            shapes[f"blocks.{i}.{name}.bias"] = (o,)
    sd = _hf_state(shapes, 4)
    state = convert_egovlp_state_dict(sd, c)
    want = research_tower_from_jax("egovlp", jax_convert(sd, jspec.config))
    assert sorted(state) == sorted(want)
    for k, v in state.items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0, msg=k)


def test_build_image_tower_loads_a_tower_dir_state(monkeypatch):
    """A LanguageBind tower dir's state dict loads by name, as JAX's loader
    converts it; without one the tower is seeded (tiny dims)."""
    from test_torch_parity_utils import export_vision_state_dict

    from videollamb_tpu.models.vision.clip_vit import init_vision_params

    jspec, pspec, _ = _specs("clip")
    spec = dataclasses.replace(pspec, kind="languagebind_image")
    monkeypatch.setattr(pbuilder, "resolve_tower", lambda name: spec)
    assert pbuilder.build_image_tower("LanguageBind/LanguageBind_Image")[0] == spec
    tree = np_tree(jax.jit(init_vision_params, static_argnums=1)(jax.random.PRNGKey(3),
                                                                 jspec.config))
    sd = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in export_vision_state_dict(tree).items()}
    _, loaded = pbuilder.build_image_tower("LanguageBind/LanguageBind_Image", state_dict=sd)
    for k, v in loaded.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0, msg=k)
