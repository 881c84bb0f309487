"""EgoVLP's text side in the port (``models/vision/egovlp_text.py`` and the
tower's ``_i2t_cross``) against the JAX package, on the CPU in f32 at tiny
widths, from one JAX tree carried across by ``convert.egovlp_text_from_jax``.
Its leaves are drawn from numpy at the JAX initialisers' scale (0.02-std
kernels, tables and biases, unit-scale norms; ``jax.eval_shape`` gives the
shapes, so no initialiser runs), every gate alpha_t2i / alpha_i2t in
[0.5, 1] and the time attention's qkv (zero at initialisation) drawn too,
so that every path computes. A tree drawn at unit gain grows the tower's
activations past 100 within two blocks, where float32 rounding alone moves
the ITM logits by 1e-3.

Tolerance: outputs within 1e-5 of the JAX package's, relative to their
largest magnitude (TOL); the metrics and the converted state dicts equal.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from videollamb_torch.models import convert  # noqa: E402
from videollamb_torch.models.vision import egovlp as pe  # noqa: E402
from videollamb_torch.models.vision import egovlp_text as pt  # noqa: E402
from videollamb_tpu.models.vision import egovlp as je  # noqa: E402
from videollamb_tpu.models.vision import egovlp_text as jt  # noqa: E402

TOL = 1e-5
KW = dict(vocab_size=120, hidden_size=32, num_hidden_layers=4, num_attention_heads=4,
          max_position_embeddings=40, pad_token_id=1, num_fuse_block=2, dim_img=24,
          projection_dim=48)
VKW = dict(hidden_size=24, num_hidden_layers=4, num_attention_heads=4, image_size=32,
           patch_size=16, num_frames=2)
JT, PT = jt.RobertaTextConfig(**KW), pt.RobertaTextConfig(**KW)
JV, PV = je.EgoVLPConfig(**VKW), pe.EgoVLPConfig(**VKW)


def _close(ours, ref, tol=TOL):
    ours = ours.detach().numpy() if torch.is_tensor(ours) else np.asarray(ours)
    ref = np.asarray(ref)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=0, atol=tol * max(1.0, np.abs(ref).max()))


def _draw(init, seed):
    """The tree ``init(key)`` builds, each leaf drawn from numpy (see the
    module docstring)."""
    rng = np.random.default_rng(seed)

    def leaf(path, shape):
        name = str(getattr(path[-1], "key", ""))
        if name.startswith("alpha_"):
            return rng.uniform(0.5, 1.0, size=shape.shape).astype(np.float32)
        x = rng.normal(size=shape.shape) * 0.02
        return (x + 1.0 if name == "scale" else x).astype(np.float32)

    return jax.tree_util.tree_map_with_path(
        leaf, jax.eval_shape(init, jax.random.PRNGKey(seed)))


@pytest.fixture(scope="module")
def models():
    tree = _draw(lambda k: jt.init_egovlp_text_params(k, JT, JV), seed=0)
    tree["video"] = _draw(lambda k: jt.init_fusion_video_params(k, JV, JT), seed=1)
    state = convert.egovlp_text_from_jax(tree)
    text = pt.EgoVLPText(PT, PV)
    text.load_state_dict({k: v for k, v in state.items() if not k.startswith("video.")})
    video = pe.EgoVLPTower(PV, i2t_blocks=PT.num_fuse_block, text_hidden=PT.hidden_size)
    video.load_state_dict({k[6:]: v for k, v in state.items() if k.startswith("video.")})
    return tree, text.eval(), video.eval()


def _ids(b=2, length=9, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, JT.vocab_size, size=(b, length)).astype(np.int32)
    mask = np.ones((b, length), np.int32)
    ids[1, -3:] = JT.pad_token_id
    mask[1, -3:] = 0
    return ids, mask


def _pixels(seed=2, b=2):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(b, JV.num_frames, 3, JV.image_size, JV.image_size)).astype(
        np.float32)


def test_converted_state_fills_every_parameter_and_inverts(models):
    tree, text, video = models
    state = {**text.state_dict(), **{f"video.{k}": v for k, v in video.state_dict().items()}}
    assert set(state) == set(convert.egovlp_text_from_jax(tree))
    back = convert.egovlp_text_to_jax(state, n_fuse_video=PT.num_fuse_block)
    flat = dict(jax.tree_util.tree_leaves_with_path(tree))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert set(map(str, flat)) == set(map(str, got))
    for (path, a), (_, b) in zip(sorted(flat.items(), key=lambda kv: str(kv[0])),
                                 sorted(got.items(), key=lambda kv: str(kv[0]))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(path))


@pytest.mark.parametrize("fused", [False, True])
def test_roberta_encode_equal_jax(models, fused):
    tree, text, _ = models
    ids, mask = _ids()
    video = np.random.default_rng(5).normal(size=(2, 5, JT.dim_img)).astype(np.float32)
    ref = jt.roberta_encode(tree["text_model"], JT, jnp.asarray(ids), jnp.asarray(mask),
                            video=jnp.asarray(video) if fused else None)
    with torch.no_grad():
        ours = pt.roberta_encode(text.text_model, PT, torch.from_numpy(ids),
                                 torch.from_numpy(mask),
                                 video=torch.from_numpy(video) if fused else None)
    _close(ours, ref)


def test_unfused_config_encodes_as_jax():
    """A text model with no fusion layers (a plain RoBERTa), four layers deep."""
    cfg_kw = {**KW, "num_fuse_block": 0}
    jcfg, pcfg = jt.RobertaTextConfig(**cfg_kw), pt.RobertaTextConfig(**cfg_kw)
    tree = _draw(lambda k: jt.init_roberta_params(k, jcfg, fusion=False), seed=4)
    state = convert.egovlp_text_from_jax(
        {"text_model": tree, "mlm_head": {"decoder": {"kernel": np.zeros((1, 1))}}})
    model = pt.RobertaText(pcfg, fusion=False)
    model.load_state_dict({k[11:]: v for k, v in state.items() if k.startswith("text_model.")})
    ids, mask = _ids(seed=6)
    ref = jt.roberta_encode(tree, jcfg, jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        ours = pt.roberta_encode(model, pcfg, torch.from_numpy(ids), torch.from_numpy(mask))
    _close(ours, ref)


@pytest.mark.parametrize("mode", ["itm", "mlm"])
def test_fusion_forward_equal_jax(models, mode):
    tree, text, video = models
    ids, mask = _ids()
    pixels = _pixels()
    ref = jt.fusion_forward(tree, JV, JT, jnp.asarray(pixels), jnp.asarray(ids),
                            jnp.asarray(mask), mode=mode)
    with torch.no_grad():
        ours = pt.fusion_forward(text, video, PV, PT, torch.from_numpy(pixels),
                                 torch.from_numpy(ids), torch.from_numpy(mask), mode=mode)
    assert tuple(ours.shape) == ((2, 2) if mode == "itm" else (2, 9, JT.vocab_size))
    _close(ours, ref)


def test_i2t_cross_through_the_tower_block_equal_jax(models):
    """A fusion block's space attention with a text stream and its pad bias."""
    tree, _, video = models
    rng = np.random.default_rng(8)
    f = JV.num_frames
    n = JV.patches_per_frame
    x = rng.normal(size=(2, 1 + f * n, JV.hidden_size)).astype(np.float32)
    y = rng.normal(size=(2, 9, JT.hidden_size)).astype(np.float32)
    y_bias = np.zeros((2, 9), np.float32)
    y_bias[1, -3:] = jt.NEG_INF
    jblock = jax.tree.map(lambda a: a[0], tree["video"]["fuse_blocks"])
    block = jax.jit(je._block, static_argnames=("cfg", "f"))
    ref = block(jblock, jnp.asarray(x), cfg=JV, f=f, y=jnp.asarray(y), y_bias=jnp.asarray(y_bias))
    first_fused = JV.num_hidden_layers - JT.num_fuse_block
    with torch.no_grad():
        ours = pe._block(video.blocks[first_fused], torch.from_numpy(x), PV, f,
                         y=torch.from_numpy(y), y_bias=torch.from_numpy(y_bias))
        plain = pe._block(video.blocks[first_fused], torch.from_numpy(x), PV, f)
    _close(ours, ref)
    assert (ours - plain).abs().max() > 1e-3  # the cross-attention counted


def test_compute_text_video_embed_and_sim_matrix_equal_jax(models):
    tree, text, _ = models
    ids, mask = _ids()
    cls = np.random.default_rng(9).normal(size=(3, JV.hidden_size)).astype(np.float32)
    emb = jt.compute_text(tree, JT, jnp.asarray(ids), jnp.asarray(mask))
    toks = jt.compute_text(tree, JT, jnp.asarray(ids), jnp.asarray(mask), tokens=True)
    vid = jt.compute_video_embed(tree, jnp.asarray(cls))
    with torch.no_grad():
        p_emb = pt.compute_text(text, PT, torch.from_numpy(ids), torch.from_numpy(mask))
        p_toks = pt.compute_text(text, PT, torch.from_numpy(ids), torch.from_numpy(mask),
                                 tokens=True)
        p_vid = pt.compute_video_embed(text, torch.from_numpy(cls))
        sims = pt.sim_matrix(p_emb, p_vid)
    _close(p_emb, emb)
    _close(p_toks, toks)
    _close(p_vid, vid)
    _close(sims, jt.sim_matrix(emb, vid))


def _hf_state(cfg, fused: bool, seed: int):
    """A seeded HF RobertaModel-named state dict, with the EgoVLP fusion
    weights in the last ``num_fuse_block`` layers when ``fused``."""
    rng = np.random.default_rng(seed)
    d, inter = cfg.hidden_size, cfg.intermediate_size

    def w(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32) * 0.1)

    sd = {"text_model.embeddings.word_embeddings.weight": w(cfg.vocab_size, d),
          "text_model.embeddings.position_embeddings.weight": w(cfg.max_position_embeddings, d),
          "text_model.embeddings.token_type_embeddings.weight": w(1, d),
          "text_model.embeddings.LayerNorm.weight": 1 + w(d),
          "text_model.embeddings.LayerNorm.bias": w(d)}
    dims = {"attention.self.query": (d, d), "attention.self.key": (d, d),
            "attention.self.value": (d, d), "attention.output.dense": (d, d),
            "attention.output.LayerNorm": (d,), "intermediate.dense": (inter, d),
            "output.dense": (d, inter), "output.LayerNorm": (d,)}
    cross = {"crossattention_t2i.self.query": (d, d),
             "crossattention_t2i.self.key": (d, cfg.dim_img),
             "crossattention_t2i.self.value": (d, cfg.dim_img),
             "crossattention_t2i.output.dense": (d, d)}
    first_fused = cfg.num_hidden_layers - cfg.num_fuse_block
    for i in range(cfg.num_hidden_layers):
        names = dict(dims, **(cross if fused and i >= first_fused else {}))
        for name, shape in names.items():
            pre = f"text_model.encoder.layer.{i}.{name}"
            sd[pre + ".weight"] = w(*shape)
            sd[pre + ".bias"] = w(shape[0])
        if fused and i >= first_fused:
            sd[f"text_model.encoder.layer.{i}.alpha_t2i"] = w(1)
    return sd


@pytest.mark.parametrize("fused", [False, True])
def test_convert_roberta_state_dict_equal_jax(fused):
    sd = _hf_state(PT, fused, seed=11)
    ours = pt.convert_roberta_state_dict(sd, PT, prefix="text_model.")
    ref = jt.convert_roberta_state_dict({k: v.numpy() for k, v in sd.items()}, JT,
                                        prefix="text_model.")
    want = convert.egovlp_text_from_jax(
        {"text_model": ref, "mlm_head": {"decoder": {"kernel": np.zeros((1, 1))}}})
    want = {k[11:]: v for k, v in want.items() if k.startswith("text_model.")}
    assert set(ours) == set(want)
    for key in want:
        np.testing.assert_array_equal(ours[key].numpy(), want[key].numpy(), err_msg=key)
    model = pt.RobertaText(PT)
    model.load_state_dict(ours)  # every parameter named


def test_retrieval_metrics_equal_jax():
    rng = np.random.default_rng(12)
    sims = np.round(rng.normal(size=(12, 4)), 1)  # rounding makes ties
    for fn in ("t2v_metrics", "v2t_metrics"):
        assert getattr(pt, fn)(sims) == getattr(jt, fn)(sims)
    preds = rng.normal(size=(10, 5))
    labels = rng.integers(0, 5, size=10)
    types = rng.integers(1, 3, size=10)
    assert pt.egomcq_accuracy_metrics(preds, labels, types) == \
        jt.egomcq_accuracy_metrics(preds, labels, types)
