"""The training forward of the port against the JAX package, on the CPU in
f32 at ``ModelConfig.tiny`` size, from the same seeded parameters and
inputs: ``llama_forward`` logits with remat off and on (and their gradients
equal with and without remat), ``causal_lm_loss``, the packed splice and its
per-segment positions as exact integers, and ``videollamb_forward`` over a
packed video batch. The bridge's dropout and the tower's patch dropout are
held to their rates and scaling."""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from test_torch_parity_utils import jax_params, port_config, port_model  # noqa: E402

from videollamb_tpu.config import BridgeConfig, ModelConfig  # noqa: E402
from videollamb_tpu.constants import IGNORE_INDEX, VIDEO_TOKEN_INDEX  # noqa: E402

# No dropout on either side: the two packages draw from different generators.
CFG = ModelConfig.tiny(max_length=96, bridge=BridgeConfig(
    hidden_size=32, num_attention_heads=4, intermediate_size=64, num_memory_tokens=8,
    pool_h=2, pool_w=2, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0))
# f32 logits through two layers, summed in other orders than XLA's.
LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def models():
    tree = jax_params(CFG, seed=5)
    return jax.tree.map(jnp.asarray, tree), port_model(CFG, tree), port_config(CFG)


def _embeds(seed, b=2, s=40, lengths=(40, 29)):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, CFG.lm.hidden_size)).astype(np.float32) * 0.5
    mask = (np.arange(s)[None] < np.asarray(lengths)[:, None]).astype(np.int32)
    return x, mask


@pytest.mark.parametrize("remat", [False, True])
def test_llama_forward_matches_jax(models, remat):
    from videollamb_tpu.models.lm.llama import llama_forward as jax_forward
    from videollamb_torch.models.lm.llama import llama_forward

    params, model, cfg = models
    x, mask = _embeds(0)
    want = np.asarray(jax_forward(params["lm"], CFG.lm, jnp.asarray(x), jnp.asarray(mask),
                                  remat=remat, attn_impl="chunked"))
    with torch.no_grad():
        got = llama_forward(model.lm, cfg.lm, torch.from_numpy(x), torch.from_numpy(mask),
                            remat=remat, attn_impl="chunked")
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)


def test_remat_gives_the_same_gradients(models):
    """Checkpointed layers recompute the forward in the backward: the
    gradients equal those without remat."""
    from videollamb_torch.models.lm.llama import llama_forward

    _, model, cfg = models
    x, mask = _embeds(1)
    grads = []
    for remat in (False, True):
        xt = torch.from_numpy(x).requires_grad_(True)
        out = llama_forward(model.lm, cfg.lm, xt, torch.from_numpy(mask), remat=remat,
                            attn_impl="chunked")
        w = model.lm.model.layers[0].self_attn.q_proj.weight
        gx, gw = torch.autograd.grad((out ** 2).mean(), [xt, w])
        grads.append((gx, gw))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def test_llama_forward_with_hidden_matches_jax(models):
    from videollamb_tpu.models.lm.llama import llama_forward_with_hidden as jax_fwh
    from videollamb_torch.models.lm.llama import llama_forward_with_hidden

    params, model, cfg = models
    x, mask = _embeds(2)
    want_logits, want_hidden = jax_fwh(params["lm"], CFG.lm, jnp.asarray(x), jnp.asarray(mask),
                                       attn_impl="chunked")
    with torch.no_grad():
        logits, hidden = llama_forward_with_hidden(model.lm, cfg.lm, torch.from_numpy(x),
                                                   torch.from_numpy(mask), attn_impl="chunked")
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), **LOGIT_TOL)
    np.testing.assert_allclose(hidden.numpy(), np.asarray(want_hidden), **LOGIT_TOL)


def test_causal_lm_loss_matches_jax():
    from videollamb_tpu.models.assembly import causal_lm_loss as jax_loss
    from videollamb_torch.models.assembly import causal_lm_loss

    rng = np.random.default_rng(3)
    logits = rng.normal(size=(2, 17, 50)).astype(np.float32) * 3
    labels = rng.integers(0, 50, size=(2, 17)).astype(np.int32)
    labels[0, :6] = IGNORE_INDEX
    labels[1, 10:] = IGNORE_INDEX
    want_loss, want_n = jax_loss(jnp.asarray(logits), jnp.asarray(labels))
    loss, n = causal_lm_loss(torch.from_numpy(logits), torch.from_numpy(labels))
    assert int(n) == int(want_n)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)
    none, n0 = causal_lm_loss(torch.from_numpy(logits),
                              torch.full((2, 17), IGNORE_INDEX, dtype=torch.long))
    assert float(none) == 0.0 and int(n0) == 1


def _packed_inputs(seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, 200, size=(2, 24)).astype(np.int32)
    seg = np.zeros((2, 24), np.int32)
    seg[0, :9], seg[0, 9:20] = 1, 2
    seg[1, :7], seg[1, 7:12], seg[1, 12:22] = 1, 2, 3
    ids[0, [2, 12]] = VIDEO_TOKEN_INDEX
    ids[1, [1, 14]] = VIDEO_TOKEN_INDEX
    mask = (seg > 0).astype(np.int32)
    labels = np.where(mask > 0, ids, IGNORE_INDEX).astype(np.int32)
    labels[ids < 0] = IGNORE_INDEX
    x_mask = np.ones((2, 3, 5), bool)
    x_mask[0, 1, 3:] = False
    x_mask[:, 2] = False  # an empty slot
    x = rng.normal(size=(2, 3, 5, 8)).astype(np.float32)
    text = rng.normal(size=(2, 24, 8)).astype(np.float32)
    return ids, mask, labels, seg, text, x, x_mask


@pytest.mark.parametrize("max_len", [48, 26])
def test_packed_splice_equals_jax(max_len):
    """Embeddings, labels, lengths, segment ids and positions of the packed
    splice, exactly; 26 truncates the second row's last segment."""
    from videollamb_tpu.models.splice import splice_multimodal_packed as jax_splice
    from videollamb_torch.models.splice import splice_multimodal_packed

    ids, mask, labels, seg, text, x, x_mask = _packed_inputs(0)
    want, want_seg, want_pos = jax_splice(*(jnp.asarray(a) for a in
                                            (ids, mask, labels, seg, text, x, x_mask)), max_len)
    got, got_seg, got_pos = splice_multimodal_packed(
        *(torch.from_numpy(a) for a in (ids, mask, labels, seg, text, x, x_mask)), max_len)
    np.testing.assert_array_equal(got.embeds.numpy(), np.asarray(want.embeds))
    np.testing.assert_array_equal(got.attention_mask.numpy(), np.asarray(want.attention_mask))
    for a, b in ((got.labels, want.labels), (got.lengths, want.lengths),
                 (got_seg, want_seg), (got_pos, want_pos)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b).astype(np.int64))


def test_packed_position_ids_equal_jax():
    from videollamb_tpu.models.splice import packed_position_ids as jax_pos
    from videollamb_torch.models.splice import packed_position_ids

    seg = np.array([[1, 1, 1, 2, 2, 3, 0, 0], [1, 2, 2, 2, 2, 2, 2, 0]], np.int32)
    np.testing.assert_array_equal(packed_position_ids(torch.from_numpy(seg)).numpy(),
                                  np.asarray(jax_pos(jnp.asarray(seg))))


def test_packed_videollamb_forward_matches_jax(models):
    """Two packed rows with video slots through tower, bridge, packed splice
    and the LM (chunked attention with segments)."""
    from videollamb_tpu.models.assembly import MultimodalBatch as JBatch
    from videollamb_tpu.models.assembly import videollamb_forward as jax_forward
    from videollamb_torch.models.assembly import MultimodalBatch, videollamb_forward

    params, model, cfg = models
    ids, mask, labels, seg, _, _, _ = _packed_inputs(1)
    img = CFG.vision.image_size
    rng = np.random.default_rng(4)
    videos = rng.normal(size=(2, 2, 8, 3, img, img)).astype(np.float32)
    block = np.array([[True, True], [True, False]])
    jb = JBatch(input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask),
                labels=jnp.asarray(labels), videos=jnp.asarray(videos), images=None,
                segment_ids=jnp.asarray(seg), video_block_mask=jnp.asarray(block))
    want_logits, want_sp = jax_forward(params, CFG, jb, attn_impl="chunked")
    pb = MultimodalBatch(*(torch.from_numpy(a) for a in (ids, mask, labels, videos)),
                         segment_ids=torch.from_numpy(seg),
                         video_block_mask=torch.from_numpy(block))
    with torch.no_grad():
        logits, sp = videollamb_forward(model, cfg, pb, attn_impl="chunked")
    n = int(want_sp.lengths.max())
    np.testing.assert_array_equal(sp.labels.numpy(), np.asarray(want_sp.labels))
    np.testing.assert_allclose(logits.numpy()[:, :n], np.asarray(want_logits)[:, :n],
                               rtol=1e-4, atol=1e-4)


def test_bridge_dropout_rate_and_scale():
    """Training-mode dropout zeroes a ``rate`` share and scales the rest by
    1 / (1 - rate); without a generator it is the identity."""
    from videollamb_torch.models.bridge.layers import _dropout

    x = torch.ones(200_000)
    g = torch.Generator().manual_seed(0)
    y = _dropout(x, 0.1, g)
    kept = y != 0
    assert abs(1.0 - float(kept.float().mean()) - 0.1) < 0.005
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.9))
    assert _dropout(x, 0.1, None) is x and _dropout(x, 0.0, g) is x


def test_bridge_forward_draws_dropout_from_the_generator(models):
    """The bridge with its default 0.1 rates: a generator makes the forward
    differ from the deterministic one, and the same seed repeats it."""
    import dataclasses

    from videollamb_torch.models.bridge.rmt_r import rmt_r_video_forward

    _, model, cfg = models
    bcfg = dataclasses.replace(cfg.bridge, hidden_dropout_prob=0.1,
                               attention_probs_dropout_prob=0.1)
    n = CFG.vision.seq_len
    feats = torch.from_numpy(np.random.default_rng(6).normal(
        size=(8, n, CFG.vision.hidden_size)).astype(np.float32))
    with torch.no_grad():
        plain = rmt_r_video_forward(model.mm_projector, bcfg, feats).tokens
        a = rmt_r_video_forward(model.mm_projector, bcfg, feats,
                                torch.Generator().manual_seed(1)).tokens
        b = rmt_r_video_forward(model.mm_projector, bcfg, feats,
                                torch.Generator().manual_seed(1)).tokens
    assert not torch.equal(plain, a)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_patch_dropout_keeps_one_subset_per_video():
    from videollamb_torch.models.vision.clip_vit import patch_dropout

    b, t, n, d = 2, 4, 16, 3
    x = torch.arange(b * t * (1 + n), dtype=torch.float32).reshape(b * t, 1 + n, 1).expand(
        b * t, 1 + n, d) + torch.zeros(b * t, 1 + n, d)
    out = patch_dropout(x, torch.Generator().manual_seed(0), 0.25, b, t)
    assert out.shape == (b * t, 1 + 12, d)
    torch.testing.assert_close(out[:, 0], x[:, 0])  # CLS kept
    kept = (out[:, 1:, 0] - x[:, :1, 0]).long()  # patch indices (1-based)
    for v in range(b):
        rows = kept[v * t:(v + 1) * t]
        assert (rows == rows[:1]).all()  # one subset for every frame of a video
        assert len(set(rows[0].tolist())) == 12
    assert patch_dropout(x, torch.Generator(), 0.0, b, t) is x


def test_vision_encode_with_patch_dropout(models):
    """The tower keeps 1 + (1 - prob) * N tokens a frame under patch dropout
    with a generator, and all of them without one."""
    from videollamb_torch.models.vision.clip_vit import vision_encode

    _, model, cfg = models
    img = CFG.vision.image_size
    px = torch.from_numpy(np.random.default_rng(7).normal(
        size=(2, 8, 3, img, img)).astype(np.float32))
    n = CFG.vision.num_patches
    with torch.no_grad():
        full = vision_encode(model.video_tower, px, cfg.vision)
        cut = vision_encode(model.video_tower, px, cfg.vision, patch_dropout_prob=0.5,
                            generator=torch.Generator().manual_seed(0))
        same = vision_encode(model.video_tower, px, cfg.vision, patch_dropout_prob=0.5)
    assert full.shape[2] == 1 + n and cut.shape[2] == 1 + n // 2
    torch.testing.assert_close(same, full, rtol=0, atol=0)

