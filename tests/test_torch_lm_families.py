"""The port's LM families against the JAX package, on the CPU in f32: the
Mistral sliding window, RoPE scaling and the MPT backbone.

- Windowed attention: the port's plain and chunked routes and K3's plain
  version against JAX's ``_xla_attention`` / ``_chunked_attention``, with
  Sq == Skv and Sq < Skv, a key mask, packed segments, and rows whose band
  holds no valid key.
- A tiny Mistral (window 8) whose window bites on a 24-token prompt:
  ``llama_forward``, prefill + extend + decode, the dense engine.
- The paged engine takes a windowed LM whose per-slot context fits in the
  window (tokens equal to JAX's paged engine) and refuses one that does not.
- RoPE inverse frequencies of the three scaled types; ``mpt_forward`` and
  ``convert_mpt_state_dict``.

Seeded reference-format Mistral and ``rope_scaling`` checkpoints are
``test_torch_lm_checkpoints.py``.

Tolerances: f32 through a few layers with sums in other orders than XLA's,
rtol = atol = 1e-4 on logits (as ``test_torch_models``); 1e-5 on one
attention call; 1e-6 relative on RoPE tables.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from test_torch_parity_utils import (  # noqa: E402
    jax_params,
    port_config,
    port_model,
    serve,
    text_requests,
)

from videollamb_tpu.config import LlamaConfig, ModelConfig, RopeScaling  # noqa: E402

MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
ATTN_TOL = dict(rtol=1e-5, atol=1e-5)
WINDOW = 8
MISTRAL = ModelConfig.tiny(lm=LlamaConfig.tiny(sliding_window=WINDOW))
LLAMA3 = RopeScaling(rope_type="llama3", factor=8.0, low_freq_factor=1.0,
                     high_freq_factor=4.0, original_max_position_embeddings=64)


def _t(x):
    return torch.from_numpy(np.asarray(x))


# ---------------------------------------------------------------------------
# Windowed attention
# ---------------------------------------------------------------------------


def _qkv(b, sq, skv, h=4, hkv=2, dh=16, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, sq, h, dh)).astype(np.float32)
    k = rng.normal(size=(b, skv, hkv, dh)).astype(np.float32)
    v = rng.normal(size=(b, skv, hkv, dh)).astype(np.float32)
    k_mask = np.ones((b, skv), bool)
    k_mask[1, skv - 5:] = False  # right padding
    k_mask[0, 10:16] = False  # a hole as wide as a band of 6: row 15 sees no key
    return q, k, v, k_mask


@pytest.mark.parametrize("route", ["torch", "chunked"])
@pytest.mark.parametrize("sq,skv", [(40, 40), (12, 40)], ids=["prefill", "extend"])
@pytest.mark.parametrize("window", [1, 6, 64])
def test_windowed_attention_matches_jax(route, sq, skv, window):
    from videollamb_torch.ops import attention as pa
    from videollamb_tpu.ops import attention as ja

    q, k, v, k_mask = _qkv(2, sq, skv)
    kw = dict(causal=True, scale=0.25, window=window)
    if route == "torch":
        want = ja._xla_attention(*map(jnp.asarray, (q, k, v)), k_mask=jnp.asarray(k_mask), **kw)
        got = pa.multihead_attention(_t(q), _t(k), _t(v), k_mask=_t(k_mask), impl="torch", **kw)
    else:  # key blocks of 16: the band crosses block edges
        want = ja._chunked_attention(*map(jnp.asarray, (q, k, v)), k_mask=jnp.asarray(k_mask),
                                     block_kv=16, **kw)
        got = pa._chunked_attention(_t(q), _t(k), _t(v), k_mask=_t(k_mask), block_kv=16, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)


@pytest.mark.parametrize("route", ["torch", "chunked"])
def test_windowed_attention_with_segments_matches_jax(route):
    """Packed training over a Mistral base: segments, window and key mask."""
    from videollamb_torch.ops.attention import multihead_attention
    from videollamb_tpu.ops.attention import multihead_attention as jax_mha

    q, k, v, k_mask = _qkv(2, 40, 40, seed=1)
    seg = np.repeat(np.array([[1, 2, 3, 3, 0], [1, 1, 2, 2, 2]]), 8, axis=1).astype(np.int32)
    kw = dict(causal=True, window=WINDOW, impl=route)
    want = jax_mha(*map(jnp.asarray, (q, k, v)), k_mask=jnp.asarray(k_mask),
                   segment_ids=jnp.asarray(seg), **{**kw, "impl": "xla"})
    got = multihead_attention(_t(q), _t(k), _t(v), k_mask=_t(k_mask), segment_ids=_t(seg), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)


@pytest.mark.parametrize("window", [None, 1, 6, 17, 64])
def test_flash_reference_window_matches_jax(window):
    """K3's plain version (B, H, S, Dh) at B = 2, rows without a key in their
    band included (the mean of v, as the finite mask gives in JAX); None is
    the unwindowed causal case."""
    from videollamb_torch.ops.flash_attention import flash_attention, flash_attention_reference
    from videollamb_tpu.ops.attention import _xla_attention

    q, k, v, k_mask = _qkv(2, 40, 40, h=4, hkv=4, seed=2)
    want = _xla_attention(*map(jnp.asarray, (q, k, v)), causal=True, k_mask=jnp.asarray(k_mask),
                          scale=0.25, window=window)
    args = (_t(q).transpose(1, 2), _t(k).transpose(1, 2), _t(v).transpose(1, 2), _t(k_mask))
    got = flash_attention_reference(*args, causal=True, scale=0.25, window=window)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), np.asarray(want), **ATTN_TOL)
    # The wrapper takes the plain version for a CPU tensor.
    torch.testing.assert_close(flash_attention(*args, causal=True, scale=0.25, window=window),
                               got, rtol=0, atol=0)


def test_window_refuses_non_causal_and_kernel_offsets():
    from videollamb_torch.ops.attention import multihead_attention
    from videollamb_torch.ops.flash_attention import flash_attention_reference

    q, k, v, _ = map(_t, _qkv(2, 12, 40))
    with pytest.raises(ValueError, match="causal"):
        multihead_attention(q, k, v, causal=False, window=4, impl="torch")
    with pytest.raises(ValueError, match="Sq == Skv"):
        multihead_attention(q, k, v, causal=True, window=4, impl="kernel")
    with pytest.raises(ValueError, match="causal"):
        flash_attention_reference(q, q, q, causal=False, window=4)


# ---------------------------------------------------------------------------
# A tiny Mistral whose window bites
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mistral():
    tree = jax_params(MISTRAL, seed=5)
    return jax.tree.map(jnp.asarray, tree), port_model(MISTRAL, tree)


def _prompt(b=2, s=24, seed=3):
    rng = np.random.default_rng(seed)
    embeds = rng.normal(size=(b, s, MISTRAL.lm.hidden_size)).astype(np.float32)
    mask = (np.arange(s)[None] < np.array([[s], [s - 7]])).astype(np.int32)
    return embeds, mask


@pytest.mark.parametrize("attn_impl", ["auto", "chunked"])
def test_mistral_llama_forward_matches_jax(mistral, attn_impl):
    from videollamb_tpu.models.lm.llama import llama_forward as jax_forward
    from videollamb_torch.models.lm.llama import llama_forward

    jparams, model = mistral
    embeds, mask = _prompt()
    want = jax_forward(jparams["lm"], MISTRAL.lm, jnp.asarray(embeds), jnp.asarray(mask),
                       attn_impl="xla" if attn_impl == "auto" else attn_impl)
    with torch.no_grad():
        got = llama_forward(model.lm, port_config(MISTRAL).lm, _t(embeds), _t(mask),
                            attn_impl=attn_impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    # The window bites: the full-causal logits differ.
    full = dataclasses.replace(port_config(MISTRAL).lm, sliding_window=None)
    with torch.no_grad():
        unwindowed = llama_forward(model.lm, full, _t(embeds), _t(mask))
    assert np.abs(unwindowed.numpy() - got.numpy()).max() > 1e-2


def test_mistral_prefill_extend_decode_match_jax(mistral):
    """Prefill 24 (ragged), extend by 8 (return_all), 5 decode steps."""
    from videollamb_tpu.models.lm import llama as jl
    from videollamb_torch.models.lm import llama as tl

    jparams, model = mistral
    lm_cfg, plm_cfg = MISTRAL.lm, port_config(MISTRAL).lm
    embeds, mask = _prompt()
    b, s_max = 2, 48
    jcache = jl.init_kv_cache(lm_cfg, b, s_max, dtype=jnp.float32)
    jlogits, jcache = jl.llama_prefill(jparams["lm"], lm_cfg, jnp.asarray(embeds),
                                       jnp.asarray(mask), jcache, attn_impl="xla")
    cache = tl.init_kv_cache(plm_cfg, b, s_max, dtype=torch.float32)
    logits, cache = tl.llama_prefill(model.lm, plm_cfg, _t(embeds), _t(mask), cache)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **MODEL_TOL)

    ext = np.random.default_rng(9).normal(size=(b, 8, lm_cfg.hidden_size)).astype(np.float32)
    ext_mask = np.array([[1] * 8, [1] * 5 + [0] * 3], np.int32)
    jall, jcache = jl.llama_extend(jparams["lm"], lm_cfg, jnp.asarray(ext),
                                   jnp.asarray(ext_mask), jcache, return_all=True)
    all_logits, cache = tl.llama_extend(model.lm, plm_cfg, _t(ext), _t(ext_mask), cache,
                                        return_all=True)
    valid = ext_mask.astype(bool)
    np.testing.assert_allclose(all_logits.numpy()[valid], np.asarray(jall)[valid], **MODEL_TOL)
    np.testing.assert_array_equal(cache.length.numpy(), np.asarray(jcache.length))

    jlogits = jall[jnp.arange(b), jnp.asarray(ext_mask.sum(1) - 1)]
    for step in range(5):
        tok = np.argmax(np.asarray(jlogits), axis=-1).astype(np.int32)[:, None]
        jlogits, jcache = jl.llama_decode_step(
            jparams["lm"], lm_cfg, jl.embed_tokens(jparams["lm"], jnp.asarray(tok)), jcache)
        logits, cache = tl.llama_decode_step(
            model.lm, plm_cfg, tl.embed_tokens(model.lm, _t(tok)), cache)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **MODEL_TOL,
                                   err_msg=f"decode step {step}")


def test_mistral_chunked_prefill_matches_prefill(mistral):
    """The engines' admission (PREFILL_CHUNK slices of llama_extend, window
    masks over the cache) against the one-shot prefill, past a chunk."""
    from videollamb_torch.models.lm import llama as tl

    _, model = mistral
    cfg = port_config(MISTRAL).lm
    embeds, mask = _prompt(s=40)
    one = tl.llama_prefill(model.lm, cfg, _t(embeds), _t(mask),
                           tl.init_kv_cache(cfg, 2, 64, dtype=torch.float32))
    old = tl.PREFILL_CHUNK
    tl.PREFILL_CHUNK = 16
    try:
        chunked = tl.chunked_prefill(model.lm, cfg, _t(embeds), _t(mask),
                                     tl.init_kv_cache(cfg, 2, 64, dtype=torch.float32))
    finally:
        tl.PREFILL_CHUNK = old
    np.testing.assert_allclose(chunked[0].numpy(), one[0].numpy(), **MODEL_TOL)
    np.testing.assert_array_equal(chunked[1].length.numpy(), one[1].length.numpy())


def test_mistral_dense_engine_tokens_equal_jax(mistral):
    """Text prompts of 20 tokens, 8 greedy tokens each: the window bites in
    admission and decode."""
    from videollamb_tpu.serve.server import ServingEngine as JaxEngine
    from videollamb_torch.serve.server import ServingEngine

    jparams, model = mistral
    jreqs, reqs = text_requests(MISTRAL.lm.vocab_size, [1, 2, 3], budget=8, prompt_len=20,
                                temperature=0.0)
    want = serve(JaxEngine(jparams, MISTRAL, num_slots=2, eos_token_id=-1), jreqs, 4)
    got = serve(ServingEngine(model, port_config(MISTRAL), num_slots=2, eos_token_id=-1),
                reqs, 4)
    assert got == want and all(len(t) == 8 for t in got)


def test_paged_engine_accepts_a_window_that_cannot_bite():
    """Window 64, pages of 16: 4 pages a slot fit in the window and serve the
    JAX paged engine's tokens (f32 and int8 pools); 5 pages, or the default
    pool, are refused."""
    from videollamb_tpu.serve.paged import PagedServingEngine as JaxEngine
    from videollamb_torch.serve.paged import PagedServingEngine

    cfg = ModelConfig.tiny(max_length=64, lm=LlamaConfig.tiny(sliding_window=64))
    tree = jax_params(cfg, seed=6)
    jparams, model, pcfg = jax.tree.map(jnp.asarray, tree), port_model(cfg, tree), port_config(cfg)
    for quantize in (False, True):
        jreqs, reqs = text_requests(cfg.lm.vocab_size, [4, 5, 6], budget=10, prompt_len=12,
                                    temperature=0.0)
        kw = dict(num_slots=2, page_size=16, pages_per_seq=4, eos_token_id=-1,
                  quantize_kv=quantize)
        want = serve(JaxEngine(jparams, cfg, **kw), jreqs, 4)
        got = serve(PagedServingEngine(model, pcfg, **kw), reqs, 4)
        assert got == want and all(len(t) == 10 for t in got)
    with pytest.raises(ValueError, match="window"):
        PagedServingEngine(model, pcfg, num_slots=2, page_size=16, pages_per_seq=5)
    with pytest.raises(ValueError, match="window"):
        PagedServingEngine(model, pcfg, num_slots=2)


# ---------------------------------------------------------------------------
# RoPE scaling
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scaling", [
    RopeScaling(rope_type="linear", factor=4.0),
    RopeScaling(rope_type="dynamic", factor=2.0),
    RopeScaling(rope_type="dynamic", factor=2.0, target_length=2048),
    LLAMA3,
], ids=["linear", "dynamic", "dynamic_target", "llama3"])
def test_scaled_rope_frequencies_match_jax(scaling):
    from videollamb_torch.config import RopeScaling as PortRopeScaling
    from videollamb_torch.models.lm.rope import rope_cos_sin, scaled_rope_frequencies
    from videollamb_tpu.models.lm import rope as jrope

    port = PortRopeScaling(**dataclasses.asdict(scaling))
    want = np.asarray(jrope.scaled_rope_frequencies(64, 10000.0, scaling, 512))
    got = scaled_rope_frequencies(64, 10000.0, port, 512).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert not np.allclose(got, np.asarray(jrope.rope_frequencies(64))) or (
        scaling.rope_type == "dynamic" and scaling.target_length is None)
    pos = np.arange(0, 600, 7, dtype=np.int32)
    jc, js = jrope.rope_cos_sin(jnp.asarray(pos), 64, 10000.0, scaling, 512)
    c, s = rope_cos_sin(_t(pos), 64, 10000.0, port, 512)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5, atol=1e-5)


def test_scaled_rope_forward_matches_jax():
    from videollamb_tpu.models.lm.llama import llama_forward as jax_forward
    from videollamb_torch.models.lm.llama import llama_forward

    cfg = ModelConfig.tiny(lm=LlamaConfig.tiny(rope_scaling=LLAMA3, max_position_embeddings=64))
    tree = jax_params(cfg, seed=8)
    model = port_model(cfg, tree)
    embeds, mask = _prompt(s=48)
    want = jax_forward(jax.tree.map(jnp.asarray, tree)["lm"], cfg.lm, jnp.asarray(embeds),
                       jnp.asarray(mask), attn_impl="xla")
    with torch.no_grad():
        got = llama_forward(model.lm, port_config(cfg).lm, _t(embeds), _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)


# ---------------------------------------------------------------------------
# MPT
# ---------------------------------------------------------------------------


MPT = dict(vocab_size=128, d_model=48, n_heads=6, n_layers=2, expansion_ratio=2, max_seq_len=32)


def _hf_mpt_state(root: str = "transformer."):
    rng = np.random.default_rng(0)
    d, inner = MPT["d_model"], MPT["expansion_ratio"] * MPT["d_model"]
    sd = {"wte.weight": rng.normal(0, 0.1, (MPT["vocab_size"], d)),
          "norm_f.weight": 1 + rng.normal(0, 0.1, d)}
    for i in range(MPT["n_layers"]):
        p = f"blocks.{i}."
        sd[p + "norm_1.weight"] = 1 + rng.normal(0, 0.1, d)
        sd[p + "norm_2.weight"] = 1 + rng.normal(0, 0.1, d)
        sd[p + "attn.Wqkv.weight"] = rng.normal(0, 0.1, (3 * d, d))
        sd[p + "attn.out_proj.weight"] = rng.normal(0, 0.1, (d, d))
        sd[p + "ffn.up_proj.weight"] = rng.normal(0, 0.1, (inner, d))
        sd[p + "ffn.down_proj.weight"] = rng.normal(0, 0.1, (d, inner))
    return {root + k: torch.from_numpy(v.astype(np.float32)) for k, v in sd.items()}


@pytest.mark.parametrize("root", ["transformer.", ""], ids=["hf_root", "bare"])
def test_mpt_forward_matches_jax(root):
    from videollamb_torch.models.lm import mpt as pm
    from videollamb_tpu.models.lm import mpt as jm

    sd = _hf_mpt_state(root)
    jp = jax.tree.map(jnp.asarray, jm.convert_mpt_state_dict(sd))
    lm = pm.MptForCausalLM(pm.MptConfig(**MPT))
    lm.load_state_dict(pm.convert_mpt_state_dict(sd), strict=True)
    rng = np.random.default_rng(1)
    ids = rng.integers(0, MPT["vocab_size"], (2, 12))
    mask = np.ones((2, 12), np.int32)
    mask[1, 8:] = 0
    want = jm.mpt_forward(jp, jm.MptConfig(**MPT), jm.mpt_embed(jp, jnp.asarray(ids)),
                          jnp.asarray(mask))
    with torch.no_grad():
        got = pm.mpt_forward(lm, pm.MptConfig(**MPT), pm.mpt_embed(lm, _t(ids)), _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    for n in (6, 8, 12):
        np.testing.assert_array_equal(pm.alibi_bias(n, 9), jm.alibi_bias(n, 9))


def test_mpt_seeded_init_runs():
    from videollamb_torch.models.lm import mpt as pm

    cfg = pm.MptConfig(**MPT)
    lm = pm.init_mpt_params(cfg, seed=3)
    logits = pm.mpt_forward(lm, cfg, pm.mpt_embed(lm, torch.arange(10)[None]),
                            torch.ones((1, 10), dtype=torch.long))
    assert logits.shape == (1, 10, MPT["vocab_size"]) and torch.isfinite(logits).all()
