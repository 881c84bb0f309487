"""Prefix caching in the port's paged engine, on the CPU, on
``ModelConfig.tiny`` in f32: a seeded 8-frame video prefix (system + video)
and text suffixes (the questions).

- ``register_prefix`` / ``Request.prefix_id``: greedy tokens equal the JAX
  package's prefix-cached engine and the port's full-prompt requests, with
  f32 and int8 pools; the shared full pages sit in every consumer's table row.
- Automatic prefix caching (``prefix_batch``): tokens, hits, misses and LRU
  eviction past ``prefix_cache_size`` equal the JAX engine's, with f32 and
  int8 pools; eviction before swap under page pressure, an oversized prefix
  rejected, adapter requests refused.
- (``shared_prefix`` rows through ``batch_cli`` are in
  ``test_torch_serving.py``.)
- A prefix slot swapped out and resumed, carrying its sampling counts or its
  choice cursor: tokens and swap counts equal the JAX engine's on the same
  starved pool, with f32 and int8 pools; refcounts come back to zero after
  the drain and ``release_prefix``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from test_torch_parity_utils import serve, tiny_models  # noqa: E402


@pytest.fixture(scope="module")
def models():
    return tiny_models(max_length=128)


def _split_prompt(vocab, seed, suffix_ids, side):
    """(prefix batch with an 8-frame video, suffix batch, full batch) of one side."""
    from videollamb_tpu.constants import VIDEO_TOKEN_INDEX

    rng = np.random.default_rng(seed)
    pre = rng.integers(4, vocab, size=(1, PREFIX_TEXT))
    pre[:, 2] = VIDEO_TOKEN_INDEX
    video = rng.normal(size=(1, 8, 3, 56, 56)).astype(np.float32)
    suf = np.asarray(suffix_ids)[None]
    full = np.concatenate([pre, suf], axis=1)
    if side == "jax":
        import jax.numpy as jnp

        from videollamb_tpu.models.assembly import MultimodalBatch

        def mk(ids, videos):
            return MultimodalBatch(jnp.asarray(ids, jnp.int32),
                                   jnp.ones(ids.shape, jnp.int32), None,
                                   None if videos is None else jnp.asarray(videos), None)
    else:
        from videollamb_torch.models.assembly import MultimodalBatch

        def mk(ids, videos):
            return MultimodalBatch(torch.from_numpy(ids), torch.ones(ids.shape, dtype=torch.long),
                                   videos=None if videos is None else torch.from_numpy(videos))
    return mk(pre, video), mk(suf, None), mk(full, video)


def _request(side, uid, batch, max_new=6, **kw):
    if side == "jax":
        from videollamb_tpu.serve.server import Request
    else:
        from videollamb_torch.serve.server import Request
    return Request(uid=uid, batch=batch, max_new_tokens=max_new, temperature=0.0, **kw)


SUFFIXES = [[7, 11, 13], [21, 22, 23, 24], [30, 31]]
PREFIX_TEXT = 36  # text tokens around the video: 39 spliced, four full pages of 8


@pytest.mark.parametrize("quantize_kv", [False, True], ids=["f32_pool", "int8_pool"])
def test_register_prefix_tokens_equal_jax_and_full_prompts(models, quantize_kv):
    from videollamb_torch.serve.paged import PagedServingEngine
    from videollamb_tpu.serve.paged import PagedServingEngine as JaxEngine

    jcfg, params, model, cfg = models
    vocab = cfg.lm.vocab_size
    kw = dict(num_slots=2, page_size=8, eos_token_id=-1, quantize_kv=quantize_kv)
    out = {}
    for side, engine in (("jax", JaxEngine(params, jcfg, **kw)),
                         ("torch", PagedServingEngine(model, cfg, **kw))):
        pid = engine.register_prefix(_split_prompt(vocab, 5, [], side)[0])
        reqs = [_request(side, uid, _split_prompt(vocab, 5, s, side)[1], prefix_id=pid)
                for uid, s in enumerate(SUFFIXES)]
        out[side] = serve(engine, reqs, 4)
    assert out["torch"] == out["jax"]
    engine = PagedServingEngine(model, cfg, **kw)
    full = [_request("torch", uid, _split_prompt(vocab, 5, s, "torch")[2])
            for uid, s in enumerate(SUFFIXES)]
    assert serve(engine, full, 4) == out["torch"]


def test_shared_pages_sit_in_every_consumer_row(models):
    """Two live consumers map the same full prefix pages at the head of their
    rows (refcount 3: the registration and two slots), private pages after."""
    from videollamb_torch.serve.paged import PagedServingEngine

    _, _, model, cfg = models
    engine = PagedServingEngine(model, cfg, num_slots=2, page_size=8, eos_token_id=-1)
    pid = engine.register_prefix(_split_prompt(cfg.lm.vocab_size, 5, [], "torch")[0])
    shared = engine._prefixes[pid]["pages"]
    assert len(shared) == engine._prefixes[pid]["len"] // 8 >= 4
    for uid, s in enumerate(SUFFIXES[:2]):
        engine.submit(_request("torch", uid, _split_prompt(cfg.lm.vocab_size, 5, s, "torch")[1],
                               prefix_id=pid))
    engine.step(k=2)
    rows = engine.cache.page_table.numpy()
    for slot in range(2):
        assert rows[slot, :len(shared)].tolist() == shared
        assert not set(engine.slot_pages[slot][len(shared):]) & set(shared)
    assert all(engine.allocator.refcount(p) == 3 for p in shared)
    assert engine._prefix_refs[pid] == 2
    engine.run_until_drained(k=2)
    assert all(engine.allocator.refcount(p) == 1 for p in shared)
    engine.release_prefix(pid)
    assert engine.allocator.free_pages == engine.total_pages - 1 and not engine.allocator._rc


@pytest.mark.parametrize("quantize_kv", [False, True], ids=["f32_pool", "int8_pool"])
def test_auto_prefix_hits_misses_and_lru_eviction(models, quantize_kv):
    """Two videos' prefixes through a one-entry cache: the tokens, the hit,
    miss and eviction counts and the pages held equal the JAX engine's, and
    the port's tokens equal its own full-prompt requests."""
    from videollamb_torch.serve.paged import PagedServingEngine
    from videollamb_tpu.serve.paged import PagedServingEngine as JaxEngine

    jcfg, params, model, cfg = models
    vocab = cfg.lm.vocab_size
    kw = dict(num_slots=2, page_size=8, eos_token_id=-1, quantize_kv=quantize_kv,
              prefix_cache_size=1)
    out, counts = {}, {}
    for side, engine in (("jax", JaxEngine(params, jcfg, **kw)),
                         ("torch", PagedServingEngine(model, cfg, **kw))):
        free0 = engine.allocator.free_pages
        out[side] = []
        for seed in (5, 6):
            reqs = []
            for uid, s in enumerate(SUFFIXES[:2]):
                prefix, suffix, _ = _split_prompt(vocab, seed, s, side)
                reqs.append(_request(side, uid, suffix, prefix_batch=prefix))
            out[side].append(serve(engine, reqs, 2))
            assert all(r.error is None for r in reqs)
        counts[side] = (engine.prefix_misses, engine.prefix_hits, engine.prefix_evictions,
                        len(engine._auto_prefix), len(engine._prefixes),
                        free0 - engine.allocator.free_pages, sorted(engine._prefix_refs.values()))
    assert out["torch"] == out["jax"]
    assert counts["torch"] == counts["jax"]
    held = len(next(iter(engine._prefixes.values()))["pages"])
    assert counts["torch"] == (2, 2, 1, 1, 1, held, [0])
    full = PagedServingEngine(model, cfg, **kw)
    for seed, got in zip((5, 6), out["torch"]):
        ref = [_request("torch", uid, _split_prompt(vocab, seed, s, "torch")[2])
               for uid, s in enumerate(SUFFIXES[:2])]
        assert serve(full, ref, 2) == got
    assert engine._evict_idle_prefix() and engine.allocator.free_pages == free0


def test_auto_prefix_page_pressure_evicts_before_swap(models):
    from videollamb_torch.serve.paged import PagedServingEngine

    _, _, model, cfg = models
    vocab = cfg.lm.vocab_size
    engine = PagedServingEngine(model, cfg, num_slots=1, page_size=8, total_pages=9,
                                pages_per_seq=8, eos_token_id=-1)
    prefix, suffix, _ = _split_prompt(vocab, 5, [7, 11, 13], "torch")
    r1 = _request("torch", 0, suffix, max_new=2, prefix_batch=prefix)
    serve(engine, [r1], 1)
    assert r1.error is None and len(engine._auto_prefix) == 1
    # A 20-token text prompt admits into the 4 free pages and grows past them.
    text = _split_prompt(vocab, 7, list(range(4, 24)), "torch")[1]
    r2 = _request("torch", 1, text, max_new=30)
    serve(engine, [r2], 1)
    assert r2.error is None and len(r2.tokens) == 30
    assert engine.prefix_evictions == 1 and not engine._auto_prefix and engine.preempted == 0


def test_auto_prefix_refusals(models):
    """A prefix that cannot fit the pool even empty is rejected; an adapter
    request cannot reuse a base-model prefix; the dense engine refuses
    prefix requests."""
    from videollamb_torch.serve.paged import PagedServingEngine
    from videollamb_torch.serve.server import ServingEngine

    _, _, model, cfg = models
    prefix, suffix, _ = _split_prompt(cfg.lm.vocab_size, 5, [7, 11, 13], "torch")
    for engine, kw, words in (
            (PagedServingEngine(model, cfg, num_slots=1, page_size=8, total_pages=2,
                                pages_per_seq=2, eos_token_id=-1), {}, "prefix"),
            (PagedServingEngine(model, cfg, num_slots=1, page_size=8, eos_token_id=-1,
                                adapter_registry={"a": 0}), {"adapter": "a"}, "adapter"),
            (ServingEngine(model, cfg, num_slots=1, eos_token_id=-1), {}, "paged engine")):
        r = _request("torch", 0, suffix, max_new=4, prefix_batch=prefix, **kw)
        engine.submit(r)
        assert r in engine.step(k=1) and r.done and words in r.error


# The swapped (younger) request's host state: sampling counts and a logit
# bias, or a choice-trie cursor 38 tokens deep when the pool runs dry.
SWAPPED = {"controls": dict(presence_penalty=0.7, frequency_penalty=0.4,
                            logit_bias={9: 3.0, 17: -2.0}),
           "choice": dict(choices=[list(range(10, 48)), list(range(60, 98))])}


@pytest.mark.parametrize("carried", sorted(SWAPPED))
@pytest.mark.parametrize("quantize_kv", [False, True], ids=["f32_pool", "int8_pool"])
def test_prefix_slot_swap_out_keeps_tokens_and_refcounts(models, quantize_kv, carried):
    """A pool too small for two growing prefix requests swaps the younger one
    out (its shared pages saved and released, its sampling counts or choice
    cursor carried) and resumes it. The tokens and the swap-out and resume
    counts equal the JAX engine's on the same starved pool, and the tokens
    equal an ample pool's. Every refcount is back to the registration's after
    the drain, zero after release_prefix, on both sides."""
    from videollamb_torch.serve.paged import PagedServingEngine
    from videollamb_tpu.serve.paged import PagedServingEngine as JaxEngine

    jcfg, params, model, cfg = models
    vocab = cfg.lm.vocab_size
    kw = dict(num_slots=2, page_size=8, eos_token_id=vocab - 1, quantize_kv=quantize_kv)
    starved = dict(total_pages=1 + 4 + 12, pages_per_seq=12)
    out, swaps = {}, {}
    for label, side, engine in (
            ("jax", "jax", JaxEngine(params, jcfg, **kw, **starved)),
            ("starved", "torch", PagedServingEngine(model, cfg, **kw, **starved)),
            ("ample", "torch", PagedServingEngine(model, cfg, **kw))):
        pid = engine.register_prefix(_split_prompt(vocab, 5, [], side)[0])
        reqs = [_request(side, uid, _split_prompt(vocab, 5, s, side)[1], max_new=40,
                         prefix_id=pid, **(SWAPPED[carried] if uid else {}))
                for uid, s in enumerate(SUFFIXES[:2])]
        out[label] = serve(engine, reqs, 4)
        swaps[label] = (engine.preempted, engine.resumed)
        assert all(r.error is None for r in reqs)
        assert all(engine.allocator._rc.get(p) == 1 for p in engine._prefixes[pid]["pages"])
        engine.release_prefix(pid)
        assert engine.allocator.free_pages == engine.total_pages - 1 and not engine.allocator._rc
    assert out["starved"] == out["jax"] == out["ample"]
    assert swaps["starved"] == swaps["jax"] and swaps["jax"][0] >= 1
    assert swaps["jax"][1] == swaps["jax"][0]
    if carried == "choice":
        toks = out["jax"][1]
        assert toks in SWAPPED["choice"]["choices"] or toks[:-1] in SWAPPED["choice"]["choices"]


@pytest.mark.parametrize("kind", ["dense", "paged_int8"])
def test_share_prefill_siblings_equal_separate_requests(models, kind):
    """clone_request + share_prefill: three siblings of one video request
    copy the first one's prefill and answer as three separate requests, as
    the JAX engine's siblings do."""
    from videollamb_torch.serve.paged import PagedServingEngine
    from videollamb_torch.serve.server import ServingEngine, clone_request, share_prefill
    from videollamb_tpu.serve.paged import PagedServingEngine as JaxPaged
    from videollamb_tpu.serve.server import ServingEngine as JaxDense
    from videollamb_tpu.serve.server import clone_request as jax_clone
    from videollamb_tpu.serve.server import share_prefill as jax_share

    jcfg, params, model, cfg = models
    kw = dict(num_slots=2, eos_token_id=-1)
    if kind == "paged_int8":
        kw.update(page_size=8, quantize_kv=True)
    out = {}
    for side, engine, clone, share in (
            ("jax", (JaxDense if kind == "dense" else JaxPaged)(params, jcfg, **kw), jax_clone,
             jax_share),
            ("torch", (ServingEngine if kind == "dense" else PagedServingEngine)(model, cfg, **kw),
             clone_request, share_prefill)):
        first = _request(side, 0, _split_prompt(cfg.lm.vocab_size, 5, [7, 11], side)[2])
        sibs = [first] + [clone(first) for _ in range(2)]
        for uid, r in enumerate(sibs):
            r.uid = uid
        share(sibs)
        out[side] = serve(engine, sibs, 3)
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == out["torch"][1] == out["torch"][2]
    assert sibs[0]._shared_prefill["data"] is None and sibs[0]._shared_prefill["left"] == 0
