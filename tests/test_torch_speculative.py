"""Speculative decoding in the port against the JAX package, on the CPU in f32.

- ``propose_lookup`` equals JAX's on random and repetitive contexts.
- ``speculative_decode`` (prompt lookup) and ``speculative_decode_draft``
  (int8 self-draft, and an unrelated draft that is mostly rejected) give the
  port's own greedy tokens AND the JAX functions' tokens and acceptance
  counts, with rollbacks and multi-token accepts on the way.
- The dense ``ServingEngine`` with ``speculative="lookup"`` and ``"draft"``
  gives the JAX engine's tokens.
- The chat CLI takes ``--speculative`` and the batch CLI ``--load-8bit`` on
  ``--device cpu``.
"""

from __future__ import annotations

import builtins
import copy
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from test_torch_parity_utils import (  # noqa: E402
    jax_requests,
    load_both,
    np_tree,
    port_config,
    port_requests,
    serve,
    tiny_tokenizer,
    video_rows,
    write_reference_checkpoint,
)

from videollamb_tpu.config import LlamaConfig, ModelConfig  # noqa: E402
from videollamb_tpu.models import speculative as jspec  # noqa: E402
from videollamb_tpu.models.lm import llama as jl  # noqa: E402
from videollamb_torch.models import speculative as pspec  # noqa: E402
from videollamb_torch.models.lm import llama as pl  # noqa: E402

CFG = LlamaConfig.tiny()
PCFG = port_config(ModelConfig.tiny()).lm


def test_propose_lookup_equals_jax():
    rng = np.random.default_rng(0)
    cases = [[1, 2, 3, 9, 9, 1, 2, 3], [5, 6, 7, 6], [1, 2, 3, 4], [1, 2, 5, 8, 1, 2, 6, 8, 1, 2],
             [], [7]]
    for _ in range(200):
        n = int(rng.integers(1, 40))
        vocab = int(rng.choice([2, 3, 5, 50]))  # small vocabularies repeat a lot
        cases.append(rng.integers(0, vocab, size=n).tolist())
    hits = 0
    for ctx in cases:
        for ngram, k in ((3, 8), (2, 1), (1, 4)):
            got = pspec.propose_lookup(list(ctx), ngram=ngram, k=k)
            assert got == jspec.propose_lookup(list(ctx), ngram=ngram, k=k), (ctx, ngram, k)
            hits += bool(got)
    assert hits > 100


def _models(seed: int):
    """(JAX params, port LM) of the tiny LM from one seed."""
    from videollamb_torch.models.convert import from_jax_params, load_converted_state

    params = jl.init_llama_params(jax.random.PRNGKey(seed), CFG)
    lm = pl.LlamaForCausalLM(PCFG)
    load_converted_state(lm, from_jax_params({"lm": np_tree(params)}), prefix="lm.")
    return params, lm.eval()


@pytest.fixture(scope="module")
def target():
    return _models(0)


def _jax_prefill(params, prompt):
    cache = jl.init_kv_cache(CFG, 1, 128, jnp.float32)
    return jl.llama_prefill(params, CFG, jl.embed_tokens(params, jnp.asarray(prompt[None])),
                            jnp.ones((1, len(prompt)), jnp.int32), cache)


def _port_prefill(lm, prompt):
    cache = pl.init_kv_cache(PCFG, 1, 128, dtype=torch.float32)
    ids = torch.from_numpy(prompt[None].astype(np.int64))
    return pl.llama_prefill(lm, PCFG, pl.embed_tokens(lm, ids), torch.ones_like(ids), cache)


def _port_greedy(lm, prompt, max_new):
    logits, cache = _port_prefill(lm, prompt)
    toks = []
    for _ in range(max_new):
        nxt = int(torch.argmax(logits[0]))
        toks.append(nxt)
        logits, cache = pl.llama_decode_step(
            lm, PCFG, pl.embed_tokens(lm, torch.tensor([[nxt]])), cache)
    return toks


def _prompt(seed: int, repetitive: bool) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if repetitive:  # repetitive prompts make lookup hit: the accept path
        phrase = rng.integers(4, 50, size=5).tolist()
        return np.asarray(phrase * 4 + phrase[:3], np.int32)
    return rng.integers(4, CFG.vocab_size, size=20).astype(np.int32)


@pytest.mark.parametrize("seed,repetitive", [(0, False), (1, True), (2, True), (3, True)])
def test_lookup_speculation_gives_greedy_and_jax_tokens(target, seed, repetitive):
    params, lm = target
    prompt = _prompt(seed, repetitive)
    max_new = 16
    greedy = _port_greedy(lm, prompt, max_new)

    jlogits, jcache = _jax_prefill(params, prompt)
    want, jcache, _, jstats = jspec.speculative_decode(
        {"lm": params}, CFG, jcache, jlogits, prompt.tolist(), max_new_tokens=max_new,
        eos_token_id=-1)
    logits, cache = _port_prefill(lm, prompt)
    toks, cache, next_logits, stats = pspec.speculative_decode(
        lm, PCFG, cache, logits, prompt.tolist(), max_new_tokens=max_new, eos_token_id=-1)
    assert toks == greedy, (toks, greedy, stats)
    assert toks == want and stats == jstats, (stats, jstats)
    # The cache lands at exactly prompt + generated, as JAX's does.
    assert int(cache.length[0]) == int(jcache.length[0]) == len(prompt) + len(toks)
    # And continues the chain: rolled-back slots never reach later attention.
    more = _port_greedy(lm, prompt, max_new + 3)[max_new:]
    for t in more:
        assert int(torch.argmax(next_logits[0])) == t
        next_logits, cache = pl.llama_decode_step(
            lm, PCFG, pl.embed_tokens(lm, torch.tensor([[t]])), cache)


def test_lookup_speculation_rolls_back_and_accepts_several(target):
    """Over the repetitive prompts some round keeps several tokens at once and
    some round rejects part of its proposal (a rollback)."""
    _, lm = target
    multi = rollback = False
    for seed in (1, 2, 3):
        prompt = _prompt(seed, True)
        logits, cache = _port_prefill(lm, prompt)
        _, _, _, stats = pspec.speculative_decode(
            lm, PCFG, cache, logits, prompt.tolist(), max_new_tokens=16, eos_token_id=-1)
        multi |= stats["tokens_per_step"] > 1.0
        rollback |= stats["accepted"] < stats["proposed"]
    assert multi and rollback


def test_lookup_speculation_stops_at_a_stop_token(target):
    params, lm = target
    prompt = _prompt(1, True)
    greedy = _port_greedy(lm, prompt, 16)
    stop = greedy[5]
    cut = greedy[:greedy.index(stop)]
    logits, cache = _port_prefill(lm, prompt)
    toks, cache, _, _ = pspec.speculative_decode(
        lm, PCFG, cache, logits, prompt.tolist(), max_new_tokens=16, eos_token_id=-1,
        stop_ids={stop})
    jlogits, jcache = _jax_prefill(params, prompt)
    want, jcache, _, _ = jspec.speculative_decode(
        {"lm": params}, CFG, jcache, jlogits, prompt.tolist(), max_new_tokens=16,
        eos_token_id=-1, stop_ids={stop})
    assert toks == cut == want
    assert int(cache.length[0]) == int(jcache.length[0])


@pytest.mark.parametrize("draft", ["int8-self", "self", "unrelated"])
def test_draft_speculation_gives_greedy_and_jax_tokens(target, draft):
    """int8-self: the int8 copy of the target drafts (the CLI's self-draft);
    self: perfect acceptance; unrelated: another seed's model, mostly rejected."""
    from videollamb_tpu.models.lm.quant import quantize_llama_params as jax_quantize
    from videollamb_torch.models.lm.quant import quantize_llama_params

    params, lm = target
    if draft == "int8-self":
        dparams = jax_quantize(jax.tree.map(jnp.array, params))
        dlm = quantize_llama_params(copy.deepcopy(lm))
    elif draft == "self":
        dparams, dlm = params, lm
    else:
        dparams, dlm = _models(7)
    prompt = np.asarray(np.random.default_rng(3).integers(4, CFG.vocab_size, size=16), np.int32)
    max_new, k = 24, 5
    greedy = _port_greedy(lm, prompt, max_new)

    jlogits, jcache = _jax_prefill(params, prompt)
    _, jdcache = _jax_prefill(dparams, prompt)
    want, _, _, jstats = jspec.speculative_decode_draft(
        {"lm": params}, CFG, jcache, jlogits, draft_params={"lm": dparams}, draft_cfg=CFG,
        draft_cache=jdcache, max_new_tokens=max_new, eos_token_id=-1, k=k)
    logits, cache = _port_prefill(lm, prompt)
    _, dcache = _port_prefill(dlm, prompt)
    toks, cache, next_logits, stats = pspec.speculative_decode_draft(
        lm, PCFG, cache, logits, draft_params=dlm, draft_cfg=PCFG, draft_cache=dcache,
        max_new_tokens=max_new, eos_token_id=-1, k=k)
    assert toks == greedy, (toks, greedy, stats)
    assert toks == want and stats == jstats, (stats, jstats)
    assert int(cache.length[0]) == len(prompt) + max_new
    if draft == "self":
        assert stats["accept_rate"] == 1.0 and stats["tokens_per_step"] > 2.5
    if draft == "unrelated":
        assert stats["accepted"] < stats["proposed"]  # rollbacks happened
    if draft == "int8-self":
        assert stats["draft_steps"] > 0 and stats["tokens_per_step"] > 1.0
    more = _port_greedy(lm, prompt, max_new + 2)[max_new:]
    for t in more:
        assert int(torch.argmax(next_logits[0])) == t
        next_logits, cache = pl.llama_decode_step(
            lm, PCFG, pl.embed_tokens(lm, torch.tensor([[t]])), cache)


def test_verify_chunks_batched_matches_jax(target):
    """The engine's batched verify on a ragged two-row cache: accepted counts,
    next logits and lengths equal JAX's, an all-padding row stays untouched."""
    params, lm = target
    prompts = [_prompt(1, True), _prompt(2, True)[:11]]
    chunks = np.zeros((3, 4), np.int32)
    mask = np.zeros((3, 4), np.int32)
    jcache = jl.init_kv_cache(CFG, 3, 64, jnp.float32)
    cache = pl.init_kv_cache(PCFG, 3, 64, dtype=torch.float32)
    for row, prompt in enumerate(prompts):
        greedy = _port_greedy(lm, prompt, 4)
        chunks[row] = greedy
        mask[row] = 1
        _, single = _port_prefill(lm, prompt)
        _, jsingle = _jax_prefill(params, prompt)
        n = len(prompt)
        cache.k[:, row, :n], cache.v[:, row, :n] = single.k[:, 0, :n], single.v[:, 0, :n]
        cache.length[row] = n
        jcache = jl.KVCache(k=jcache.k.at[:, row, :n].set(jsingle.k[:, 0, :n]),
                            v=jcache.v.at[:, row, :n].set(jsingle.v[:, 0, :n]),
                            length=jcache.length.at[row].set(n))
    chunks[1, 2] = (chunks[1, 2] + 1) % CFG.vocab_size  # row 1: reject from position 2 on
    mask[0, 3] = 0  # row 0: a three-token chunk
    model = type("M", (), {"lm": lm})()
    cfg = type("C", (), {"lm": PCFG})()
    jcfg = ModelConfig.tiny()
    jacc, jnext, jarg, jcache = jspec.verify_chunks_batched(
        {"lm": params}, jcfg, jnp.asarray(chunks), jnp.asarray(mask), jcache)
    acc, nxt, arg, cache = pspec.verify_chunks_batched(
        model, cfg, torch.from_numpy(chunks).long(), torch.from_numpy(mask).long(), cache)
    assert acc.tolist() == np.asarray(jacc).tolist() == [3, 2, 0]
    assert cache.length.tolist() == np.asarray(jcache.length).tolist()
    assert arg[:2].tolist() == np.asarray(jarg)[:2].tolist()
    np.testing.assert_allclose(nxt[:2].numpy(), np.asarray(jnext)[:2], rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# Engines and command lines, on the seeded reference-format checkpoint.

MAX_NEW, K = 10, 4


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    model_dir, tower_dir = write_reference_checkpoint(str(tmp_path_factory.mktemp("ckpt")),
                                                      seed=3)
    tiny_tokenizer(model_dir)
    return model_dir, tower_dir


@pytest.fixture(scope="module")
def loaded(checkpoint):
    params, jcfg, model, cfg = load_both(*checkpoint)
    rows = video_rows(cfg, [0, 1, 2], frames=8)
    from videollamb_torch.serve.server import ServingEngine

    plain = serve(ServingEngine(model, cfg, num_slots=2, eos_token_id=-1),
                  port_requests(rows, MAX_NEW), K)
    return params, jcfg, model, cfg, rows, plain


@pytest.mark.parametrize("mode", ["lookup", "draft"])
def test_dense_engine_speculation_equals_jax_and_plain_greedy(loaded, mode):
    from videollamb_tpu.models.lm.quant import quantize_llama_params as jax_quantize
    from videollamb_tpu.serve.server import ServingEngine as JaxEngine
    from videollamb_torch.models.lm.quant import quantize_llama_params
    from videollamb_torch.serve.server import ServingEngine

    params, jcfg, model, cfg, rows, plain = loaded
    jkw, kw = {}, {}
    if mode == "draft":  # the int8 copy of the LM drafts
        jkw = dict(draft_params={"lm": jax_quantize(jax.tree.map(jnp.array, params["lm"]))},
                   draft_cfg=jcfg.lm)
        kw = dict(draft_params=quantize_llama_params(copy.deepcopy(model.lm)),
                  draft_cfg=cfg.lm)
    jengine = JaxEngine(params, jcfg, num_slots=2, eos_token_id=-1, speculative=mode,
                        spec_k=4, **jkw)
    want = serve(jengine, jax_requests(rows, MAX_NEW), K)
    engine = ServingEngine(model, cfg, num_slots=2, eos_token_id=-1, speculative=mode,
                           spec_k=4, **kw)
    got = serve(engine, port_requests(rows, MAX_NEW), K)
    assert got == want == plain and all(len(t) == MAX_NEW for t in got)
    assert engine.spec_rounds == jengine.spec_rounds > 0
    assert engine.spec_committed == jengine.spec_committed == 3 * MAX_NEW
    if mode == "draft":  # the int8 copy agrees with its target most of the time
        assert engine.spec_committed / engine.spec_rounds > 1.0
        assert engine.draft_cache.length.tolist() == [0, 0]
    assert engine.slots == [None, None] and engine.cache.length.tolist() == [0, 0]


def test_engine_speculation_falls_back_for_sampled_rows(loaded):
    from videollamb_torch.serve.server import ServingEngine

    _, _, model, cfg, rows, _ = loaded
    engine = ServingEngine(model, cfg, num_slots=2, eos_token_id=-1, speculative="lookup")
    reqs = port_requests(rows[:2], 5)
    reqs[1].temperature = 0.8
    serve(engine, reqs, 2)
    assert engine.spec_rounds == 0 and all(len(r.tokens) == 5 for r in reqs)


def test_engine_speculation_arguments_are_checked(loaded):
    from videollamb_torch.serve.paged import PagedServingEngine
    from videollamb_torch.serve.server import ServingEngine

    _, _, model, cfg, _, _ = loaded
    with pytest.raises(ValueError, match="'lookup' or 'draft'"):
        ServingEngine(model, cfg, speculative="medusa")
    with pytest.raises(ValueError, match="needs draft_params"):
        ServingEngine(model, cfg, speculative="draft")
    import dataclasses

    narrow = dataclasses.replace(cfg.lm, hidden_size=cfg.lm.hidden_size // 2)
    with pytest.raises(ValueError, match="hidden_size must match"):
        ServingEngine(model, cfg, speculative="draft", draft_params=model.lm, draft_cfg=narrow)
    assert PagedServingEngine(model, cfg, num_slots=1, total_pages=3,
                              pages_per_seq=2).speculative is None


def _frame_dir(tmp_path):
    import cv2

    d = tmp_path / "vid"
    d.mkdir()
    rng = np.random.default_rng(0)
    for i in range(4):
        cv2.imwrite(str(d / f"{i:04d}.jpg"), rng.integers(0, 255, (64, 80, 3)).astype(np.uint8))
    return str(d)


def _chat_cli(checkpoint, tmp_path, monkeypatch, capsys, *flags):
    from videollamb_torch.serve import cli

    model_dir, tower_dir = checkpoint
    video = _frame_dir(tmp_path) if not (tmp_path / "vid").exists() else str(tmp_path / "vid")
    questions = iter(["what is happening in this video", "describe it", ""])
    monkeypatch.setattr(builtins, "input", lambda prompt="": next(questions))
    cli.main(cli.parse_args(["--model-path", model_dir, "--video-tower", tower_dir,
                             "--video-file", video, "--device", "cpu", "--fp32",
                             "--temperature", "0", "--max-new-tokens", "6", *flags]))
    return capsys.readouterr().out


@pytest.mark.parametrize("mode", ["lookup", "self-draft-int8"])
def test_cli_speculative_answers_as_plain_greedy(checkpoint, tmp_path, monkeypatch, capsys, mode):
    plain = _chat_cli(checkpoint, tmp_path, monkeypatch, capsys)
    spec = _chat_cli(checkpoint, tmp_path, monkeypatch, capsys, "--speculative", mode)
    assert spec == plain and plain.count("ASSISTANT: ") == 2


def test_batch_cli_load_8bit(checkpoint, tmp_path):
    from videollamb_torch.serve import batch_cli

    model_dir, tower_dir = checkpoint
    src, dst = tmp_path / "in.jsonl", tmp_path / "out.jsonl"
    lines = [{"id": "a", "prompt": "what is happening", "video": _frame_dir(tmp_path),
              "max_new_tokens": 4}, {"id": "b", "prompt": "describe it", "max_new_tokens": 3}]
    src.write_text("".join(json.dumps(row) + "\n" for row in lines))
    seen = {}
    real = batch_cli.serve_requests

    def spy(engine, requests, tokenizer, k=8):
        seen["lm"] = engine.model.lm
        return real(engine, requests, tokenizer, k=k)

    batch_cli.serve_requests = spy
    try:
        batch_cli.main(["--model-path", model_dir, "--video-tower", tower_dir, "--requests",
                        str(src), "--output", str(dst), "--device", "cpu", "--fp32",
                        "--num-slots", "2", "--load-8bit", "--paged", "--quantize-kv"])
    finally:
        batch_cli.serve_requests = real
    out = {row["id"]: row for row in map(json.loads, dst.read_text().splitlines())}
    assert set(out) == {"a", "b"} and 1 <= out["a"]["tokens"] <= 4
    from videollamb_torch.models.lm.quant import QuantLinear

    assert isinstance(seen["lm"].lm_head, QuantLinear) and seen["lm"].lm_head.kind == "int8"
