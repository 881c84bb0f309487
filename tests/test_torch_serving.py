"""The port's dense serving engine and batch CLI, on the CPU, on the seeded
tiny reference-format checkpoint in f32.

- ``ServingEngine`` (dense per-slot cache rows) gives the greedy tokens of
  ``videollamb_tpu.serve.server.ServingEngine`` on three video requests on
  two slots.
- ``batch_cli.main`` end to end with a tiny tokenizer: JSONL in, the paged
  int8 and the dense engines, JSONL out; the two engines agree.
- The request fields of the JAX batch CLI (choices, response_format, the
  sampling controls, logprobs, adapter, shared_prefix) build the requests
  that the JAX ``build_requests`` builds, and a batch of such rows through
  the paged engine gives the JAX engine's tokens and logprobs.
- Image and audio rows build the JAX batch CLI's requests;
  ``--device-preprocess`` reaches the loader.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from test_torch_parity_utils import (  # noqa: E402
    jax_requests,
    load_both,
    port_requests,
    serve,
    tiny_tokenizer,
    video_rows,
    write_reference_checkpoint,
)

MAX_NEW, K = 6, 4


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    model_dir, tower_dir = write_reference_checkpoint(str(tmp_path_factory.mktemp("ckpt")),
                                                      seed=3)
    tiny_tokenizer(model_dir)
    return model_dir, tower_dir


def test_dense_engine_greedy_tokens_equal_jax(checkpoint):
    from videollamb_tpu.serve.server import ServingEngine as JaxEngine
    from videollamb_torch.serve.server import ServingEngine

    params, jcfg, model, cfg = load_both(*checkpoint)
    rows = video_rows(cfg, [0, 1, 2], frames=8)
    want = serve(JaxEngine(params, jcfg, num_slots=2, eos_token_id=-1),
                 jax_requests(rows, MAX_NEW), K)
    engine = ServingEngine(model, cfg, num_slots=2, eos_token_id=-1)
    got = serve(engine, port_requests(rows, MAX_NEW), K)
    assert got == want and all(len(t) == MAX_NEW for t in got)
    assert engine.slots == [None, None] and not engine.has_work()


def _frame_dir(tmp_path):
    import cv2

    d = tmp_path / "vid"
    d.mkdir()
    rng = np.random.default_rng(0)
    for i in range(4):
        cv2.imwrite(str(d / f"{i:04d}.jpg"), rng.integers(0, 255, (64, 80, 3)).astype(np.uint8))
    return str(d)


def _run_cli(checkpoint, tmp_path, lines, *flags):
    from videollamb_torch.serve import batch_cli

    model_dir, tower_dir = checkpoint
    src, dst = tmp_path / "in.jsonl", tmp_path / f"out{len(flags)}.jsonl"
    src.write_text("".join(json.dumps(row) + "\n" for row in lines))
    batch_cli.main(["--model-path", model_dir, "--video-tower", tower_dir,
                    "--requests", str(src), "--output", str(dst), "--device", "cpu", "--fp32",
                    "--num-slots", "2", "--sync-every", "3", *flags])
    return {row["id"]: row for row in map(json.loads, dst.read_text().splitlines())}


def test_batch_cli_end_to_end(checkpoint, tmp_path):
    lines = [
        {"id": "a", "prompt": "what is happening in this video", "video": _frame_dir(tmp_path),
         "max_new_tokens": 5},
        {"id": "b", "prompt": "describe it", "max_new_tokens": 4},
        {"id": "c", "prompt": "a chat", "raw": True, "max_new_tokens": 3},
        {"id": "d", "prompt": "what is happening", "video": str(tmp_path / "vid"),
         "history": [["hello", "hi"]], "system": "the assistant", "max_new_tokens": 5,
         "temperature": 0.7},
    ]
    paged = _run_cli(checkpoint, tmp_path, lines, "--paged", "--quantize-kv")
    dense = _run_cli(checkpoint, tmp_path, lines)
    assert set(paged) == set(dense) == {"a", "b", "c", "d"}
    for uid, n in (("a", 5), ("b", 4), ("c", 3)):
        assert 1 <= paged[uid]["tokens"] <= n and isinstance(paged[uid]["text"], str)
    assert 1 <= paged["d"]["tokens"] <= 5
    # Greedy rows: the int8 paged pool and the dense f32 cache pick the same
    # tokens on this model.
    for uid in ("a", "b", "c"):
        assert paged[uid] == dense[uid]


@pytest.mark.parametrize("field,value", [("image", "x.png"), ("audio", "x.wav")])
def test_batch_cli_refuses_unported_row_fields(chats, tmp_path, field, value):
    """(The name dates from before the image path.) An image row and an audio
    row (a WAV as the default 112 x 1036 mel image) build the JAX batch CLI's
    request: equal ids and mask, the same pixels under ``images``."""
    import wave

    import cv2

    from videollamb_torch.serve.batch_cli import build_requests
    from videollamb_tpu.serve.batch_cli import build_requests as jax_build_requests

    path = str(tmp_path / value)
    rng = np.random.default_rng(2)
    if field == "image":
        cv2.imwrite(path, rng.integers(0, 255, (60, 70, 3)).astype(np.uint8))
    else:
        with wave.open(path, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes((rng.uniform(-0.3, 0.3, 8000) * 32767).astype(np.int16).tobytes())
    jchat, chat = chats
    row = {"id": 1, "prompt": "what is happening", field: path, "max_new_tokens": 4}
    (want,) = jax_build_requests([row], jchat)
    (got,) = build_requests([row], chat)
    assert got.batch.input_ids.tolist() == np.asarray(want.batch.input_ids).tolist()
    assert got.batch.attention_mask.tolist() == np.asarray(want.batch.attention_mask).tolist()
    assert got.batch.videos is None and want.batch.videos is None and got.batch.blocks is None
    np.testing.assert_array_equal(got.batch.images.numpy(), np.asarray(want.batch.images))


@pytest.mark.parametrize("flag", ["--device-preprocess"])
def test_batch_cli_refuses_unported_flags(flag, tmp_path, monkeypatch):
    """``--device-preprocess`` is ported now: the flag is no longer refused
    and reaches the loader, which then builds the device processor."""
    from videollamb_torch.models import builder
    from videollamb_torch.serve import batch_cli

    seen = {}

    def loader(*args, **kwargs):
        seen.update(kwargs)
        raise LookupError("stop after the loader call")

    monkeypatch.setattr(builder, "load_pretrained_model", loader)
    with pytest.raises(LookupError, match="stop after the loader"):
        batch_cli.main(["--model-path", "unused", "--requests", "in", "--output", "out",
                        "--device", "cpu", flag])
    assert seen["device_preprocess"] is True


class JsonPieces:
    """The tiny tokenizer with its ``<extra_i>`` ids spelled as the JSON pieces
    of ``tests/test_grammar.py``, so grammar tables can be built over its
    vocabulary (the tiny vocabulary has no '{' or '"')."""

    def __init__(self, tok):
        from test_grammar import PIECES

        self.tok = tok
        self.pieces = {tok.convert_tokens_to_ids(f"<extra_{i}>"): p
                       for i, p in enumerate(PIECES.values())}

    def __getattr__(self, name):
        return getattr(self.tok, name)

    def __call__(self, text):
        return self.tok(text)

    def convert_ids_to_tokens(self, ids):
        return [self.pieces.get(i, t) for i, t in zip(ids, self.tok.convert_ids_to_tokens(ids))]


@pytest.fixture(scope="module")
def chats(checkpoint):
    """(JAX Chat, port Chat) over the f32 checkpoint, tokenizers wrapped."""
    import dataclasses

    from videollamb_torch.models.builder import load_pretrained_model
    from videollamb_torch.serve.chat import Chat
    from videollamb_tpu.models.builder import load_pretrained_model as jax_load
    from videollamb_tpu.serve.chat import Chat as JaxChat

    model_dir, tower_dir = checkpoint
    tok, params, jcfg, procs, _ = jax_load(model_dir, video_tower_path=tower_dir, dtype="float32")
    ptok, model, cfg, pprocs, _ = load_pretrained_model(model_dir, video_tower_path=tower_dir,
                                                        dtype="float32", device="cpu")
    return (JaxChat(JsonPieces(tok), params, dataclasses.replace(jcfg, dtype="float32"), procs),
            Chat(JsonPieces(ptok), model, cfg, pprocs))


@pytest.mark.parametrize("field,value", [
    ("shared_prefix", True), ("choices", ["A", "B"]), ("response_format", "json_object"),
    ("logit_bias", {"5": 1.0}), ("presence_penalty", 0.5), ("min_tokens", 2), ("top_k", 5),
    ("logprobs", True), ("adapter", "x"),
])
def test_batch_cli_builds_row_fields_as_jax(chats, tmp_path, field, value):
    from videollamb_torch.serve.batch_cli import build_requests
    from videollamb_tpu.serve.batch_cli import build_requests as jax_build_requests

    jchat, chat = chats
    row = {"id": 1, "prompt": "what is happening", "video": _frame_dir(tmp_path),
           "max_new_tokens": 4, "top_logprobs": 2, field: value}
    (want,) = jax_build_requests([row], jchat)
    (got,) = build_requests([row], chat)
    for name in ("max_new_tokens", "temperature", "top_k", "logit_bias", "presence_penalty",
                 "frequency_penalty", "min_tokens", "adapter", "choices", "logprobs",
                 "top_logprobs"):
        assert getattr(got, name) == getattr(want, name), name
    for a, b in ((got.batch, want.batch), (got.prefix_batch, want.prefix_batch)):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.input_ids.tolist() == np.asarray(b.input_ids).tolist()
            assert a.attention_mask.tolist() == np.asarray(b.attention_mask).tolist()
            assert (a.videos is None) == (b.videos is None)
    assert (got.grammar is None) == (want.grammar is None)
    if got.grammar is not None:
        vocab = chat.cfg.lm.vocab_size
        assert got.grammar.min_tokens == want.grammar.min_tokens
        np.testing.assert_array_equal(got.grammar.mask(vocab), want.grammar.mask(vocab))


def test_batch_cli_new_rows_give_jax_tokens(chats, tmp_path):
    """Three questions about one video through shared_prefix, a choice row, a
    json_object row, a row with sampling controls and a logprobs row, built
    and served by both packages' batch CLI functions on the paged engine with
    f32 pages: equal tokens and output keys (the logprobs row adds its
    logprobs, which JAX does not write), logprobs within 1e-5, valid
    constrained output."""
    from videollamb_torch.serve import batch_cli
    from videollamb_torch.serve.paged import PagedServingEngine
    from videollamb_tpu.serve import batch_cli as jax_batch_cli
    from videollamb_tpu.serve.paged import PagedServingEngine as JaxEngine

    jchat, chat = chats
    video = _frame_dir(tmp_path)
    lines = [{"id": f"q{i}", "prompt": p, "video": video, "shared_prefix": True,
              "max_new_tokens": 5} for i, p in enumerate(["what is happening", "describe it",
                                                          "what is it"])]
    lines += [
        {"id": "mc", "prompt": "what is it", "video": video, "choices": ["a", "an", "the"]},
        {"id": "js", "prompt": "describe it", "response_format": "json_object",
         "max_new_tokens": 10},
        {"id": "ctl", "prompt": "describe it", "logit_bias": {"40": 2.5}, "min_tokens": 4,
         "presence_penalty": 0.5, "frequency_penalty": 0.25, "max_new_tokens": 6},
        {"id": "lp", "prompt": "what is happening", "video": video, "logprobs": True,
         "top_logprobs": 3, "max_new_tokens": 5},
    ]
    eos = int(chat.tokenizer.eos_token_id)
    jreqs = jax_batch_cli.build_requests(lines, jchat)
    reqs = batch_cli.build_requests(lines, chat)
    want = {r["id"]: r for r in jax_batch_cli.serve_requests(
        JaxEngine(jchat.params, jchat.cfg, num_slots=4, eos_token_id=eos),
        jreqs, jchat.tokenizer, k=3)}
    engine = PagedServingEngine(chat.model, chat.cfg, num_slots=4, eos_token_id=eos)
    got = {r["id"]: r for r in batch_cli.serve_requests(engine, reqs, chat.tokenizer, k=3)}
    assert {k: (v["text"], v["tokens"]) for k, v in got.items()} == {
        k: (v["text"], v["tokens"]) for k, v in want.items()}
    # The output lines are JAX's; only the logprobs row adds its logprobs.
    assert {k: sorted(v) for k, v in got.items()} == {
        k: sorted(set(v) | ({"token_logprobs", "top_logprobs"} if k == "lp" else set()))
        for k, v in want.items()}
    by_id = {r.uid: r for r in reqs}
    assert [r.tokens for r in reqs] == [r.tokens for r in jreqs]
    assert engine.prefix_misses == 1 and engine.prefix_hits == 2
    choice_ids = by_id["mc"].choices
    assert by_id["mc"].tokens in [c + [eos] for c in choice_ids] + choice_ids
    assert len(by_id["ctl"].tokens) >= 4
    jlp = next(r for r in jreqs if r.uid == "lp")
    np.testing.assert_allclose(got["lp"]["token_logprobs"], jlp.token_logprobs, atol=1e-5,
                               rtol=0)
    assert [[e[0] for e in pos] for pos in got["lp"]["top_logprobs"]] == [
        [t for t, _ in pos] for pos in jlp.top_tokens]
