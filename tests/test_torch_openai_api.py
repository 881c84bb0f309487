"""The port's OpenAI surface against the JAX package's, on the CPU.

- The converters and builders of ``serve/openai_api.py`` (host only) give
  the JAX module's rows, stops, errors (message, status, code) and response
  objects on the JAX tests' own cases (``tests/test_openai_api.py``: the
  shape errors are read from its parametrisation) and on the tools of
  ``tests/test_tools.py``.
- Over a live server of each package (``test_torch_http_server.start_servers``,
  with a tiny LanguageBind embedder): ``/v1/chat/completions`` and
  ``/v1/completions``, plain and streamed, with stops, logprobs, a video
  part, history, tools, ``n = 2`` greedy over ``clone_request`` /
  ``share_prefill``, and their errors; ``/v1/embeddings``; ``/v1/models``.
  Responses are equal, ignoring ids and timestamps, logprobs within
  ``LOGPROB_ATOL``. Sampled ``n = 3`` is held to its shape only: the port
  samples from a ``torch.Generator``.
"""

from __future__ import annotations

import base64
import copy
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import test_openai_api as jax_tests  # noqa: E402
from test_serving import ChatTokenizer  # noqa: E402
from test_tools import TOOLS  # noqa: E402
from test_torch_http_server import assert_same, both, call, sse, start_servers, write_clip  # noqa: E402

from videollamb_tpu.serve import openai_api as joai  # noqa: E402
from videollamb_torch.serve import openai_api as poai  # noqa: E402

SHAPE_ERRORS = next(m for m in jax_tests.test_row_from_chat_completions_shape_errors.pytestmark
                    if m.name == "parametrize").args[1]


def _parity(name, *args):
    """The JAX and port function ``name`` on deep copies of ``args``: the
    same result, or BadRequests with the same message, status and code."""
    out = []
    for mod in (poai, joai):
        try:
            out.append(("ok", getattr(mod, name)(*copy.deepcopy(args))))
        except Exception as e:  # noqa: BLE001 - compared below
            assert type(e).__name__ == "BadRequest", e
            out.append(("err", (str(e), e.status, e.code)))
    assert_same(out[0], out[1])
    return out[0]


def test_stop_matcher_equals_jax():
    for stops, pieces in ((["END"], ["hello E", "N", "D tail", "more"]),
                          (["\n\n"], ["line\n"]), (["xx", "yy"], ["a yy b xx"]),
                          (["ab", "b"], ["a", "a", "b", "c"])):
        got, want = poai.StopMatcher(stops), joai.StopMatcher(stops)
        assert [got.feed(p) for p in pieces] == [want.feed(p) for p in pieces]
        assert got.flush() == want.flush()


def _chat_bodies(tmp_path):
    img = tmp_path / "pic.png"
    img.write_bytes(b"not-a-real-png")
    full = {"model": "base", "messages": [
        {"role": "system", "content": "be terse"},
        {"role": "user", "content": [{"type": "image_url", "image_url": {"url": f"file://{img}"}},
                                     {"type": "text", "text": "what is this"}]},
        {"role": "assistant", "content": "a test image"},
        {"role": "user", "content": "and now?"}], "max_tokens": 7, "temperature": 0.5,
        "stop": ["\n"]}
    user = {"messages": [{"role": "user", "content": "hi"}]}
    bodies = [full, {**user, "max_completion_tokens": 3, "top_p": 0.5, "top_k": 4,
                     "min_tokens": 2, "presence_penalty": 0.5, "frequency_penalty": -1.0,
                     "logit_bias": {"5": 200, "7": -3}, "choices": ["yes", "no"],
                     "logprobs": True, "top_logprobs": 4, "stop": "x"}]
    bodies += [{"messages": m} for m, _ in SHAPE_ERRORS]
    bodies.append({"messages": [{"role": "user", "content": [
        {"type": "image_url", "image_url": {"url": "a.png"}},
        {"type": "image_url", "image_url": {"url": "b.png"}}, {"type": "text", "text": "x"}]}]})
    extras = [{"n": 9}, {"n": "2"}, {"n": 3}, {"functions": [{}]},
              {"response_format": {"type": "json_schema"}},
              {"response_format": {"type": "json_schema",
                                   "json_schema": {"schema": {"type": "object", "properties": {
                                       "a": {"type": "integer"}}}}}},
              {"response_format": {"type": "json_object"}},
              {"response_format": {"type": "regex", "regex": "[ab]+c"}},
              {"response_format": {"type": "regex", "regex": ""}},
              {"response_format": {"type": "xml"}}, {"guided_regex": "(yes|no)"},
              {"guided_regex": "a", "response_format": {"type": "json_object"}},
              {"stop": [""]}, {"presence_penalty": 3}, {"logit_bias": [1]},
              {"logit_bias": {"a": 1}}, {"top_logprobs": 2}, {"logprobs": True, "top_logprobs": 21},
              {"model": "ft"}, {"model": "nope"}, {"shared_prefix": True},
              {"tools": TOOLS}, {"tools": TOOLS, "tool_choice": "required"},
              {"tools": TOOLS, "tool_choice": {"type": "function",
                                               "function": {"name": TOOLS[1]["function"]["name"]}}},
              {"tools": TOOLS, "tool_choice": "none"}, {"tools": TOOLS, "tool_choice": "bogus"},
              {"tool_choice": "required"}, {"tools": [{"type": "function"}]},
              {"tools": TOOLS, "tool_choice": "required",
               "response_format": {"type": "json_object"}}]
    bodies += [{**user, **e} for e in extras]
    bodies.append({"messages": [
        {"role": "user", "content": "weather?"},
        {"role": "assistant", "tool_calls": [{"id": "c1", "type": "function", "function": {
            "name": TOOLS[0]["function"]["name"], "arguments": "{\"city\": \"Oslo\"}"}}]},
        {"role": "tool", "tool_call_id": "c1", "content": "sunny"}], "tools": TOOLS})
    return bodies


def test_chat_completions_rows_equal_jax(tmp_path):
    outcomes = [_parity("row_from_chat_completions", body, "base", ["ft"])[0]
                for body in _chat_bodies(tmp_path)]
    assert outcomes.count("ok") >= 10 and outcomes.count("err") >= 20
    payload = base64.b64encode(b"RIFFfakewav").decode()
    body = {"messages": [{"role": "user", "content": [
        {"type": "text", "text": "listen"},
        {"type": "input_audio", "input_audio": {"data": payload, "format": "wav"}},
        {"type": "video_url", "video_url": {"url": "data:video/mp4;base64,"
                                            + base64.b64encode(b"mp4").decode()}}]}]}
    rows = []
    for mod in (poai, joai):
        row, stops, temps = mod.row_from_chat_completions(copy.deepcopy(body), "m", [])
        files = {}
        for key in ("audio", "video"):
            with open(row[key], "rb") as f:
                files[key] = (os.path.splitext(row.pop(key))[1], f.read())
        mod._cleanup(temps)
        assert not any(os.path.exists(t) for t in temps)
        rows.append((row, stops, files))
    assert rows[0] == rows[1] and rows[0][2]["audio"] == (".wav", b"RIFFfakewav")
    _parity("row_from_chat_completions", {"messages": [{"role": "user", "content": [
        {"type": "image_url", "image_url": {"url": "data:image/png;base64,%%%"}}]}]}, "m", [])


def test_completions_rows_and_model_routing_equal_jax():
    for body in ({"prompt": "Once upon", "max_tokens": 3, "stop": "."}, {"prompt": ["x"]},
                 {"prompt": ["x", "y"]}, {"prompt": ""}, {"prompt": "x", "echo": True},
                 {"prompt": "x", "logprobs": 3}, {"prompt": "x", "logprobs": 30},
                 {"prompt": "x", "model": "ft", "n": 2}, {"prompt": "x", "tools": TOOLS}):
        _parity("row_from_completions", body, "base", ["ft"])
    for body in ({"model": "base"}, {}, {"model": "ft"}, {"model": "nope"}):
        _parity("resolve_model", body, "base", ["ft"])
        _parity("resolve_model", body, "base", [])


def test_response_builders_equal_jax():
    tok = ChatTokenizer()
    tok("the cat sat on a mat")
    ids, lps = [4, 5, 6], [-0.5, -1.25, -0.125]
    tops = [[(4, -0.5), (7, -2.0)], [(5, -1.25)], [(6, -0.125), (8, -3.0), (9, -4.0)]]
    for name, args in (("chat_logprobs", (tok, ids, lps, tops, 2)),
                       ("chat_logprobs", (tok, ids, lps, tops[:1], 1)),
                       ("completion_logprobs", (tok, ids, lps, tops, 2)),
                       ("completion_logprobs", (tok, ids, lps, tops[:2], 0)),
                       ("chat_logprob_entry", (tok, 4, -0.5, None, 3)),
                       ("usage_dict", (7, 3)), ("error_body", ("bad", "model_not_found")),
                       ("chat_choice", (1, "hi", "stop")),
                       ("chat_choice", (0, "x", "length", None, [{"id": "c"}])),
                       ("completion_choice", (2, "t", "length", {"tokens": []})),
                       ("chat_completion_response", ("r", "m", "t", "stop", {"a": 1})),
                       ("chat_completion_chunk", ("r", "m", {"content": "x"}, None)),
                       ("completion_response", ("r", "m", "t", "length", {"a": 1})),
                       ("completion_chunk", ("r", "m", "t", "stop")),
                       ("models_response", ("base", ["a", "b"]))):
        assert _parity(name, *args)[0] == "ok"


# ---------------------------------------------------------------------------
# Over live servers
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def servers():
    from test_embeddings import ClipTokenizer

    from videollamb_tpu.config import VisionConfig
    from videollamb_tpu.data.processing import ImageProcessor as JImage
    from videollamb_tpu.models.binding import TextConfig, init_binding_params
    from videollamb_tpu.serve.embeddings import EmbeddingService as JaxService
    from videollamb_torch import config as pc
    from videollamb_torch.data.processing import ImageProcessor
    from videollamb_torch.models import binding as pb
    from videollamb_torch.models.convert import binding_from_jax
    from videollamb_torch.serve.embeddings import EmbeddingService

    vcfg = VisionConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                        num_attention_heads=4, image_size=32, patch_size=8, add_time_attn=False)
    tcfg = TextConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                      num_attention_heads=4, vocab_size=100, max_position_embeddings=16)
    tree = jax.tree.map(lambda x: jnp.asarray(x), init_binding_params(
        jax.random.PRNGKey(1), {"image": vcfg}, tcfg, projection_dim=24))
    pv = {"image": pc.VisionConfig(**vcfg.__dict__)}
    pt = pb.TextConfig(**tcfg.__dict__)
    model = pb.LanguageBind(pv, pt, projection_dim=24)
    model.load_state_dict(binding_from_jax(jax.tree.map(lambda x: x.__array__(), tree)))
    embedders = (JaxService(tree, {"image": vcfg}, ClipTokenizer(), {"image": JImage(size=32)},
                            text_cfg=tcfg, model_name="bind-tiny"),
                 EmbeddingService(model.eval(), pv, ClipTokenizer(),
                                  {"image": ImageProcessor(size=32)}, text_cfg=pt,
                                  model_name="bind-tiny", device="cpu"))
    out, stop = start_servers(embedders=embedders, model_name="videollamb-tiny")
    yield out
    stop()


USER = [{"role": "user", "content": "describe the scene"}]


def _same_over_http(servers, path, body, stream=False):
    fn = (lambda url, _: sse(url, path, body)) if stream else (lambda url, _: call(url, path, body))
    got, want = both(servers, fn)
    assert_same(got, want)
    return got


def test_chat_and_completions_equal_jax(servers):
    status, out = _same_over_http(servers, "/v1/chat/completions",
                                  {"messages": USER, "max_tokens": 6})
    assert status == 200 and out["object"] == "chat.completion"
    native = call(servers["torch"][0], "/v1/generate",
                  {"prompt": "describe the scene", "max_new_tokens": 6})[1]
    assert out["choices"][0]["message"]["content"] == native["text"]
    assert out["usage"]["completion_tokens"] == native["tokens"]
    events = _same_over_http(servers, "/v1/chat/completions",
                             {"messages": USER, "max_tokens": 6, "stream": True,
                              "stream_options": {"include_usage": True}}, stream=True)
    assert events[-1] == "[DONE]" and events[-2]["usage"] == out["usage"]
    text = "".join(c["choices"][0]["delta"].get("content", "") for c in events[:-1]
                   if c["choices"])
    assert text.strip() == out["choices"][0]["message"]["content"]
    status, comp = _same_over_http(servers, "/v1/completions",
                                   {"prompt": "describe the scene", "max_tokens": 4})
    assert comp["usage"]["prompt_tokens"] == 4  # raw: BOS + 3 words
    _same_over_http(servers, "/v1/completions",
                    {"prompt": "describe the scene", "max_tokens": 4, "stream": True},
                    stream=True)
    _same_over_http(servers, "/v1/chat/completions", {"messages": [
        {"role": "system", "content": "A chat between a curious human"},
        {"role": "user", "content": "describe the scene"},
        {"role": "assistant", "content": "a scene"},
        {"role": "user", "content": "what happened next"}], "max_tokens": 4})


def test_stops_and_logprobs_equal_jax(servers):
    body = {"messages": [{"role": "user", "content": "what happened next"}], "max_tokens": 8}
    full = call(servers["torch"][0], "/v1/chat/completions", body)[1]
    words = full["choices"][0]["message"]["content"].split()
    assert len(words) >= 2
    # A stop cancels the slot at the next step boundary: how many tokens were
    # committed by then depends on the host's timing, so usage is held to
    # the full answer's count only.
    got, want = both(servers, lambda url, _: call(url, "/v1/chat/completions",
                                                  {**body, "stop": words[1]}))
    for status, out in (got, want):
        assert status == 200 and out["choices"][0]["finish_reason"] == "stop"
        assert out["usage"]["completion_tokens"] <= full["usage"]["completion_tokens"]
        out.pop("usage")
    assert words[1] not in got[1]["choices"][0]["message"]["content"]
    assert_same(got, want)
    _same_over_http(servers, "/v1/chat/completions", {**body, "stop": [words[1]],
                                                      "stream": True}, stream=True)
    status, out = _same_over_http(servers, "/v1/chat/completions", {
        "messages": USER, "max_tokens": 5, "logprobs": True, "top_logprobs": 3})
    entries = out["choices"][0]["logprobs"]["content"]
    assert len(entries) == out["usage"]["completion_tokens"]
    assert all(e["top_logprobs"][0]["token"] == e["token"] for e in entries)
    _same_over_http(servers, "/v1/chat/completions", {
        "messages": USER, "max_tokens": 4, "logprobs": True, "top_logprobs": 2,
        "stream": True}, stream=True)
    status, out = _same_over_http(servers, "/v1/completions", {
        "prompt": "describe the scene", "max_tokens": 4, "logprobs": 2})
    assert len(out["choices"][0]["logprobs"]["top_logprobs"]) == 4


def test_video_part_tools_and_errors_equal_jax(servers, tmp_path):
    clip = write_clip(tmp_path / "clip.mp4")
    status, out = _same_over_http(servers, "/v1/chat/completions", {"messages": [
        {"role": "user", "content": [{"type": "video_url", "video_url": {"url": clip}},
                                     {"type": "text", "text": "describe the scene"}]}],
        "max_tokens": 4})
    assert status == 200 and out["usage"]["completion_tokens"] > 0
    status, out = _same_over_http(servers, "/v1/chat/completions", {
        "messages": USER, "max_tokens": 4, "tools": TOOLS})
    assert status == 200
    for body, code in (({"model": "gpt-4o", "messages": USER}, 404),
                       ({"messages": [{"role": "user", "content": "hi"},
                                      {"role": "assistant", "content": "yo"}]}, 400),
                       ({"messages": USER, "top_logprobs": 3}, 400),
                       ({"messages": USER, "n": 9}, 400),
                       ({"messages": USER, "n": 2, "stream": True}, 400),
                       ({"messages": USER, "tools": TOOLS, "stream": True}, 400),
                       ({"messages": [{"role": "user", "content": [
                           {"type": "video_url", "video_url": {"url": str(tmp_path / "no.mp4")}},
                           {"type": "text", "text": "x"}]}]}, 500)):
        got, want = both(servers, lambda url, _: call(url, "/v1/chat/completions", body))
        assert got[0] == want[0] == code
        if code < 500:  # a missing video: each reader words its own error
            assert_same(got, want)


def test_n_choices_over_shared_prefill(servers):
    status, out = _same_over_http(servers, "/v1/completions", {
        "prompt": "describe the scene", "max_tokens": 4, "temperature": 0.0, "n": 2})
    texts = [c["text"] for c in out["choices"]]
    assert status == 200 and len(texts) == 2 and texts[0] == texts[1]
    status, out = _same_over_http(servers, "/v1/chat/completions", {
        "messages": USER, "max_tokens": 3, "n": 2, "logprobs": True})
    assert [c["index"] for c in out["choices"]] == [0, 1]
    status, out = call(servers["torch"][0], "/v1/chat/completions", {
        "messages": USER, "max_tokens": 5, "temperature": 1.0, "n": 3})
    assert status == 200 and [c["index"] for c in out["choices"]] == [0, 1, 2]
    assert out["usage"]["completion_tokens"] <= 15
    assert len({c["message"]["content"] for c in out["choices"]}) >= 2


def test_embeddings_and_models_equal_jax(servers):
    status, out = _same_over_http(servers, "/v1/embeddings",
                                  {"input": ["hello world", "goodbye"]})
    assert status == 200 and out["model"] == "bind-tiny" and len(out["data"]) == 2
    got, want = both(servers, lambda url, _: call(url, "/v1/embeddings",
                                                  {"input": "hi", "encoding_format": "base64"}))
    vecs = [np.frombuffer(base64.b64decode(r[1]["data"][0]["embedding"]), "<f4")
            for r in (got, want)]
    np.testing.assert_allclose(vecs[0], vecs[1], rtol=0, atol=1e-5)
    for body in ({"input": []}, {"input": "x", "model": "other"}):
        got = _same_over_http(servers, "/v1/embeddings", body)
        assert got[0] in (400, 404)
    status, models = _same_over_http(servers, "/v1/models", None)
    assert [m["id"] for m in models["data"]] == ["videollamb-tiny", "bind-tiny"]
