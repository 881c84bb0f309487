"""The port's HTTP server against the JAX package's, on the CPU.

One module-scope server of each package over the same seeded
``ModelConfig.tiny(max_length=128)`` model in f32 (dense engine, two slots,
two decode steps per sync), each with its own ``ChatTokenizer`` seeded with
every word the tests send. The same requests go to both servers, and the
responses must be equal, ignoring ids and timestamps: text, token counts,
logprobs (within LOGPROB_ATOL), SSE event sequences, status codes,
``/v1/health`` and ``/v1/models``. Covered: ``/v1/generate`` (plain,
streamed, with logprobs, with a video, concurrent clients), cancel, the
streams API with ``append_video``, adapter load and unload with a 409 while
an adapter request is in flight, a stream ticking while an adapter request
decodes, ``/metrics``' counters over a batch of requests, image, audio and
mixed rows (OpenAI ``image_url`` / ``audio_url`` / ``input_audio`` parts
included), and health degradation on an engine error (last: it leaves both
servers degraded).
Also the gradio demo's callbacks through a stub ``gradio`` module.
"""

from __future__ import annotations

import contextlib
import json
import sys
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from test_serving import ChatTokenizer  # noqa: E402
from test_torch_parity_utils import tiny_models  # noqa: E402

# f32 on both sides: the logprobs of greedy tokens agree to ~1e-6.
LOGPROB_ATOL = 1e-5
WORDS = ("A chat between a curious human and an artificial intelligence assistant "
         "describe the scene what happened next is happening and now tell me more hi")
IGNORED = ("id", "created")


def _tokenizer():
    tok = ChatTokenizer()
    tok(WORDS)
    return tok


def start_servers(max_length: int = 128, embedders=(None, None), model_name="videollamb"):
    """{"jax": (url, Server), "torch": (url, Server)} over one seeded tiny model,
    and a stop function."""
    from videollamb_tpu.data.processing import ImageProcessor as JImage
    from videollamb_tpu.data.processing import VideoProcessor as JVideo
    from videollamb_tpu.serve.chat import Chat as JChat
    from videollamb_tpu.serve.http_server import make_server as jax_make_server
    from videollamb_tpu.serve.server import ServingEngine as JEngine
    from videollamb_torch.data.processing import ImageProcessor, VideoProcessor
    from videollamb_torch.serve.chat import Chat
    from videollamb_torch.serve.http_server import make_server
    from videollamb_torch.serve.server import ServingEngine

    cfg, tree, model, pcfg = tiny_models(max_length=max_length)
    params = jax.tree.map(jnp.asarray, tree)
    from videollamb_torch.models.vision.modalities import AudioProcessor
    from videollamb_tpu.models.vision.modalities import AudioProcessor as JAudio

    size = cfg.vision.image_size
    # Audio mel images at the tiny tower's image size: audio rides the image path.
    jchat = JChat(_tokenizer(), params, cfg, {
        "VIDEO": JVideo(size=size), "IMAGE": JImage(size=size),
        "AUDIO": JAudio(num_mel_bins=size, target_length=size)}, text_bucket=32)
    pchat = Chat(_tokenizer(), model, pcfg, {
        "VIDEO": VideoProcessor(size=size), "IMAGE": ImageProcessor(size=size),
        "AUDIO": AudioProcessor(num_mel_bins=size, target_length=size)}, text_bucket=32)
    built = {
        "jax": jax_make_server(jchat, JEngine(params, cfg, num_slots=2, eos_token_id=2), port=0,
                               k=2, timeout_s=120, model_name=model_name,
                               embedder=embedders[0]),
        "torch": make_server(pchat, ServingEngine(model, pcfg, num_slots=2, eos_token_id=2),
                             port=0, k=2, timeout_s=120, model_name=model_name,
                             embedder=embedders[1]),
    }
    out = {}
    for side, (httpd, srv) in built.items():
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        out[side] = (f"http://127.0.0.1:{httpd.server_address[1]}", srv)

    def stop():
        for httpd, srv in built.values():
            httpd.shutdown()
            srv.shutdown()

    return out, stop


@pytest.fixture(scope="module")
def servers():
    out, stop = start_servers()
    yield out
    stop()


def call(base, path, payload=None, method=None, timeout=120):
    """(status, JSON body) of one request; HTTP errors are returned too."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(base + path, data=data, method=method or (
        "GET" if payload is None else "POST"), headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def sse(base, path, payload, timeout=120):
    req = urllib.request.Request(base + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    events = []
    with urllib.request.urlopen(req, timeout=timeout) as r:
        assert r.headers["Content-Type"] == "text/event-stream"
        for line in r:
            line = line.decode().strip()
            if line.startswith("data: "):
                data = line[len("data: "):]
                events.append(data if data == "[DONE]" else json.loads(data))
    return events


def assert_same(got, want, path="$"):
    """JSON values equal, ignoring ids and timestamps; floats within
    LOGPROB_ATOL."""
    if isinstance(want, dict):
        assert isinstance(got, dict), path
        keys = set(want) - set(IGNORED)
        assert set(got) - set(IGNORED) == keys, (path, sorted(got), sorted(want))
        for k in keys:
            assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), (path, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert abs(got - want) <= LOGPROB_ATOL, (path, got, want)
    else:
        assert got == want, (path, got, want)


def both(servers, fn):
    """fn(url, server) on each package: (port result, JAX result)."""
    return fn(*servers["torch"]), fn(*servers["jax"])


def write_clip(path, frames=16, fps=30, seed=0):
    cv2 = pytest.importorskip("cv2")
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (64, 48))
    rng = np.random.default_rng(seed)
    for _ in range(frames):
        writer.write(rng.integers(0, 255, size=(48, 64, 3)).astype(np.uint8))
    writer.release()
    return str(path)


# ---------------------------------------------------------------------------


def test_health_models_and_error_codes(servers):
    for path in ("/v1/health", "/v1/models", "/v1/adapters", "/nope"):
        got, want = both(servers, lambda url, _: call(url, path))
        assert got[0] == want[0] and (got[0] == 404) == (path == "/nope")
        assert_same(got, want)
    for path, body in (("/v1/generate", {"max_new_tokens": 4}),
                       ("/v1/embeddings", {"input": "hi"}),
                       ("/v1/unknown", {}),
                       ("/v1/cancel", {"id": "req-none"})):
        got, want = both(servers, lambda url, _: call(url, path, body))
        assert_same(got, want)
    assert [call(url, "/v1/embeddings", {"input": "hi"})[0] for url, _ in servers.values()] \
        == [503, 503]
    for url, _ in servers.values():  # a body that is not JSON
        req = urllib.request.Request(url + "/v1/generate", data=b"{nope", method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=30)
        assert e.value.code == 400


def test_generate_plain_stream_and_logprobs_equal_jax(servers):
    body = {"prompt": "describe the scene", "max_new_tokens": 5}
    got, want = both(servers, lambda url, _: call(url, "/v1/generate", body))
    assert got[0] == 200 and got[1]["tokens"] > 0 and got[1]["id"].startswith("req-")
    assert_same(got, want)
    events, jevents = both(servers, lambda url, _: sse(url, "/v1/generate",
                                                       {**body, "stream": True}))
    assert events[-1]["done"] and events[-1]["text"] == got[1]["text"]
    assert len(events) - 1 == events[-1]["tokens"]
    assert_same(events, jevents)
    lp = {"prompt": "what happened next", "max_new_tokens": 4, "logprobs": True,
          "top_logprobs": 3}
    got, want = both(servers, lambda url, _: call(url, "/v1/generate", lp))
    assert len(got[1]["token_logprobs"]) == got[1]["tokens"] and got[1]["top_tokens"]
    assert_same(got, want)
    events, jevents = both(servers, lambda url, _: sse(url, "/v1/generate",
                                                       {**lp, "stream": True}))
    assert "logprob" in events[0] and len(events[0]["top_logprobs"]) == 3
    assert_same(events, jevents)


def test_generate_with_video_and_concurrent_clients_equal_jax(servers, tmp_path):
    clip = write_clip(tmp_path / "clip.mp4")
    body = {"prompt": "describe the scene", "video": clip, "max_new_tokens": 4}
    got, want = both(servers, lambda url, _: call(url, "/v1/generate", body))
    assert got[0] == 200 and got[1]["tokens"] > 0
    assert_same(got, want)

    def pair(url, _):
        results = {}

        def one(name):
            results[name] = call(url, "/v1/generate",
                                 {"prompt": f"describe the scene {name}", "max_new_tokens": 6})

        threads = [threading.Thread(target=one, args=(n,)) for n in ("tell", "more")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        return results

    got, want = both(servers, pair)
    assert set(got) == {"tell", "more"} and all(s == 200 for s, _ in got.values())
    assert_same(got, want)


def write_wav(path, seconds=0.5, sr=16000):
    import wave

    wav = 0.3 * np.sin(2 * np.pi * 330 * np.linspace(0, seconds, int(sr * seconds)))
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((wav * 32767).astype(np.int16).tobytes())
    return str(path)


def test_image_and_audio_rows_are_400_on_the_port(servers, tmp_path):
    """(The name dates from before the image path.) Image, audio and mixed
    rows on /v1/generate, and OpenAI ``image_url`` (a path and a ``data:``
    URI), ``audio_url`` and ``input_audio`` parts on /v1/chat/completions:
    the port's responses equal the JAX server's."""
    import base64

    cv2 = pytest.importorskip("cv2")
    image = str(tmp_path / "x.png")
    cv2.imwrite(image, np.random.default_rng(5).integers(0, 255, (60, 70, 3)).astype(np.uint8))
    audio = write_wav(tmp_path / "x.wav")
    png = base64.b64encode(open(image, "rb").read()).decode()
    wav = base64.b64encode(open(audio, "rb").read()).decode()
    text = {"type": "text", "text": "describe the scene"}
    calls = [
        ("/v1/generate", {"prompt": "describe the scene", "image": image, "max_new_tokens": 4}),
        ("/v1/generate", {"prompt": "describe the scene", "audio": audio, "max_new_tokens": 4}),
        ("/v1/generate", {"prompt": "describe the scene", "image": image, "audio": audio,
                          "video": write_clip(tmp_path / "v.mp4"), "max_new_tokens": 4}),
        ("/v1/chat/completions", {"max_tokens": 4, "messages": [{"role": "user", "content": [
            {"type": "image_url", "image_url": {"url": image}}, text]}]}),
        ("/v1/chat/completions", {"max_tokens": 4, "messages": [{"role": "user", "content": [
            {"type": "image_url", "image_url": {"url": f"data:image/png;base64,{png}"}},
            {"type": "audio_url", "audio_url": {"url": audio}}, text]}]}),
        ("/v1/chat/completions", {"max_tokens": 4, "messages": [{"role": "user", "content": [
            {"type": "input_audio", "input_audio": {"data": wav, "format": "wav"}}, text]}]}),
    ]
    for path, body in calls:
        got, want = both(servers, lambda url, _: call(url, path, body))
        assert got[0] == want[0] == 200, (path, body, got, want)
        assert_same(got[1], want[1])


def _running_uid(srv, timeout=60.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        live = [r for r in srv.engine.slots if r is not None]
        if live and live[0].tokens:
            return live[0].uid
        time.sleep(0.01)
    raise AssertionError("no request reached a slot")


def test_cancel_frees_a_running_request(servers):
    def run(url, srv):
        out = {}
        t = threading.Thread(target=lambda: out.update(r=call(
            url, "/v1/generate", {"prompt": "tell me more", "max_new_tokens": 100})))
        t.start()
        uid = _running_uid(srv)
        cancelled = call(url, "/v1/cancel", {"id": uid})
        t.join(timeout=120)
        status, body = out["r"]
        assert status == 200 and body["id"] == uid and body["tokens"] < 100
        return cancelled

    got, want = both(servers, run)
    assert got == want == (200, {"cancelled": True})


def test_streams_api_with_append_video_equals_jax(servers, tmp_path):
    live = write_clip(tmp_path / "live.mp4", frames=6 * 30, seed=3)
    more = write_clip(tmp_path / "more.mp4", frames=3 * 30, seed=4)

    def session(url, _):
        log = [call(url, "/v1/streams", {"video": live, "fps": 1.0, "query": "what is happening",
                                         "query_time": 0.0, "max_seq_len": 256,
                                         "max_new_tokens": 4})]
        sid = log[0][1]["id"]
        for _ in range(log[0][1]["frames"]):
            log.append(call(url, f"/v1/streams/{sid}/tick", {}))
        log.append(call(url, f"/v1/streams/{sid}/tick", {}))  # past the tail: 400
        log.append(call(url, f"/v1/streams/{sid}/video", {"video": more}))
        log.append(call(url, f"/v1/streams/{sid}/query", {"text": "and now"}))
        for _ in range(3):
            log.append(call(url, f"/v1/streams/{sid}/tick", {}))
        status = call(url, f"/v1/streams/{sid}")
        log += [status, call(url, "/v1/streams"), call(url, f"/v1/streams/{sid}/bogus", {}),
                call(url, f"/v1/streams/{sid}", method="DELETE"), call(url, f"/v1/streams/{sid}")]
        return log

    got, want = both(servers, session)
    codes = [s for s, _ in got]
    assert codes == [s for s, _ in want]
    assert codes[0] == 200 and codes[-1] == 404 and 400 in codes
    responses = [b["event"]["response"] for s, b in got if s == 200 and b.get("event")]
    assert any("Assistant" in (r or "") for r in responses)
    # The reader samples at least 8 frames a clip (fps_num_frames).
    n = got[0][1]["frames"]
    appended = next(b for s, b in got if s == 200 and "total_frames" in b)
    assert n == appended["frames"] == 8 and appended["total_frames"] == 16
    st = [b for s, b in got if s == 200 and "frames_ingested" in b][0]
    assert st["frames_ingested"] == n + 3 and st["context_length"] > 0
    for (gs, gb), (ws, wb) in zip(got, want):
        if gs == 200 and "hbm_resident_frames" in gb:  # prefetch counters: timing
            gb = {k: v for k, v in gb.items() if not k.startswith("prefetch")}
            wb = {k: v for k, v in wb.items() if not k.startswith("prefetch")}
        assert_same(gb, wb)


def test_streams_cap_and_validation(servers):
    def run(url, _):
        log = [call(url, "/v1/streams", {"max_seq_len": 256}) for _ in range(5)]
        sids = [b["id"] for s, b in log if s == 200]
        log.append(call(url, f"/v1/streams/{sids[0]}/tick", {}))  # nothing buffered
        log.append(call(url, f"/v1/streams/{sids[0]}/query", {}))  # no text
        log.append(call(url, f"/v1/streams/{sids[0]}/video", {}))  # no video
        log += [call(url, f"/v1/streams/{s}", method="DELETE") for s in sids]
        log.append(call(url, "/v1/streams"))
        return log

    got, want = both(servers, run)
    assert [s for s, _ in got] == [200] * 4 + [409, 400, 400, 400] + [200] * 5
    assert got[-1][1]["streams"] == []
    assert_same(got, want)


def test_adapter_hot_load_unload_and_busy_409(servers, tmp_path):
    from test_torch_mlora import seeded_adapter, write_peft_dir

    from videollamb_tpu.config import ModelConfig

    lm_cfg = ModelConfig.tiny().lm
    for name, seed in (("med", 7), ("legal", 9)):
        write_peft_dir(str(tmp_path / name), seeded_adapter(lm_cfg, seed, r=4, scale=0.5),
                       alpha=8.0)
    gen = {"prompt": "describe the scene", "max_new_tokens": 5}

    def run(url, srv):
        log = [call(url, "/v1/generate", {**gen, "adapter": "med"}),
               call(url, "/v1/adapters", {"name": "med", "path": str(tmp_path / "med")}),
               call(url, "/v1/generate", gen), call(url, "/v1/generate", {**gen, "adapter": "med"}),
               call(url, "/v1/adapters", {"name": "legal", "path": str(tmp_path / "legal")}),
               call(url, "/v1/generate", {**gen, "adapter": "legal"}),
               call(url, "/v1/adapters")]
        # An adapter request in flight pins the stack: a swap is refused.
        held = {}
        t = threading.Thread(target=lambda: held.update(r=call(
            url, "/v1/generate", {"prompt": "tell me more", "adapter": "legal",
                                  "max_new_tokens": 100})))
        t.start()
        uid = _running_uid(srv)
        log.append(call(url, "/v1/adapters", {"name": "med", "unload": True}))
        call(url, "/v1/cancel", {"id": uid})
        t.join(timeout=120)
        log += [call(url, "/v1/adapters", {"name": "med", "unload": True}),
                call(url, "/v1/generate", {**gen, "adapter": "med"}),
                call(url, "/v1/adapters", {"name": "legal", "unload": True}),
                call(url, "/v1/generate", gen),
                call(url, "/v1/adapters", {"name": "gone", "unload": True}),
                call(url, "/v1/adapters", {"name": "x"})]
        return log

    got, want = both(servers, run)
    assert [s for s, _ in got] == [400, 200, 200, 200, 200, 200, 200, 409,
                                   200, 400, 200, 200, 400, 400]
    base, med, legal = got[2][1]["text"], got[3][1]["text"], got[5][1]["text"]
    assert med != base and legal != med and got[11][1]["text"] == base
    assert got[6][1]["adapters"] == ["legal", "med"] and got[10][1]["adapters"] == []
    assert "in flight" in got[7][1]["error"]
    assert_same(got, want)
    lm = servers["torch"][1].engine.model.lm
    assert getattr(lm, "mlora_rows", None) is None  # the base LM again


def test_stream_tick_while_an_adapter_request_decodes_equals_jax(servers, tmp_path,
                                                                  monkeypatch):
    """A stream ticks on a handler thread while the worker runs an adapter
    request over the same LM: the stream's events are the base model's, as
    JAX's are. The port's worker is held inside its adapter rows until the
    stream's calls have returned, so they overlap on every run."""
    from test_torch_mlora import seeded_adapter, write_peft_dir

    from videollamb_tpu.config import ModelConfig
    from videollamb_torch.serve import server as port_server

    write_peft_dir(str(tmp_path / "med"), seeded_adapter(ModelConfig.tiny().lm, 7, r=4,
                                                         scale=0.5), alpha=8.0)
    clip = write_clip(tmp_path / "live.mp4", frames=2 * 30, seed=5)
    inside, release = threading.Event(), threading.Event()
    real_rows = port_server.adapter_rows

    @contextlib.contextmanager
    def held_rows(lm, idx):
        with real_rows(lm, idx):
            if idx is not None and not release.is_set():
                inside.set()
                release.wait(60)
            yield

    monkeypatch.setattr(port_server, "adapter_rows", held_rows)

    def run(url, srv):
        log = [call(url, "/v1/adapters", {"name": "med", "path": str(tmp_path / "med")})]
        held = {}
        t = threading.Thread(target=lambda: held.update(r=call(
            url, "/v1/generate", {"prompt": "tell me more", "adapter": "med",
                                  "max_new_tokens": 6})))
        t.start()
        if srv is servers["torch"][1]:
            assert inside.wait(60), "the adapter request never reached the LM"
        stream = [call(url, "/v1/streams", {"video": clip, "fps": 1.0,
                                            "query": "what is happening", "query_time": 0.0,
                                            "max_seq_len": 256, "max_new_tokens": 4})]
        sid = stream[0][1]["id"]
        stream += [call(url, f"/v1/streams/{sid}/tick", {}) for _ in range(3)]
        release.set()
        t.join(timeout=120)
        log += [held["r"], call(url, f"/v1/streams/{sid}", method="DELETE"),
                call(url, "/v1/adapters", {"name": "med", "unload": True})]
        return stream, log

    (got, got_log), (want, want_log) = both(servers, run)
    assert [s for s, _ in got] == [200] * 4 and [s for s, _ in got_log] == [200] * 4
    assert any(b.get("event") for _, b in got[1:])
    assert_same(got, want)
    assert_same(got_log, want_log)


def _metrics(url):
    with urllib.request.urlopen(url + "/metrics", timeout=30) as r:
        assert r.headers["Content-Type"].startswith("text/plain")
        body = r.read().decode()
    vals = {}
    for line in body.splitlines():
        if line and not line.startswith("#"):
            name, val = line.rsplit(" ", 1)
            vals[name] = float(val)
    return vals


def test_metrics_counters_equal_jax(servers):
    counters = ("videollamb_requests_total", "videollamb_requests_failed_total",
                "videollamb_tokens_generated_total", "videollamb_ttft_seconds_count",
                "videollamb_e2e_seconds_count")

    def run(url, _):
        before = _metrics(url)
        outs = [call(url, "/v1/generate", {"prompt": p, "max_new_tokens": 3})
                for p in ("describe the scene", "what happened next", "hi")]
        after = _metrics(url)
        assert after["videollamb_ttft_seconds_sum"] <= after["videollamb_e2e_seconds_sum"] + 1e-6
        return outs, {k: after[k] - before[k] for k in counters}, {
            k: after[k] for k in ("videollamb_slots_total", "videollamb_engine_up",
                                  "videollamb_slots_active", "videollamb_queue_pending")}

    got, want = both(servers, run)
    assert got[1]["videollamb_requests_total"] == 3
    assert got[1]["videollamb_tokens_generated_total"] == sum(o["tokens"] for _, o in got[0])
    assert got[2] == {"videollamb_slots_total": 2, "videollamb_engine_up": 1,
                      "videollamb_slots_active": 0, "videollamb_queue_pending": 0}
    assert_same(got, want)


def test_metrics_span_histograms(servers):
    """The port's /metrics (the JAX server has no span recorder): each span
    histogram counts the engine's requests and steps, its buckets cumulative
    up to the count; the recorder's drop counter. The dense engine has no
    paged counters (``tests/test_torch_spans.py`` renders those)."""
    url, _ = servers["torch"]
    series = ("request_queue_seconds", "engine_step_seconds", "engine_admit_seconds",
              "splice_seconds", "admit_prefill_seconds", "engine_pages_seconds",
              "engine_decode_seconds", "decode_commit_seconds", "first_token_seconds")
    before = _metrics(url)
    outs = [call(url, "/v1/generate", {"prompt": p, "max_new_tokens": 3})
            for p in ("describe the scene", "hi")]
    after = _metrics(url)
    assert [s for s, _ in outs] == [200, 200]
    for key in series:
        name = f"videollamb_{key}"
        assert after[name + "_count"] - before[name + "_count"] >= 2, key
        assert after[name + '_bucket{le="+Inf"}'] == after[name + "_count"]
        buckets = [v for k, v in after.items() if k.startswith(name + "_bucket")]
        assert buckets == sorted(buckets) and len(buckets) > 10
    assert after["videollamb_spans_dropped_total"] == 0
    assert "videollamb_prefix_hits_total" not in after


def test_worker_engine_error_fails_inflight_and_degrades_health(servers):
    def run(url, srv):
        real_step = srv.engine.step
        state = {"raised": False}

        def boom(k=1):
            if not state["raised"]:
                state["raised"] = True
                raise RuntimeError("synthetic engine failure")
            return real_step(k)

        srv.engine.step = boom
        try:
            failed = call(url, "/v1/generate", {"prompt": "describe the scene",
                                                "max_new_tokens": 4})
        finally:
            srv.engine.step = real_step
        return failed, call(url, "/v1/health"), call(url, "/v1/generate", {
            "prompt": "describe the scene", "max_new_tokens": 3})

    got, want = both(servers, run)
    assert got[0][0] == 500 and "synthetic engine failure" in got[0][1]["error"]
    assert got[1][1]["status"] == "degraded"
    assert "synthetic engine failure" in got[1][1]["last_error"]
    assert got[2][0] == 200 and got[2][1]["tokens"] > 0
    assert_same(got, want)


# ---------------------------------------------------------------------------
# gradio demo (gradio is not installed: a stub module records the layout)
# ---------------------------------------------------------------------------


class _Widget:
    def __init__(self, *args, **kwargs):
        self.args, self.kwargs, self.events = args, kwargs, []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def _on(self, kind, *args, **kwargs):
        self.events.append((kind, args, kwargs))
        return types.SimpleNamespace(then=lambda *a, **k: None)

    def change(self, *args, **kwargs):
        return self._on("change", *args, **kwargs)

    def submit(self, *args, **kwargs):
        return self._on("submit", *args, **kwargs)

    def click(self, *args, **kwargs):
        return self._on("click", *args, **kwargs)


def _stub_gradio():
    widgets = {}

    def factory(name):
        def make(*args, **kwargs):
            w = _Widget(*args, **kwargs)
            widgets.setdefault(name, []).append(w)
            return w
        return make

    mod = types.ModuleType("gradio")
    for name in ("Blocks", "Markdown", "State", "Row", "Column", "Video", "Image", "Textbox",
                 "Accordion", "Slider", "Chatbot", "Button"):
        setattr(mod, name, factory(name))
    return mod, widgets


def _demo_run(module, chat, clip, monkeypatch):
    """Drive one package's demo callbacks; returns what they yielded."""
    mod, widgets = _stub_gradio()
    monkeypatch.setitem(sys.modules, "gradio", mod)
    module.build_demo(chat)
    on_media = widgets["Video"][0].events[0][1][0]
    reply = widgets["Textbox"][1].events[0][2]["fn"]
    regen, clear = (b.events[0][1][0] for b in widgets["Button"][1:])
    media = {"frames": None, "image": None, "first": True}
    log = [on_media(None, None, media)[0],
           list(reply("hi", [], media, 0.0, 1.0, 4))]
    log.append(on_media(clip, None, media)[0])
    turns = list(reply("describe the scene", [], media, 0.0, 1.0, 4))
    log += [turns, [list(m) for m in chat.conv.messages], media["first"]]
    log.append(list(regen(turns[-1], media, 0.0, 1.0, 4)))
    log += [clear(media), media["first"], len(chat.conv.messages)]
    return log


def test_gradio_callbacks_with_a_stub_module(servers, tmp_path, monkeypatch):
    from videollamb_tpu.serve import gradio_demo as jax_demo
    from videollamb_torch.serve import gradio_demo

    monkeypatch.setitem(sys.modules, "gradio", None)
    with pytest.raises(ImportError, match="gradio is required"):
        gradio_demo.build_demo(servers["torch"][1].chat)
    clip = write_clip(tmp_path / "v.mp4")
    got = _demo_run(gradio_demo, servers["torch"][1].chat, clip, monkeypatch)
    want = _demo_run(jax_demo, servers["jax"][1].chat, clip, monkeypatch)
    assert got[2] == "Loaded 16 video frames." and got[3][-1][-1][0] == "describe the scene"
    assert got[4][-1][1] == got[3][-1][-1][1] and got[5] is False
    assert got[7] == ([], "Cleared.") and got[8] is True and got[9] == 0
    assert got[0] == "Upload a video or an image first."
    assert got[1][-1][-1][1] == "Please upload a video or image first."
    assert_same(got, want)
    # An uploaded image: the status, then the streamed turn through
    # stream_text(images=), equal to the JAX demo's.
    from PIL import Image

    # gr.Image(type="pil") hands the callback a PIL image.
    image = Image.fromarray(
        np.random.default_rng(6).integers(0, 255, (60, 70, 3)).astype(np.uint8))
    chats = {}
    for side, module in (("torch", gradio_demo), ("jax", jax_demo)):
        mod, widgets = _stub_gradio()
        monkeypatch.setitem(sys.modules, "gradio", mod)
        chat = servers[side][1].chat
        module.build_demo(chat)
        media = {"frames": None, "image": None, "first": True}
        status, media = widgets["Image"][0].events[0][1][0](None, image, media)
        reply = widgets["Textbox"][1].events[0][2]["fn"]
        chats[side] = (status, list(reply("describe the scene", [], media, 0.0, 1.0, 4)),
                       media["first"], [list(m) for m in chat.conv.messages])
    assert chats["torch"][0] == "Loaded image." and chats["torch"][2] is False
    assert_same(chats["torch"], chats["jax"])


def test_entry_points_default_to_the_card(monkeypatch, tmp_path):
    import torch

    from videollamb_torch.models.binding import load_binding_checkpoints
    from videollamb_torch.serve import gradio_demo, http_server

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        http_server.main(["--model-path", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        http_server.build_embedder(f"video={tmp_path}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_binding_checkpoints({"video": str(tmp_path)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gradio_demo.main(["--model-path", str(tmp_path)])
