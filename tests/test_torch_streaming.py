"""The port's streaming slice against the JAX package, on the CPU in f32.

- SceneTilling's threshold and left modes and the left depth scores equal
  JAX's exactly (random, tied and two- or three-frame inputs, the top-k
  fallback); the gather form of ``_monotone_run_peaks`` equals the JAX scan
  and the loop it replaced, -inf and ties included.
- ``BoundaryDetector`` gives JAX's bounds frame by frame, past slides of its
  window, and its buffers keep their shapes.
- ``rmt_r_stream_step`` carries JAX's state (within 1e-5) over more segments
  than its ring holds, and a run of steps equals ``rmt_r_video_forward``.
- ``StreamingSession`` answers as JAX's, token for token, on streams that
  compact (and drop segments on a budgeted rebuild), with equal boundaries,
  context lengths, compaction counts and bounded open frames.
- ``LiveInfer`` fires its responses at JAX's times and hands
  ``generate_text`` JAX's prompt and frames (sampling differs by design:
  ``torch.Generator`` against ``jax.random``).
- ``cli_streaming``: ``main`` writes its history; the CLI needs a GPU
  unless given ``--device cpu``; ``--device-preprocess`` reaches the loader; the
  ffmpeg re-encode cache falls back to the source without ffmpeg.

Tolerances: f32 on both sides, so boundaries, ids and answers are compared
exactly; bridge states and tokens within 1e-5 (the same ops summed in other
orders).
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from test_serving import ChatTokenizer  # noqa: E402
from test_torch_parity_utils import jax_params, port_config, port_model  # noqa: E402

from videollamb_tpu.config import ModelConfig  # noqa: E402
from videollamb_tpu.data.processing import VideoProcessor  # noqa: E402
from videollamb_tpu.ops import scene_tilling as jst  # noqa: E402
from videollamb_torch.ops import scene_tilling as st  # noqa: E402

CFG = ModelConfig.tiny()
SYSTEM = "A chat between a curious human and an artificial intelligence assistant"
STATE_TOL = 1e-5


@pytest.fixture(scope="module")
def models():
    tree = jax_params(CFG)
    return tree, port_model(CFG, tree)


def _tokenizer():
    tok = ChatTokenizer()
    tok(SYSTEM)  # the same first ids on both sides
    return tok


def _chats(models):
    from videollamb_tpu.serve.chat import Chat as JaxChat
    from videollamb_torch.serve.chat import Chat

    tree, model = models
    proc = {"VIDEO": VideoProcessor(size=CFG.vision.image_size)}
    return (JaxChat(_tokenizer(), tree, CFG, proc, text_bucket=32),
            Chat(_tokenizer(), model, port_config(CFG), proc, text_bucket=32))


def _scene_frames(t_total, scenes, seed):
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 255, size=(t_total, 56, 56, 3)).astype(np.uint8)
    for (a, b), value in scenes:
        raw[a:b] = value
    return VideoProcessor(size=CFG.vision.image_size)(raw)


# ---------------------------------------------------------------------------
# SceneTilling modes
# ---------------------------------------------------------------------------


def _features(kind: str, seed: int):
    rng = np.random.default_rng(seed)
    if kind == "two":
        return rng.normal(size=(2, 8)).astype(np.float32)
    if kind == "three":
        return rng.normal(size=(3, 8)).astype(np.float32)
    t = int(rng.integers(4, 48))
    if kind == "tied":  # one-hot rows: similarities 0 or 1 exactly, depths tie
        return np.eye(8, dtype=np.float32)[rng.integers(0, 3, size=t)]
    f = rng.normal(size=(t, 8)).astype(np.float32)
    if kind == "scenes":
        for a in sorted(rng.integers(0, t, size=3)):
            f[a:] += rng.normal(size=8) * 3
    return f


@pytest.mark.parametrize("kind", ["random", "scenes", "tied", "two", "three"])
@pytest.mark.parametrize("max_boundaries", [15, 2])
def test_threshold_and_left_modes_equal_jax(kind, max_boundaries):
    for seed in range(8):
        f = _features(kind, seed)
        for name in ("segment_threshold", "segment_left"):
            want = getattr(jst, name)(jnp.asarray(f), alpha=0.5, max_boundaries=max_boundaries)
            got = getattr(st, name)(torch.from_numpy(f), alpha=0.5,
                                    max_boundaries=max_boundaries)
            for w, g in zip(want, got):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"{name} {seed}")
        sims = st._frame_sims(torch.from_numpy(f))
        np.testing.assert_array_equal(
            st.left_depth_scores(sims).numpy(),
            np.asarray(jst.left_depth_scores(jnp.asarray(sims.numpy()))))


def _loop_peaks(sim, reverse):
    """The loop the gather replaced: one comparison per position."""
    xs = sim.flip(0) if reverse else sim
    peaks = [xs[0]]
    for i in range(1, xs.shape[0]):
        peaks.append(torch.where(xs[i - 1] >= xs[i], peaks[-1], xs[i]))
    out = torch.stack(peaks)
    return out.flip(0) if reverse else out


@pytest.mark.parametrize("kind", ["random", "tied", "neg_inf_tail", "neg_inf_holes"])
def test_monotone_run_peaks_gather_equals_scan(kind):
    rng = np.random.default_rng(1)
    for n in (1, 2, 5, 64, 511):
        s = rng.normal(size=n).astype(np.float32)
        if kind == "tied":
            s = np.round(s)
        elif kind == "neg_inf_tail":
            s[n // 2:] = -np.inf
        elif kind == "neg_inf_holes":
            s[rng.integers(0, n, size=n // 3)] = -np.inf
        x = torch.from_numpy(s)
        for reverse in (False, True):
            got = st._monotone_run_peaks(x, reverse=reverse)
            np.testing.assert_array_equal(got.numpy(), _loop_peaks(x, reverse).numpy())
            np.testing.assert_array_equal(
                got.numpy(), np.asarray(jst._monotone_run_peaks(jnp.asarray(s), reverse=reverse)))


# ---------------------------------------------------------------------------
# Boundary detector
# ---------------------------------------------------------------------------


def _cls_stream(t_total, d, seed):
    rng = np.random.default_rng(seed)
    cls = rng.normal(size=(t_total, d)).astype(np.float32) * 0.1
    for a, b in ((5, 12), (15, 30), (33, 47)):
        cls[a:b] += rng.normal(size=d) * 2
    return cls


@pytest.mark.parametrize("cap,t_total", [(16, 40), (128, 60)])
def test_boundary_detector_equals_jax(cap, t_total):
    from videollamb_tpu.ops.streaming_boundaries import BoundaryDetector as JaxDetector
    from videollamb_torch.ops.streaming_boundaries import BoundaryDetector

    cls = _cls_stream(t_total, 16, seed=cap)
    want, got = JaxDetector(dim=16, cap=cap), BoundaryDetector(dim=16, cap=cap)
    for i in range(t_total):
        want.add_frame(cls[i])
        got.add_frame(torch.from_numpy(cls[i]))
        assert got.boundaries() == want.boundaries(), i
        assert (got.base, got.n, got.total) == (want.base, want.n, want.total)
        if 3 <= i + 1 <= cap:  # the window holds the whole stream
            bounds, valid = st.segment_threshold(torch.from_numpy(cls[: i + 1]))
            assert got.boundaries() == bounds[valid].tolist()
    assert got.base > 0 or cap > t_total


def test_boundary_detector_buffers_keep_their_shapes():
    from videollamb_torch.ops.streaming_boundaries import BoundaryDetector

    rng = np.random.default_rng(1)
    det = BoundaryDetector(dim=8, cap=64)
    shapes = set()
    for _ in range(500):
        det.add_frame(torch.from_numpy(rng.normal(size=8).astype(np.float32)))
        shapes.add(det.state_shapes)
    assert shapes == {((64, 8), (63,))}
    assert det.n <= 64 and det.base + det.n == 500
    assert det.boundaries()[-1] == 499


# ---------------------------------------------------------------------------
# Bridge stream step
# ---------------------------------------------------------------------------


def test_bridge_stream_step_equals_jax_past_the_ring(models):
    from videollamb_tpu.models.bridge import rmt_r as jr
    from videollamb_torch.models.bridge import rmt_r as pr

    tree, model = models
    bcfg, pcfg = CFG.bridge, port_config(CFG).bridge
    f, m = bcfg.max_frames_per_segment, bcfg.num_memory_tokens
    jstate = jr.init_stream_state(bcfg, cache_segments=2)
    pstate = pr.init_stream_state(pcfg, cache_segments=2)
    rng = np.random.default_rng(4)
    for s in range(5):
        feats = rng.normal(size=(f, 17, bcfg.hidden_size)).astype(np.float32)
        mask = np.arange(f) < (f if s % 2 == 0 else 3 + s)
        jt, jm, jstate = jr.rmt_r_stream_step(tree["mm_projector"], bcfg, jnp.asarray(feats),
                                              jnp.asarray(mask), jstate)
        pt, pm, pstate = pr.rmt_r_stream_step(model.mm_projector, pcfg, torch.from_numpy(feats),
                                              torch.from_numpy(mask), pstate)
        np.testing.assert_allclose(pt.numpy(), np.asarray(jt), rtol=STATE_TOL, atol=STATE_TOL)
        np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
        for name in ("memory", "cache"):
            np.testing.assert_allclose(getattr(pstate, name).numpy(),
                                       np.asarray(getattr(jstate, name)),
                                       rtol=STATE_TOL, atol=STATE_TOL, err_msg=f"{name} {s}")
        assert int(pstate.count) == int(jstate.count) == s + 1
    assert pstate.cache.shape == (1, 2 * m, bcfg.hidden_size)


def test_bridge_stream_steps_equal_video_forward(models):
    from videollamb_torch.models.bridge import rmt_r as pr

    _, model = models
    pcfg = port_config(CFG).bridge
    feats = torch.from_numpy(np.random.default_rng(2).normal(
        size=(16, 17, pcfg.hidden_size)).astype(np.float32))
    with torch.no_grad():
        out = pr.rmt_r_video_forward(model.mm_projector, pcfg, feats)
    cls, _ = pr.pool_and_split(feats, pcfg)
    idx, mask = st.segment_plan(st.segment_topk(cls, k=pcfg.segment_topk),
                                max_frames=pcfg.max_frames_per_segment)
    state = pr.init_stream_state(pcfg, cache_segments=pcfg.max_segments)
    for s in range(pcfg.max_segments):
        tokens, tmask, state = pr.rmt_r_stream_step(model.mm_projector, pcfg, feats[idx[s]],
                                                    mask[s], state)
        np.testing.assert_allclose(tokens.numpy(), out.all_tokens[s].numpy(),
                                   rtol=STATE_TOL, atol=STATE_TOL)
        assert torch.equal(tmask, out.all_masks[s])
    np.testing.assert_allclose(state.memory[0].numpy(), out.memory.numpy(),
                               rtol=STATE_TOL, atol=STATE_TOL)


# ---------------------------------------------------------------------------
# StreamingSession
# ---------------------------------------------------------------------------


def _run_stream(sess, frames, queries):
    """Drive a session over ``frames``; per tick (query, response, context
    length, boundaries, compactions, open frames)."""
    t_total = frames.shape[0]
    sess.video_tensor = frames
    sess.num_video_frames = t_total
    sess.video_duration = float(t_total)
    ticks = []
    for i in range(t_total):
        if i in queries:
            sess.input_query_stream(queries[i], video_time=float(i))
        sess.input_video_stream(float(i))
        q, r = sess()
        assert sess.context_length + sess.max_new_tokens <= sess.max_seq_len, i
        ticks.append((q, r, sess.context_length, list(sess._segment_boundaries()),
                      sess._compactions, sess.hbm_resident_frames))
    return ticks


# max_seq_len 256 compacts; 56 leaves room for about two of the tiny model's
# 8-frame segments (32 tokens each with 4 open frames), so a budgeted rebuild
# drops some of the four recorded ones.
@pytest.mark.parametrize("max_seq_len,drops", [(256, False), (56, True)])
def test_streaming_session_equals_jax(models, max_seq_len, drops):
    from videollamb_tpu.serve.incremental import StreamingSession as JaxSession
    from videollamb_torch.serve.incremental import StreamingSession

    frames = _scene_frames(48, [((8, 16), 240), ((24, 32), 10), ((36, 42), 128)], seed=7)
    queries = {20: "what is happening", 40: "and now"}
    jchat, chat = _chats(models)
    kw = dict(frame_fps=1.0, max_open_frames=4, max_seq_len=max_seq_len, max_new_tokens=6)
    jsess, sess = JaxSession(jchat, **kw), StreamingSession(chat, **kw)
    want = _run_stream(jsess, frames, queries)
    got = _run_stream(sess, frames, queries)
    assert got == want
    answers = [r for q, r, *_ in got if r is not None and "User: None" not in q]
    assert len(answers) == 2 and all(r.split("Assistant:")[1] for r in answers)
    assert sess._compactions == jsess._compactions > 0
    assert sess._compaction_drops == jsess._compaction_drops
    assert (sess._compaction_drops > 0) == drops
    assert max(t[-1] for t in got) <= 4
    assert int(sess.bridge_state.count) == int(jsess.bridge_state.count) > 4
    for name in ("memory", "cache"):
        np.testing.assert_allclose(getattr(sess.bridge_state, name).numpy(),
                                   np.asarray(getattr(jsess.bridge_state, name)),
                                   rtol=STATE_TOL, atol=STATE_TOL)


def test_streaming_session_prefetch_and_fixed_state(models):
    from videollamb_torch.serve.incremental import StreamingSession

    _, chat = _chats(models)
    frames = _scene_frames(24, [((8, 24), 200)], seed=1)
    sess = StreamingSession(chat, max_open_frames=4, max_seq_len=448, max_new_tokens=2)
    sess.video_tensor, sess.num_video_frames = frames, 24
    sess.input_query_stream("what is happening", video_time=4.0)
    shapes = set()
    for i in range(24):
        sess.input_video_stream(float(i))
        sess()
        shapes.add((sess.kv.k.shape, sess.bridge_state.cache.shape,
                    sess._detector.state_shapes))
    assert len(shapes) == 1
    # Steady one-frame ticks: only the first encode misses the prefetch.
    assert (sess.prefetch_hits, sess.prefetch_misses) == (23, 1)
    assert len(sess.frame_times) == 0
    assert len(sess.boundaries) <= sess._detector.cap + 16


# ---------------------------------------------------------------------------
# LiveInfer
# ---------------------------------------------------------------------------


def _recording(chat, calls):
    def generate_text(prompt, *, videos=None, **kw):
        calls.append((prompt, np.asarray(videos), kw))
        return f"answer{len(calls)}"
    chat.generate_text = generate_text


def test_liveinfer_fires_and_prompts_as_jax(models):
    from videollamb_tpu.serve.streaming import LiveInfer as JaxLiveInfer
    from videollamb_torch.serve.streaming import LiveInfer

    frames = _scene_frames(20, [((6, 11), 230), ((11, 16), 30)], seed=3)
    jchat, chat = _chats(models)
    runs = []
    for cls, c in ((JaxLiveInfer, jchat), (LiveInfer, chat)):
        calls = []
        _recording(c, calls)
        live = cls(c, frame_fps=1.0)
        live.video_tensor, live.num_video_frames = frames, 20
        live.input_query_stream("what is shown", video_time=2.0)
        out = []
        for i in range(20):
            live.input_video_stream(float(i))
            q, r = live()
            if r:
                out.append((q, r))
        runs.append((out, calls, list(live.boundaries)))
    (want, want_calls, want_bd), (got, got_calls, got_bd) = runs
    assert got == want and got_bd == want_bd and len(got) >= 2
    assert any("User: what is shown" in q for q, _ in got)
    assert len(got_calls) == len(want_calls)
    for (gp, gv, gk), (wp, wv, wk) in zip(got_calls, want_calls):
        assert gp == wp and gk == wk == dict(max_new_tokens=512, temperature=0.2,
                                             do_sample=True)
        np.testing.assert_array_equal(gv, wv)
        assert gv.shape[0] % 8 == 0


def test_liveinfer_answers_with_sampling(models):
    from videollamb_torch.serve.streaming import LiveInfer

    _, chat = _chats(models)
    live = LiveInfer(chat, frame_fps=1.0)
    live.video_tensor = _scene_frames(6, [], seed=5)
    live.num_video_frames = 6
    live.input_query_stream("what is shown", video_time=1.0)
    answers = []
    for i in range(6):
        live.input_video_stream(float(i))
        q, r = live()
        if r:
            answers.append((q, r))
    assert [q for q, _ in answers] == ["(Video Time = 1.0s) User: what is shown"]
    assert chat.conv.messages[-1][1] == answers[0][1].split("Assistant:", 1)[1]


# ---------------------------------------------------------------------------
# cli_streaming
# ---------------------------------------------------------------------------


def _mp4(path, frames=90):
    cv2 = pytest.importorskip("cv2")
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 30, (64, 48))
    for i in range(frames):  # 3 s at 30 fps: 3 frames at 1 fps
        writer.write(np.full((48, 64, 3), (i * 5) % 255, np.uint8))
    writer.release()
    return str(path)


@pytest.mark.parametrize("incremental", [False, True], ids=["liveinfer", "incremental"])
def test_cli_streaming_main_writes_history(models, tmp_path, incremental, monkeypatch):
    from videollamb_torch.serve import streaming
    from videollamb_torch.serve.cli_streaming import main, parse_args
    from videollamb_torch.serve.incremental import StreamingSession

    _, chat = _chats(models)
    # A short answer budget: 512 sampled tokens a query take minutes on the CPU.
    monkeypatch.setattr(streaming, "LIVEINFER_MAX_NEW_TOKENS", 4)
    engine = (StreamingSession(chat, max_seq_len=256, max_new_tokens=4) if incremental
              else streaming.LiveInfer(chat))
    args = parse_args(["--model-path", "unused", "--video-file", _mp4(tmp_path / "v.mp4"),
                       "--query", "what is happening", "--no-sleep",
                       "--output", str(tmp_path / "history.json")])
    main(engine, args)
    hist = json.loads((tmp_path / "history.json").read_text())
    assert hist["video_path"] == args.video_file and hist["frame_fps"] == 1.0
    roles = [m["role"] for m in hist["conversation"]]
    assert roles[:2] == ["user", "assistant"]
    assert "User: what is happening" in hist["conversation"][0]["content"]
    assert all(m["cost"] >= 0 for m in hist["conversation"])


def test_cli_streaming_needs_a_gpu(monkeypatch):
    from videollamb_torch.serve import cli_streaming

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = cli_streaming.parse_args(["--model-path", "unused", "--video-file", "v.mp4"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_streaming.run(args)
    # --device-preprocess is ported: it reaches the loader.
    from videollamb_torch.models import builder

    seen = {}

    def loader(*args, **kwargs):
        seen.update(kwargs)
        raise LookupError("stop after the loader call")

    monkeypatch.setattr(builder, "load_pretrained_model", loader)
    args = cli_streaming.parse_args(["--model-path", "unused", "--video-file", "v.mp4",
                                     "--device", "cpu", "--device-preprocess"])
    with pytest.raises(LookupError, match="stop after the loader"):
        cli_streaming.run(args)
    assert seen["device_preprocess"] is True


def test_reencode_cache_equals_jax_and_falls_back(tmp_path, monkeypatch):
    import shutil

    from videollamb_tpu.data import video_reader as jvr
    from videollamb_torch.data import video_reader as vr

    for kw in (dict(fps=1), dict(fps=2, resolution=224), {}):
        assert vr.ffmpeg_command("in.mp4", "out.mp4", **kw) == jvr.ffmpeg_command(
            "in.mp4", "out.mp4", **kw)
    src = _mp4(tmp_path / "clip.mp4")
    monkeypatch.setattr(shutil, "which", lambda name: None)
    assert vr.ffmpeg_reencode_cached(src, str(tmp_path / "cache")) == src
    cached = tmp_path / "cache" / "clip_1fps.mp4"
    cached.parent.mkdir()
    cached.write_bytes(b"")
    assert vr.ffmpeg_reencode_cached(src, str(tmp_path / "cache")) == str(cached)
