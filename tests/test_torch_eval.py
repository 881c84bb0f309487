"""The port's eval harness against the JAX package's, on the CPU.

The eval scripts of ``videollamb_torch.eval`` and ``videollamb_tpu.eval`` run on
one seeded ``ModelConfig.tiny(max_length=128)`` model in f32 over the same
synthetic files (cv2-written 8-frame 64 x 48 mp4v clips, a PNG, a WAV; the
JAX package's native decoder, which its ``load_video`` prefers, corrupts the
heap on 56-pixel-wide mp4v clips),
greedy with 4 new tokens, and must write the same
records: the MC JSONL (sequential, through the dense engine in waves, and
constrained to the option letters), the open-ended, consistency, MovieChat
(flat and global / breakpoint), mixed-modality and likelihood JSONL (NIAVH
is in ``test_torch_niavh.py``). Each side
gets a fresh ``ChatTokenizer`` seeded with every word the files hold, so
ids agree. ``rank_options_by_likelihood`` picks JAX's index, with per-option
losses within LOSS_RTOL of JAX's (the same f32 forward, summed in other
orders). ``acc`` and ``gpt_judge`` are checked against a stub
OpenAI-compatible server on 127.0.0.1: equal per-key files and scores, and a
``content_filter`` refusal scores 0.
"""

from __future__ import annotations

import argparse
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
cv2 = pytest.importorskip("cv2")

import jax.numpy as jnp  # noqa: E402
from test_serving import ChatTokenizer  # noqa: E402
from test_torch_parity_utils import tiny_models  # noqa: E402

LOSS_RTOL = 1e-5
WORDS = ("A chat between a curious human and an artificial intelligence assistant "
         "what happens which one how many is shown runs sits jumps red blue green yes no "
         "Answer with the option's letter from the given choices directly. A. B. C. D. E. "
         "A B C D E first? second? overall? now? describe the scene compare "
         "the question using several words or phrase. what was the secret word banana "
         "<video> <image> <audio>")


def _write_clip(path, frames: int, seed: int, size=(64, 48), value=None):
    rng = np.random.default_rng(seed)
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 30, size)
    for _ in range(frames):
        frame = (np.full((size[1], size[0], 3), value, np.uint8) if value is not None
                 else rng.integers(0, 255, (size[1], size[0], 3)).astype(np.uint8))
        writer.write(frame)
    writer.release()
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The synthetic eval set: clips, a PNG, a WAV and the ground-truth JSON."""
    import wave

    root = tmp_path_factory.mktemp("evalset")
    vids = root / "videos"
    vids.mkdir()
    for i, name in enumerate(("v1", "v2")):
        _write_clip(vids / f"{name}.mp4", 8, seed=i)
    cv2.imwrite(str(vids / "x.png"),
                np.random.default_rng(7).integers(0, 255, (60, 70, 3)).astype(np.uint8))
    wav = 0.3 * np.sin(2 * np.pi * 330 * np.linspace(0, 0.5, 8000))
    with wave.open(str(vids / "a.wav"), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((wav * 32767).astype(np.int16).tobytes())
    gt = {
        "mc_q": [
            {"question_id": 1, "video_name": "v1", "question": "what happens",
             "option": {"0": "runs", "1": "sits"}},
            {"question_id": 2, "video_name": "v2", "question": "which one",
             "option": {"0": "red", "1": "blue", "2": "green"}},
            {"question_id": 3, "video_name": "v1", "question": "how many",
             "option": {"0": "yes", "1": "no", "2": "red", "3": "blue", "4": "green"}},
            {"question_id": 4, "video_name": "missing", "question": "what happens",
             "option": {"0": "runs", "1": "sits"}},
        ],
        "mc_a": [{"answer": 0, "type": "demo"}, {"answer": 2}, {"answer": 1, "type": "t2"},
                 {"answer": 0}],
        "oe_q": [{"question_id": 1, "video_name": "v1", "question": "what happens"},
                 {"question_id": 2, "video_name": "v2", "question": "describe the scene"}],
        "oe_a": [{"answer": "runs"}, {"answer": "red"}],
        "consistency": [{"question_id": 1, "video_name": "v1", "Q1": "first?",
                         "Q2": "second?", "A": "yes"},
                        {"question_id": 2, "video_name": "v2", "Q1": "what happens",
                         "Q2": "which one", "A": "no"}],
        "moviechat_q": [{"question_id": 1, "video_name": "v1", "question": "what",
                         "type": "g"},
                        {"question_id": 2, "video_name": "v2", "question": "how many",
                         "type": "b"}],
        "moviechat_a": [{"answer": "yes"}, {"answer": "no"}],
        "moviechat_ws": [{"video_name": "v1",
                          "global": [{"video_name": "v1", "question": "overall?"}],
                          "breakpoint": [{"video_name": "v1", "question": "now?",
                                          "time": 3}]},
                         {"video_name": "v2",
                          "global": [{"video_name": "v2", "question": "what happens"}],
                          "breakpoint": []}],
        "mixed_q": [{"question_id": 1, "question": "compare", "video_name": "v1",
                     "image_name": "x.png", "audio_name": "a.wav"},
                    {"question_id": 2, "question": "describe the scene",
                     "image_name": "x.png"},
                    {"question_id": 3, "question": "what happens", "video_name": "v2",
                     "audio_name": "missing.wav"}],
        "mixed_a": [{"answer": "yes"}, {"answer": "red"}, {"answer": "no"}],
        "lk_q": [{"question_id": 1, "video_name": "v1", "question": "what happens",
                  "option": {"0": "a dog runs", "1": "nothing at all", "2": "cats"}},
                 {"question_id": 2, "video_name": "v2", "question": "which one",
                  "option": {"0": "red", "1": "blue", "2": "green"}}],
        "lk_a": [{"answer": 0, "type": "demo"}, {"answer": 2}],
    }
    for name, rows in gt.items():
        (root / f"{name}.json").write_text(json.dumps(rows))
    return root


@pytest.fixture(scope="module")
def models():
    cfg, tree, model, pcfg = tiny_models(max_length=128)
    return cfg, jax.tree.map(jnp.asarray, tree), model, pcfg


def _chats(models):
    """(JAX Chat, port Chat), each with its own tokenizer and processors."""
    from videollamb_torch.data.processing import ImageProcessor, VideoProcessor
    from videollamb_torch.models.vision.modalities import AudioProcessor
    from videollamb_torch.serve.chat import Chat
    from videollamb_tpu.data.processing import ImageProcessor as JImage
    from videollamb_tpu.data.processing import VideoProcessor as JVideo
    from videollamb_tpu.models.vision.modalities import AudioProcessor as JAudio
    from videollamb_tpu.serve.chat import Chat as JChat

    cfg, params, model, pcfg = models
    size = cfg.vision.image_size
    out = []
    for chat_cls, m, c, video, image, audio in (
            (JChat, params, cfg, JVideo, JImage, JAudio),
            (Chat, model, pcfg, VideoProcessor, ImageProcessor, AudioProcessor)):
        tok = ChatTokenizer()
        tok(WORDS)
        out.append(chat_cls(tok, m, c, {
            "VIDEO": video(size=size), "IMAGE": image(size=size),
            "AUDIO": audio(num_mel_bins=size, target_length=size)}, text_bucket=32))
    return out


def _args(files, out, name, **kw):
    base = dict(video_dir=str(files / "videos"), output_dir=str(out), output_name=name,
                num_chunks=1, chunk_idx=0, num_frames=8, max_new_tokens=4, temperature=0.0,
                names_have_extension=False, model_path=None, model_base=None,
                video_tower=None, device="cpu")
    base.update(kw)
    return argparse.Namespace(**base)


def _lines(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _run_both(models, files, tmp_path, run, **kw):
    """run(package, args, jax_chat, port_chat) on each side -> (port, JAX)
    (result, records)."""
    import videollamb_torch.eval as port_eval
    import videollamb_tpu.eval as jax_eval

    jchat, pchat = _chats(models)
    out = {}
    for side, pkg, chat in (("torch", port_eval, pchat), ("jax", jax_eval, jchat)):
        args = _args(files, tmp_path / side, "pred", **kw)
        result = run(pkg, args, chat)
        out[side] = ({k: v for k, v in result.items() if k not in ("output", "records")},
                     _lines(result.get("output") or result["records"]))
    return out["torch"], out["jax"]


MC = dict(gt_file_question="mc_q.json", gt_file_answers="mc_a.json")


def _mc_run(mode):
    def run(pkg, args, chat):
        import importlib

        mc = importlib.import_module(pkg.__name__ + ".videoqa_mc")
        if mode == "sequential":
            return mc.run_inference(args, chat=chat)
        args.constrained = mode == "constrained"
        return mc.run_inference_batched(args, chat=chat, num_slots=2, sync_every=3)
    return run


@pytest.mark.parametrize("mode", ["sequential", "batched", "constrained"])
def test_mc_records_equal_jax(models, files, tmp_path, mode):
    kw = {k: str(files / v) for k, v in MC.items()}
    got, want = _run_both(models, files, tmp_path, _mc_run(mode), **kw)
    assert got == want
    assert got[0]["n"] == 3 and [r["id"] for r in got[1]] == [1, 2, 3]
    if mode == "constrained":
        assert all(r["pred"] in "ABCDE"[: len(q["option"])]
                   for r, q in zip(got[1], json.loads((files / "mc_q.json").read_text())))


def _runner(module, fn="run_inference"):
    def run(pkg, args, chat):
        import importlib

        return getattr(importlib.import_module(f"{pkg.__name__}.{module}"), fn)(args, chat=chat)
    return run


OPEN_ENDED = {
    "videoqa": (_runner("videoqa"), dict(gt_file_question="oe_q.json",
                                         gt_file_answers="oe_a.json")),
    "consistency": (_runner("videoqa_consistency"), dict(gt_file="consistency.json")),
    "moviechat_flat": (_runner("videoqa_moviechat"), dict(
        gt_file_question="moviechat_q.json", gt_file_answers="moviechat_a.json")),
    "moviechat_global_breakpoint": (
        _runner("videoqa_moviechat", "run_inference_global_breakpoint"),
        dict(gt_file_question="moviechat_ws.json")),
    "mixed": (_runner("videoqa_mixed"), dict(gt_file_question="mixed_q.json",
                                             gt_file_answers="mixed_a.json",
                                             image_dir=None, audio_dir=None)),
    "likelihood": (_runner("videoqa_likelihood"), dict(gt_file_question="lk_q.json",
                                                       gt_file_answers="lk_a.json")),
}


@pytest.mark.parametrize("name", list(OPEN_ENDED))
def test_eval_records_equal_jax(models, files, tmp_path, name):
    run, paths = OPEN_ENDED[name]
    kw = {k: (str(files / v) if v else v) for k, v in paths.items()}
    got, want = _run_both(models, files, tmp_path, run, **kw)
    assert got == want and got[1]
    if name == "mixed":  # the third sample names a missing WAV and is skipped
        assert [r["modalities"] for r in got[1]] == [["VIDEO", "IMAGE", "AUDIO"], ["IMAGE"]]


def _jax_losses(chat, question, options, frames):
    """JAX's per-option losses, as ``videollamb_tpu.eval.videoqa_likelihood``
    computes them before its argmin."""
    from videollamb_tpu.constants import DEFAULT_X_TOKEN, IGNORE_INDEX
    from videollamb_tpu.models.assembly import MultimodalBatch, videollamb_forward
    from videollamb_tpu.train.preprocess import preprocess

    per = [preprocess([[{"from": "human", "value": DEFAULT_X_TOKEN["VIDEO"] + "\n" + question},
                        {"from": "gpt", "value": o}]], chat.tokenizer, x="VIDEO")
           for o in options]
    max_len = min(-(-max(len(d["input_ids"][0]) for d in per) // 16) * 16, chat.cfg.max_length)
    n = len(options)
    ids = np.zeros((n, max_len), np.int32)
    labels = np.full((n, max_len), IGNORE_INDEX, np.int32)
    mask = np.zeros((n, max_len), np.int32)
    for i, d in enumerate(per):
        row = d["input_ids"][0][:max_len]
        ids[i, : len(row)], labels[i, : len(row)], mask[i, : len(row)] = (
            row, d["labels"][0][:max_len], 1)
    batch = MultimodalBatch(jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(labels),
                            jnp.broadcast_to(jnp.asarray(frames[None]), (n,) + frames.shape),
                            None)
    logits, sp = videollamb_forward(chat.params, chat.cfg, batch)
    valid = sp.labels[:, 1:] != IGNORE_INDEX
    logp = jax.nn.log_softmax(logits[:, :-1].astype(jnp.float32), axis=-1)
    tok = jnp.take_along_axis(logp, jnp.where(valid, sp.labels[:, 1:], 0)[..., None], -1)[..., 0]
    return np.asarray(-jnp.sum(jnp.where(valid, tok, 0.0), 1) / jnp.maximum(valid.sum(1), 1))


@pytest.mark.parametrize("options", [["a dog runs", "nothing at all", "cats"],
                                     ["red", "blue", "green"]], ids=["phrases", "words"])
def test_likelihood_ranking_and_losses_equal_jax(models, options):
    from videollamb_torch.eval.videoqa_likelihood import (
        option_losses,
        rank_options_by_likelihood,
    )
    from videollamb_torch.train.preprocess import set_default_conversation
    from videollamb_tpu.eval.videoqa_likelihood import rank_options_by_likelihood as jax_rank
    from videollamb_tpu.train.preprocess import set_default_conversation as jax_default

    set_default_conversation("v1")
    jax_default("v1")
    jchat, pchat = _chats(models)
    frames = pchat.processors["VIDEO"](
        np.random.default_rng(3).integers(0, 255, (8, 56, 56, 3)).astype(np.uint8))
    want = _jax_losses(jchat, "what happens", options, frames)
    got = option_losses(pchat, "what happens", options, frames).numpy()
    assert got.shape == (len(options),)
    assert np.abs(got - want).max() <= LOSS_RTOL * np.abs(want).max()
    idx = rank_options_by_likelihood(pchat, "what happens", options, frames)
    assert idx == jax_rank(jchat, "what happens", options, frames) == int(np.argmin(want))


class _Judge(BaseHTTPRequestHandler):
    """A stub OpenAI-compatible chat API: a dict-string verdict per question;
    a question holding "filtered" is refused with a content_filter status."""

    def do_POST(self):
        body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        user = body["messages"][1]["content"]
        if "filtered" in user:
            self.send_response(400, "content_filter")
            self.end_headers()
            return
        score = len(user) % 6
        reply = json.dumps({"choices": [{"message": {
            "content": str({"pred": "yes" if score > 2 else "no", "score": score})}}]})
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.end_headers()
        self.wfile.write(reply.encode())

    def log_message(self, *args):
        pass


def test_acc_and_gpt_judge_equal_jax(tmp_path):
    from videollamb_torch.eval import acc, gpt_judge
    from videollamb_tpu.eval import acc as jax_acc
    from videollamb_tpu.eval import gpt_judge as jax_judge

    shards = [tmp_path / "s0.json", tmp_path / "s1.json"]
    shards[0].write_text(json.dumps({"id": 1, "question": "q1", "answer": "A", "pred": "A.",
                                     "type": "t1"}) + "\n")
    shards[1].write_text("\n".join(json.dumps(r) for r in (
        {"id": 2, "question": "q2 filtered", "answer": "B", "pred": "C", "type": "t1"},
        {"id": 3, "question": "q3", "answer": "C", "pred": "C", "type": "x2"})) + "\n\n")
    merged = acc.merge_shards([str(p) for p in shards], str(tmp_path / "m.jsonl"))
    jax_acc.merge_shards([str(p) for p in shards], str(tmp_path / "jm.jsonl"))
    assert open(merged).read() == open(tmp_path / "jm.jsonl").read()
    for mode in ("full", "first"):
        assert acc.compute_accuracy(merged, mode) == jax_acc.compute_accuracy(merged, mode)
    ws = tmp_path / "ws.jsonl"
    ws.write_text('{"a.mp4": {"global": []}}\n\n{"b.mp4": {"breakpoint": [1]}}\n')
    acc.gather_moviechat(str(ws), str(tmp_path / "g.json"))
    jax_acc.gather_moviechat(str(ws), str(tmp_path / "jg.json"))
    assert open(tmp_path / "g.json").read() == open(tmp_path / "jg.json").read()

    assert gpt_judge.JUDGE_PROMPTS == jax_judge.JUDGE_PROMPTS
    qa = {"q": "what", "a": "ans", "pred": "guess", "q2": "w2", "pred2": "g2"}
    for dim in gpt_judge.JUDGE_PROMPTS:
        assert gpt_judge.judge_messages(dim, qa) == jax_judge.judge_messages(dim, qa)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _Judge)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        out = {}
        for side, mod in (("torch", gpt_judge), ("jax", jax_judge)):
            preds = mod.load_predictions(merged)
            judged = tmp_path / f"judge_{side}"
            judged.mkdir()
            args = argparse.Namespace(dimension="default", api_key="k", model="m",
                                      api_base=f"http://127.0.0.1:{httpd.server_address[1]}/v1")
            mod.annotate((preds, list(preds), str(judged), args))
            files = {name: json.loads((judged / name).read_text())
                     for name in sorted(os.listdir(judged))}
            out[side] = (preds, files, mod.aggregate(str(judged)))
    finally:
        httpd.shutdown()
    assert out["torch"] == out["jax"]
    files = out["torch"][1]
    assert sorted(files) == ["1.json", "2.json", "3.json"]
    assert files["2.json"][0] == {"pred": "no", "score": 0}
    assert out["torch"][2]["n"] == 3


ENTRY_ARGV = {
    "videoqa_mc": ["--video_dir", "v", "--gt_file_question", "q", "--gt_file_answers", "a"],
    "videoqa": ["--video_dir", "v", "--gt_file_question", "q", "--gt_file_answers", "a"],
    "videoqa_consistency": ["--video_dir", "v", "--gt_file", "g"],
    "videoqa_moviechat": ["--video_dir", "v", "--gt_file_question", "q"],
    "videoqa_likelihood": ["--video_dir", "v", "--gt_file_question", "q",
                           "--gt_file_answers", "a"],
    "videoqa_mixed": ["--video_dir", "v", "--gt_file_question", "q", "--gt_file_answers", "a"],
    "niavh": ["--haystack_video", "h", "--needle_json", "n"],
}


@pytest.mark.parametrize("module", list(ENTRY_ARGV))
def test_eval_entry_points_default_to_the_card(module, monkeypatch, tmp_path):
    """Every eval script's parse_args takes --device (default cuda), and its entry
    point needs a card unless given --device cpu."""
    import importlib

    mod = importlib.import_module(f"videollamb_torch.eval.{module}")
    args = mod.parse_args(["--model-path", str(tmp_path), "--output_dir", str(tmp_path / "o"),
                           "--output_name", "n", *ENTRY_ARGV[module]])
    assert args.device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    entry = mod.run_pressure_test if module == "niavh" else mod.run_inference
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry(args)
