"""The port's multi-turn chat with KV reuse (``KVChatSession``, ``--kv-reuse``),
on the CPU in f32.

- Each turn's answer equals the port's full re-prefill
  (``Chat.ask_about_video`` turn by turn) and JAX's ``KVChatSession``; the
  second turn extends the cache instead of prefilling, and a cache whose ids
  are no prefix of the new prompt falls back to a full prefill.
- ``speculative=True`` (prompt lookup over the session cache) gives the plain
  session's answers and JAX's.
- ``serve/cli.py --kv-reuse --device cpu`` answers two turns through the
  session, as the CLI without it does.

Greedy tokens in f32 on both sides, so answers are compared exactly.
"""

from __future__ import annotations

import builtins

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from test_serving import ChatTokenizer  # noqa: E402
from test_torch_parity_utils import (  # noqa: E402
    jax_params,
    port_config,
    port_model,
    tiny_tokenizer,
    write_reference_checkpoint,
)

from videollamb_tpu.config import ModelConfig  # noqa: E402
from videollamb_tpu.data.processing import VideoProcessor  # noqa: E402

CFG = ModelConfig.tiny(max_length=128)
SYSTEM = "A chat between a curious human and an artificial intelligence assistant"
QUESTIONS = ["what is shown", "and then"]
MAX_NEW = 6


@pytest.fixture(scope="module")
def models():
    tree = jax_params(CFG)
    return tree, port_model(CFG, tree)


@pytest.fixture(scope="module")
def frames():
    raw = np.random.default_rng(0).integers(0, 255, size=(8, 56, 56, 3)).astype(np.uint8)
    return VideoProcessor(size=CFG.vision.image_size)(raw)


class RoundTripTokenizer(ChatTokenizer):
    """``ChatTokenizer`` whose decoded ``tok<id>`` words encode back to <id>:
    an answer re-tokenizes to the ids that produced it, so the cached ids stay
    a prefix of the next turn's prompt."""

    def _id(self, w):
        if w.startswith("tok") and w[3:].isdigit():
            return int(w[3:])
        return super()._id(w)


def _chat(models, jax_side=False):
    from videollamb_tpu.serve.chat import Chat as JaxChat
    from videollamb_torch.serve.chat import Chat

    tree, model = models
    tok = RoundTripTokenizer()
    tok(SYSTEM)
    proc = {"VIDEO": VideoProcessor(size=CFG.vision.image_size)}
    if jax_side:
        return JaxChat(tok, tree, CFG, proc, text_bucket=32)
    return Chat(tok, model, port_config(CFG), proc, text_bucket=32)


def _session_answers(session, frames, **kw):
    return [session.ask(q, frames if i == 0 else None, **kw) for i, q in enumerate(QUESTIONS)]


@pytest.fixture(scope="module")
def reprefill(models, frames):
    """The port's answers by full re-prefill, turn by turn."""
    chat = _chat(models)
    return [chat.ask_about_video(q, frames, first_turn=i == 0, max_new_tokens=MAX_NEW,
                                 do_sample=False, temperature=0.0)
            for i, q in enumerate(QUESTIONS)]


@pytest.mark.parametrize("speculative", [False, True], ids=["greedy", "lookup"])
def test_kv_chat_session_equals_reprefill_and_jax(models, frames, reprefill, speculative):
    from videollamb_tpu.serve.chat import KVChatSession as JaxSession
    from videollamb_torch.serve.chat import KVChatSession

    session = KVChatSession(_chat(models), max_new_tokens=MAX_NEW)
    got = _session_answers(session, frames, speculative=speculative)
    want = _session_answers(JaxSession(_chat(models, jax_side=True), max_new_tokens=MAX_NEW),
                            frames, speculative=speculative)
    assert got == want == reprefill and all(got)
    assert (session.full_prefills, session.extends) == (1, 1)


def test_kv_chat_session_falls_back_to_a_full_prefill(models, frames, reprefill):
    from videollamb_torch.serve.chat import KVChatSession

    session = KVChatSession(_chat(models), max_new_tokens=MAX_NEW)
    session.ask(QUESTIONS[0], frames)
    session.cached_ids[0] = -999  # no longer a prefix of the next prompt
    assert session.ask(QUESTIONS[1]) == reprefill[1]
    assert (session.full_prefills, session.extends) == (2, 0)
    with pytest.raises(ValueError, match="needs frames"):
        KVChatSession(_chat(models)).ask("what is shown")


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    model_dir, tower_dir = write_reference_checkpoint(str(tmp_path_factory.mktemp("ckpt")),
                                                      seed=3)
    tiny_tokenizer(model_dir)
    return model_dir, tower_dir


def _frame_dir(tmp_path):
    import cv2

    d = tmp_path / "vid"
    d.mkdir(exist_ok=True)
    rng = np.random.default_rng(0)
    for i in range(4):
        cv2.imwrite(str(d / f"{i:04d}.jpg"), rng.integers(0, 255, (64, 80, 3)).astype(np.uint8))
    return str(d)


def test_cli_kv_reuse_answers_two_turns(checkpoint, tmp_path, monkeypatch, capsys):
    from videollamb_torch.serve import chat as chat_mod
    from videollamb_torch.serve import cli

    model_dir, tower_dir = checkpoint
    video = _frame_dir(tmp_path)
    asked = []
    ask = chat_mod.KVChatSession.ask
    monkeypatch.setattr(chat_mod.KVChatSession, "ask",
                        lambda self, *a, **kw: asked.append(a) or ask(self, *a, **kw))

    def run(*flags):
        questions = iter(["what is happening in this video", "describe it", ""])
        monkeypatch.setattr(builtins, "input", lambda prompt="": next(questions))
        cli.main(cli.parse_args(["--model-path", model_dir, "--video-tower", tower_dir,
                                 "--video-file", video, "--device", "cpu", "--fp32",
                                 "--temperature", "0", "--max-new-tokens", "6", *flags]))
        return capsys.readouterr().out

    plain = run()
    assert not asked
    reused = run("--kv-reuse")
    assert reused == plain and plain.count("ASSISTANT: ") == 2
    assert [a[0] for a in asked] == ["what is happening in this video", "describe it"]
    assert asked[0][1] is not None and asked[1][1] is None  # frames on the first turn only
