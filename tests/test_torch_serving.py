"""The port's dense serving engine and batch CLI, on the CPU, on the seeded
tiny reference-format checkpoint in f32.

- ``ServingEngine`` (dense per-slot cache rows) gives the greedy tokens of
  ``videollamb_tpu.serve.server.ServingEngine`` on three video requests on
  two slots.
- ``batch_cli.main`` end to end with a tiny tokenizer: JSONL in, the paged
  int8 and the dense engines, JSONL out; the two engines agree.
- Row fields and options the port does not serve yet are refused with an
  error that names them.
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


@pytest.mark.parametrize("field,value", [
    ("shared_prefix", True), ("choices", ["A", "B"]), ("response_format", "json_object"),
    ("logit_bias", {"5": 1.0}), ("presence_penalty", 0.5), ("min_tokens", 2), ("top_k", 5),
    ("logprobs", True), ("adapter", "x"), ("image", "x.png"), ("audio", "x.wav"),
])
def test_batch_cli_refuses_unported_row_fields(field, value):
    from videollamb_torch.serve.batch_cli import build_requests

    with pytest.raises(ValueError, match=f"'{field}'.*not supported by the PyTorch port"):
        build_requests([{"id": 1, "prompt": "hi", field: value}], chat=None)


@pytest.mark.parametrize("flag", ["--device-preprocess"])
def test_batch_cli_refuses_unported_flags(flag, tmp_path):
    from videollamb_torch.serve import batch_cli

    with pytest.raises(SystemExit, match=f"{flag} is not supported by the PyTorch port"):
        batch_cli.main(["--model-path", "unused", "--requests", "in", "--output", "out", flag])
