"""The port's NIAVH pressure test against the JAX package's, on the CPU.

``run_pressure_test`` of ``videollamb_torch.eval.niavh`` and of
``videollamb_tpu.eval.niavh`` run on one seeded ``ModelConfig.tiny`` model in
f32 over one cv2-written 64-frame 48 x 48 haystack and a 6-frame needle
clip, in ``full`` mode (the whole clip through ``Chat``) and ``streaming``
mode (a ``StreamingSession`` tick per frame, the question before the last
one), greedy with 4 new tokens: the JSONL records and the ``_grid.json``
summary must be equal. The numpy helpers (``sample_indices``,
``insert_needle``, ``score_pred``, ``summarize``) must give JAX's results.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("cv2")

from test_torch_eval import _chats, _lines, _write_clip, models  # noqa: E402,F401


def _write_haystack(root):
    _write_clip(root / "haystack.mp4", 64, seed=0, size=(48, 48))
    _write_clip(root / "needle.mp4", 6, seed=1, size=(48, 48), value=250)
    (root / "needles.json").write_text(json.dumps([
        {"needle": str(root / "needle.mp4"), "question": "what was the secret word",
         "answer": "banana"}]))


@pytest.mark.parametrize("mode", ["full", "streaming"])
def test_niavh_records_and_grid_equal_jax(models, tmp_path, mode):
    import videollamb_torch.eval.niavh as port_niavh
    import videollamb_tpu.eval.niavh as jax_niavh

    _write_haystack(tmp_path)
    jchat, pchat = _chats(models)
    out = {}
    for side, mod, chat in (("torch", port_niavh, pchat), ("jax", jax_niavh, jchat)):
        args = argparse.Namespace(
            haystack_video=str(tmp_path / "haystack.mp4"),
            needle_json=str(tmp_path / "needles.json"),
            # The full route encodes whole clips: lengths are multiples of the
            # tower's 8-frame window; the stream folds any length.
            lengths="8,16" if mode == "full" else "6,8", depths="0.0,1.0",
            needle_frames=2, mode=mode, stream_open_frames=4, stream_seq_len=512,
            output_dir=str(tmp_path / side), output_name="niavh", max_new_tokens=4,
            temperature=0.0)
        summary = mod.run_pressure_test(args, chat=chat)
        with open(tmp_path / side / "niavh_grid.json") as f:
            grid = json.load(f)
        records = _lines(summary.pop("records"))
        assert grid.pop("records") == str(tmp_path / side / "niavh.jsonl")
        out[side] = (records, summary, grid)
    assert out["torch"] == out["jax"]
    assert out["torch"][1]["n"] == 4 and all(r["pred"] for r in out["torch"][0])


def test_niavh_helpers_equal_jax():
    from videollamb_torch.eval import niavh
    from videollamb_tpu.eval import niavh as jax_niavh

    rng = np.random.default_rng(2)
    hay = rng.integers(0, 255, (40, 24, 24, 3)).astype(np.uint8)
    ndl = rng.integers(0, 255, (3, 20, 20, 3)).astype(np.uint8)
    for total, want in ((5, 8), (100, 10), (64, 64)):
        np.testing.assert_array_equal(niavh.sample_indices(total, want),
                                      jax_niavh.sample_indices(total, want))
    for depth in (0.0, 0.3, 1.0):
        got, start = niavh.insert_needle(hay, ndl, 16, depth)
        ref, ref_start = jax_niavh.insert_needle(hay, ndl, 16, depth)
        np.testing.assert_array_equal(got, ref)
        assert start == ref_start
    with pytest.raises(ValueError):
        niavh.insert_needle(hay, ndl, 3, 0.5)
    for pred, ans in (("The secret WORD is: banana!", "banana"), ("red\ncar", "red car"),
                      ("apple", "banana")):
        assert niavh.score_pred(pred, ans) == jax_niavh.score_pred(pred, ans)
    recs = [{"length": 32, "depth": 0.0, "correct": True},
            {"length": 32, "depth": 0.0, "correct": False},
            {"length": 64, "depth": 1.0, "correct": True}]
    assert niavh.summarize(recs) == jax_niavh.summarize(recs)
