"""Seeded reference-format checkpoints of the LM families, loaded by both
packages' ``load_pretrained_model`` on the CPU in f32: a ``model_type:
mistral`` one whose window (64) bites on a 1190-token video prompt, and a
``rope_scaling`` llama3 one. Greedy ``generate`` tokens equal the JAX
package's, and ``batch_cli.main`` (dense engine) answers as the JAX batch
CLI's functions over the JAX engine do.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from test_torch_parity_utils import (  # noqa: E402
    load_both,
    tiny_tokenizer,
    video_rows,
    write_reference_checkpoint,
)


def _t(x):
    return torch.from_numpy(np.asarray(x))


VARIANTS = {
    "mistral": {"model_type": "mistral", "sliding_window": 64},
    "rope_llama3": {"rope_scaling": {"rope_type": "llama3", "factor": 8.0,
                                     "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                                     "original_max_position_embeddings": 256}},
}


@pytest.fixture(scope="module", params=list(VARIANTS))
def variant_checkpoint(request, tmp_path_factory):
    model_dir, tower_dir = write_reference_checkpoint(
        str(tmp_path_factory.mktemp(request.param)), seed=4)
    path = os.path.join(model_dir, "config.json")
    with open(path) as f:
        raw = json.load(f)
    raw.update(VARIANTS[request.param])
    with open(path, "w") as f:
        json.dump(raw, f)
    return request.param, model_dir, tower_dir


def test_checkpoint_greedy_tokens_equal_jax(variant_checkpoint):
    """A 38-token prompt around an 8-frame video (1152 bridge tokens): the
    window of 64 bites from the prompt's 65th token on; llama3 scaling moves
    every long wavelength."""
    from videollamb_tpu.models.assembly import MultimodalBatch as JBatch
    from videollamb_tpu.models.engine import generate as jax_generate
    from videollamb_torch.models.assembly import MultimodalBatch
    from videollamb_torch.models.engine import generate

    name, model_dir, tower_dir = variant_checkpoint
    params, jcfg, model, cfg = load_both(model_dir, tower_dir)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    if name == "mistral":
        assert cfg.lm.sliding_window == 64
    else:
        assert cfg.lm.rope_scaling.rope_type == "llama3"
    rows = video_rows(cfg, [7, 8], text_len=38, frames=8)
    ids = np.concatenate([r[0] for r in rows])
    mask = np.concatenate([r[1] for r in rows])
    mask[1, 30:] = 0
    videos = np.concatenate([rows[0][2], rows[0][2][:, ::-1].copy()])
    ref = jax_generate(params, jcfg, JBatch(jnp.asarray(ids), jnp.asarray(mask), None,
                                            jnp.asarray(videos), None),
                       jax.random.PRNGKey(0), max_new_tokens=6, do_sample=False,
                       max_seq_len=cfg.max_length + 64)
    out = generate(model, cfg, MultimodalBatch(_t(ids).long(), _t(mask).long(), None,
                                               _t(videos)),
                   max_new_tokens=6, do_sample=False, max_seq_len=cfg.max_length + 64)
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(out.lengths.numpy(), np.asarray(ref.lengths))


def test_batch_cli_answers_equal_jax(variant_checkpoint, tmp_path):
    """``batch_cli.main`` (dense engine, f32) on the checkpoint: the JAX batch
    CLI's functions over the JAX engine give the same answers."""
    import cv2

    from videollamb_torch.serve import batch_cli
    from videollamb_tpu.models.builder import load_pretrained_model as jax_load
    from videollamb_tpu.serve import batch_cli as jax_batch_cli
    from videollamb_tpu.serve.chat import Chat as JaxChat
    from videollamb_tpu.serve.server import ServingEngine as JaxEngine

    _, model_dir, tower_dir = variant_checkpoint
    tiny_tokenizer(model_dir)
    frames = tmp_path / "vid"
    frames.mkdir()
    rng = np.random.default_rng(0)
    for i in range(4):
        cv2.imwrite(str(frames / f"{i:04d}.jpg"), rng.integers(0, 255, (64, 80, 3)).astype(np.uint8))
    lines = [{"id": "a", "prompt": "what is happening in this video", "video": str(frames),
              "max_new_tokens": 5},
             {"id": "b", "prompt": "describe it " * 12, "max_new_tokens": 4}]
    src, dst = tmp_path / "in.jsonl", tmp_path / "out.jsonl"
    src.write_text("".join(json.dumps(row) + "\n" for row in lines))
    batch_cli.main(["--model-path", model_dir, "--video-tower", tower_dir, "--requests",
                    str(src), "--output", str(dst), "--device", "cpu", "--fp32",
                    "--num-slots", "2", "--sync-every", "3"])
    got = {r["id"]: r for r in map(json.loads, dst.read_text().splitlines())}

    tok, params, jcfg, procs, _ = jax_load(model_dir, video_tower_path=tower_dir,
                                           dtype="float32")
    jchat = JaxChat(tok, params, dataclasses.replace(jcfg, dtype="float32"), procs)
    want = {r["id"]: r for r in jax_batch_cli.serve_requests(
        JaxEngine(params, jchat.cfg, num_slots=2, eos_token_id=int(tok.eos_token_id)),
        jax_batch_cli.build_requests(lines, jchat), tok, k=3)}
    assert {k: (v["text"], v["tokens"]) for k, v in got.items()} == {
        k: (v["text"], v["tokens"]) for k, v in want.items()}
