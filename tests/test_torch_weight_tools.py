"""The port's weight tools (``tools/weights.py``) and utilities
(``utils/{logging,profiling}.py``) against the JAX package's, on the CPU.

One seeded reference-format checkpoint (``write_reference_checkpoint``) feeds
both packages' CLIs; their outputs must hold the same names and equal
tensors (float32: the JAX tools read every tensor as float32, the port keeps
the stored dtype, which here is float32). The delta tools must invert each
other exactly and equal JAX's on the same arrays; ``export_hf_checkpoint``
of the port's model equals JAX's export of the same weights and loads back
through the port's loader.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from test_torch_parity_utils import write_reference_checkpoint  # noqa: E402

from videollamb_torch.tools import weights as pw  # noqa: E402
from videollamb_tpu.tools import weights as jw  # noqa: E402


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    return write_reference_checkpoint(str(tmp_path_factory.mktemp("ckpt")), seed=3)


def _jax_cli(monkeypatch, fn, argv):
    monkeypatch.setattr(sys, "argv", ["prog", *argv])
    fn()


def _equal_files(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k], np.float32), np.asarray(b[k], np.float32),
                                      err_msg=k)


def test_delta_round_trip_equal_jax():
    rng = np.random.default_rng(0)
    base = {"model.embed_tokens.weight": rng.normal(size=(10, 4)).astype(np.float32),
            "model.norm.weight": rng.normal(size=(4,)).astype(np.float32),
            "nested": {"w": rng.normal(size=(3, 3)).astype(np.float32)}}
    target = {"model.embed_tokens.weight": rng.normal(size=(12, 4)).astype(np.float32),
              "model.norm.weight": rng.normal(size=(4,)).astype(np.float32),
              "nested": {"w": rng.normal(size=(3, 3)).astype(np.float32)}}
    delta = pw.make_delta(base, target)
    jdelta = jw.make_delta(base, target)
    back = pw.apply_delta(base, delta)
    jback = jw.apply_delta(base, jdelta)
    for k in ("model.embed_tokens.weight", "model.norm.weight"):
        np.testing.assert_array_equal(delta[k].numpy(), jdelta[k])
        np.testing.assert_array_equal(back[k].numpy(), jback[k])
        np.testing.assert_allclose(back[k].numpy(), target[k], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(back["nested"]["w"].numpy(), jback["nested"]["w"])


def test_extract_projector_and_consolidate_clis_equal_jax(checkpoint, tmp_path, monkeypatch):
    model_dir, _ = checkpoint
    pw.extract_projector_cli(["--model-path", model_dir, "--output", str(tmp_path / "p.bin")])
    _jax_cli(monkeypatch, jw.extract_projector_cli,
             ["--model-path", model_dir, "--output", str(tmp_path / "j.bin")])
    ours = torch.load(tmp_path / "p.bin", weights_only=True)
    assert ours and all("mm_projector" in k for k in ours)
    _equal_files(ours, torch.load(tmp_path / "j.bin", weights_only=True))

    pw.consolidate_cli(["--src", model_dir, "--dst", str(tmp_path / "p.npz")])
    _jax_cli(monkeypatch, jw.consolidate_cli, ["--src", model_dir, "--dst", str(tmp_path / "j.npz")])
    _equal_files(dict(np.load(tmp_path / "p.npz")), dict(np.load(tmp_path / "j.npz")))


def test_merge_lora_cli_equal_jax(checkpoint, tmp_path, monkeypatch):
    model_dir, _ = checkpoint
    base = torch.load(os.path.join(model_dir, "pytorch_model.bin"), weights_only=True)
    lora_dir = tmp_path / "lora"
    lora_dir.mkdir()
    rng = np.random.default_rng(1)
    lora = {}
    for i in range(2):
        for name in ("self_attn.q_proj", "mlp.down_proj"):
            w = base[f"model.layers.{i}.{name}.weight"]
            pre = f"base_model.model.model.layers.{i}.{name}"
            lora[pre + ".lora_A.weight"] = torch.from_numpy(
                rng.normal(size=(4, w.shape[1])).astype(np.float32))
            lora[pre + ".lora_B.weight"] = torch.from_numpy(
                rng.normal(size=(w.shape[0], 4)).astype(np.float32))
    from safetensors.torch import save_file

    save_file(lora, str(lora_dir / "adapter_model.safetensors"))  # PEFT's file name
    (lora_dir / "adapter_config.json").write_text(json.dumps({"r": 4, "lora_alpha": 8}))
    pw.merge_lora_cli(["--model-path", str(lora_dir), "--model-base", model_dir,
                       "--save-model-path", str(tmp_path / "p")])
    _jax_cli(monkeypatch, jw.merge_lora_cli, ["--model-path", str(lora_dir), "--model-base",
                                              model_dir, "--save-model-path", str(tmp_path / "j")])
    ours = torch.load(tmp_path / "p" / "pytorch_model.bin", weights_only=True)
    _equal_files(ours, torch.load(tmp_path / "j" / "pytorch_model.bin", weights_only=True))
    assert (tmp_path / "p" / "config.json").exists()
    key = "model.layers.0.self_attn.q_proj.weight"
    assert (ours[key] - base[key]).abs().max() > 0  # the adapter merged


def test_export_hf_checkpoint_equal_jax_and_loads_back(checkpoint, tmp_path):
    from test_torch_parity_utils import load_both

    from videollamb_torch.models.builder import load_pretrained_model

    model_dir, tower_dir = checkpoint
    params, _, model, _ = load_both(model_dir, tower_dir)
    path = pw.export_hf_checkpoint(model, str(tmp_path / "p"))
    jpath = jw.export_hf_checkpoint(params, str(tmp_path / "j"))
    ours = torch.load(path, weights_only=True)
    _equal_files(ours, torch.load(jpath, weights_only=True))
    with open(os.path.join(model_dir, "config.json")) as f:
        (tmp_path / "p" / "config.json").write_text(f.read())
    _, back, _, _, _ = load_pretrained_model(str(tmp_path / "p"), video_tower_path=tower_dir,
                                             dtype="float32", load_tokenizer=False, device="cpu")
    want = model.state_dict()
    for k, v in back.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0, msg=k)


def test_export_refuses_adapters(checkpoint, tmp_path):
    from test_torch_parity_utils import load_both

    from videollamb_torch.models.lm.lora import add_lora_params

    params, _, model, cfg = load_both(*checkpoint)
    add_lora_params(model.lm, cfg.lm, r=2, alpha=4, generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="merge adapters"):
        pw.export_hf_checkpoint(model, str(tmp_path / "x"))


def test_stage_timer_profile_trace_and_logging(tmp_path, capsys):
    """The logging helpers, and the span recorder that replaced the stage
    timer and the trace helper: nested spans and their aggregates, and the
    spans as host ops in a profiler's Chrome trace."""
    from videollamb_torch.utils import logging as plog
    from videollamb_torch.utils.profiling import BUCKETS, Recorder

    rec = Recorder()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            with rec.span("encode", uid=7):
                with rec.span("decode"):
                    torch.ones(8) @ torch.ones(8)
    encode = [r for r in rec.records() if r.name == "encode"]
    decode = [r for r in rec.records() if r.name == "decode"]
    assert len(encode) == len(decode) == 2
    assert all(d.parent == e.id and d.uid == 7 and e.t0 <= d.t0 <= d.t1 <= e.t1
               for e, d in zip(encode, decode))
    agg = rec.aggregates()
    assert agg["encode"].count == 2 and len(agg["encode"].buckets) == len(BUCKETS) + 1
    assert agg["encode"].total >= agg["decode"].total > 0
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert {e.get("cat") for e in events if e.get("name") in ("encode", "decode")} == {"cpu_op"}

    plog.rank0_print("hello rank0")
    assert "hello rank0" in capsys.readouterr().out
    assert plog.pretty_print_semaphore(None) == "None"
