"""The port's train CLI with ``--model_parallel 2`` and
``--sequence_parallel 2`` on two gloo ranks (``--device cpu``), against the
port's single-process CLI on the same seeded reference-format checkpoint
(written with the port's ``export_hf_checkpoint``) and data
(tests/test_torch_train_trainer.py holds that CLI to the JAX package): two
logged steps of the full recipe, a video row then a text row, losses within
1e-5 relative (the ranks sum in other orders), the same token counts, a
checkpoint that rank 0 wrote, and a rerun that resumes from it. Also the
checkpoint's gather of a sharded tensor, whose host copy only rank 0 keeps.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

import test_torch_dist_utils as du  # noqa: E402

LOSS_RTOL = 1e-5


def _checkpoint(root):
    """A seeded reference-format checkpoint of ``checkpoint_config()``:
    (model dir, tower dir)."""
    from test_torch_parity_utils import checkpoint_config, port_config

    from videollamb_torch.models.assembly import VideoLLaMB
    from videollamb_torch.models.bridge.builder import init_bridge_params
    from videollamb_torch.models.lm.llama import init_llama_params
    from videollamb_torch.models.vision.clip_vit import init_vision_params
    from videollamb_torch.tools.weights import export_hf_checkpoint

    cfg = port_config(checkpoint_config())
    tower = init_vision_params(cfg.vision, seed=2)
    model = VideoLLaMB(tower, init_bridge_params(cfg.bridge, cfg.lm.hidden_size, seed=3),
                       init_llama_params(cfg.lm, seed=4))
    model_dir, tower_dir = root / "checkpoint", root / "tower"
    export_hf_checkpoint(model, str(model_dir))
    tower_dir.mkdir()
    torch.save(tower.state_dict(), tower_dir / "pytorch_model.bin")
    lm, v = cfg.lm, cfg.vision
    (model_dir / "config.json").write_text(json.dumps({
        "vocab_size": lm.vocab_size, "hidden_size": lm.hidden_size,
        "intermediate_size": lm.intermediate_size, "num_hidden_layers": lm.num_hidden_layers,
        "num_attention_heads": lm.num_attention_heads,
        "num_key_value_heads": lm.num_key_value_heads, "mm_projector_type": "rmt_r_transformer1x",
        "mm_hidden_size": v.hidden_size, "mm_vision_select_layer": -2, "num_frames": 8,
        "tokenizer_model_max_length": 2048}))
    (tower_dir / "config.json").write_text(json.dumps({"vision_config": {
        "hidden_size": v.hidden_size, "intermediate_size": v.intermediate_size,
        "num_hidden_layers": v.num_hidden_layers, "num_attention_heads": v.num_attention_heads,
        "image_size": v.image_size, "patch_size": v.patch_size, "num_frames": v.num_frames,
        "add_time_attn": True, "hidden_act": "quick_gelu"}}))
    return str(model_dir), str(tower_dir)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from videollamb_torch.train.cli import main

    root = tmp_path_factory.mktemp("cli")
    model_dir, tower_dir = _checkpoint(root)
    writer = cv2.VideoWriter(str(root / "a.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 30, (64, 48))
    for i in range(16):
        writer.write(np.full((48, 64, 3), (i * 12) % 255, np.uint8))
    writer.release()
    records = [{"video": "a.mp4", "conversations": [
        {"from": "human", "value": "<video> what"}, {"from": "gpt", "value": "a clip"}]},
        {"conversations": [{"from": "human", "value": "say one"},
                           {"from": "gpt", "value": "one one"}]}]
    data = root / "data.json"
    data.write_text(json.dumps(records))
    argv = ["--model_name_or_path", model_dir, "--video_tower", tower_dir,
            "--data_path", str(data), "--video_folder", str(root),
            "--per_device_train_batch_size", "1", "--bf16", "False", "--num_frames", "8",
            "--learning_rate", "1e-3", "--device", "cpu", "--model_max_length", "160"]
    out_dir = str(root / "ranks")
    os.makedirs(out_dir)
    ctx = du.start_ranks(2, {"tasks": ["train_cli", "writer_host"], "cli_argv": argv,
                             "cli_out": out_dir}, out_dir)
    try:
        logs = []
        main(argv + ["--output_dir", str(root / "single")], tokenizer=du.WordTokenizer(),
             log_fn=logs.append)
    finally:
        results = du.join_ranks(ctx, out_dir, 2)
    return [m for m in logs if "loss" in m], results, out_dir


@pytest.mark.parametrize("flag", ["--model_parallel", "--sequence_parallel"])
def test_parallel_cli_logs_the_single_process_losses(runs, flag):
    from videollamb_torch.train.checkpoint import latest_checkpoint

    single, results, out_dir = runs
    assert len(single) == 2
    for rank in range(2):
        logs = du.result(results, "train_cli", rank)[flag]
        assert [m["step"] for m in logs] == [m["step"] for m in single]
        assert [m["tokens"] for m in logs] == [m["tokens"] for m in single]
        np.testing.assert_allclose([m["loss"] for m in logs], [m["loss"] for m in single],
                                   rtol=LOSS_RTOL)
        # The rerun restored the final step from rank 0's checkpoint.
        assert du.result(results, "train_cli", rank)[flag + " resumed"] == (2, 0)
    assert latest_checkpoint(os.path.join(out_dir, flag.strip("-"))) is not None


def test_checkpoint_host_copy_on_the_writer_only(runs):
    """Saving a sharded state, rank 0 holds the gathered host copy and rank 1
    none: one copy of the weights and moments in host memory, not one a rank."""
    _, results, _ = runs
    np.testing.assert_array_equal(du.result(results, "writer_host", 0),
                                  np.arange(24, dtype=np.float32).reshape(6, 4))
    assert du.result(results, "writer_host", 1) is None
