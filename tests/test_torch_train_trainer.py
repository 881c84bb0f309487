"""The port's Trainer, checkpoints and train CLI on the CPU, at
``ModelConfig.tiny`` size with dropout off: a run's logged losses against the
JAX Trainer's on the same videos, resume from the final checkpoint, resume
that decodes none of the skipped batches, preemption and SIGTERM leading to a
checkpoint, ``save_total_limit`` rotation, the adapter-only record and its
``mm_projector.bin`` (keys and values of the JAX export), the prefetcher's
bounded lookahead, and the CLI: flags equal to the JAX CLI's, a tiny
checkpoint trained with ``--device cpu``, and ``cuda`` as the default."""

from __future__ import annotations

import copy
import json
import os
import signal
import sys
import threading
import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from test_preprocess import WordTokenizer  # noqa: E402
from test_torch_parity_utils import jax_params, port_config, port_model  # noqa: E402

from videollamb_tpu.config import BridgeConfig, ModelConfig  # noqa: E402
from videollamb_torch.config import TrainConfig  # noqa: E402

CFG = ModelConfig.tiny(max_length=128, bridge=BridgeConfig(
    hidden_size=32, num_attention_heads=4, intermediate_size=64, num_memory_tokens=8,
    pool_h=2, pool_w=2, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0))
# Losses of a whole run, f32: the two packages' steps agree to about 1e-6
# relative per step (test_torch_train_step.py); three steps of Adam compound it.
RUN_LOSS_RTOL = 1e-4


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    cv2 = pytest.importorskip("cv2")
    root = tmp_path_factory.mktemp("train")
    for name in ("a.mp4", "b.mp4"):
        writer = cv2.VideoWriter(str(root / name), cv2.VideoWriter_fourcc(*"mp4v"), 30,
                                 (64, 48))
        for i in range(30):
            writer.write(np.full((48, 64, 3), ((i * 8) + (name == "b.mp4") * 90) % 255,
                                 np.uint8))
        writer.release()
    records = [{"video": name, "conversations": [
        {"from": "human", "value": "<video> what"},
        {"from": "gpt", "value": f"a gradient video {k}"}]}
        for k, name in enumerate(("a.mp4", "b.mp4") * 2)]
    records += [{"conversations": [{"from": "human", "value": "hello there"},
                                   {"from": "gpt", "value": "hi"}]}] * 2
    data_path = root / "data.json"
    data_path.write_text(json.dumps(records))
    return str(data_path), str(root)


def _dataset(videos, cls=None, tokenizer=None):
    from videollamb_torch.data.processing import VideoProcessor
    from videollamb_torch.train.dataset import DataConfig, SupervisedDataset

    data_path, root = videos
    cls = cls or SupervisedDataset
    return cls(data_path, tokenizer or WordTokenizer(),
               DataConfig(video_folder=root, num_frames=8, model_max_length=64),
               video_processor=VideoProcessor(size=CFG.vision.image_size))


def _trainer(videos, outdir, log_fn=None, dataset=None, **overrides):
    from videollamb_torch.train.dataset import Collator
    from videollamb_torch.train.trainer import Trainer

    kw = dict(per_device_batch_size=2, num_train_epochs=1, save_steps=0, logging_steps=1,
              output_dir=outdir, gradient_checkpointing=False, learning_rate=1e-3,
              warmup_ratio=0.0)
    kw.update(overrides)
    model = port_model(CFG, jax_params(CFG, seed=1))
    return Trainer(port_config(CFG), TrainConfig(**kw), model, dataset or _dataset(videos),
                   collator=Collator(bucket=16, max_length=CFG.max_length),
                   log_fn=log_fn or (lambda m: None))


def test_run_matches_jax_trainer_and_resumes(videos, tmp_path):
    from videollamb_tpu.data.processing import VideoProcessor as JaxVideoProcessor
    from videollamb_tpu.train.dataset import Collator as JaxCollator
    from videollamb_tpu.train.dataset import DataConfig as JaxDataConfig
    from videollamb_tpu.train.dataset import SupervisedDataset as JaxDataset
    from videollamb_tpu.config import TrainConfig as JaxTrainConfig
    from videollamb_tpu.train.trainer import Trainer as JaxTrainer
    from videollamb_torch.train.checkpoint import latest_checkpoint, restore_checkpoint
    from videollamb_torch.train.step import create_optimizer, create_train_state

    data_path, root = videos
    # The linear schedule with no warmup ratio is lr 0, then the peak: the same
    # whatever total the JAX Trainer derives from the CPU backend's devices.
    kw = dict(per_device_batch_size=2, num_train_epochs=1, save_steps=0, logging_steps=1,
              gradient_checkpointing=False, learning_rate=1e-3, warmup_ratio=0.0,
              lr_schedule="linear")
    jlogs = []
    # WordTokenizer numbers words as it first meets them, and the prefetch
    # threads tokenize concurrently: fill its vocabulary first, in order.
    tokenizer = WordTokenizer()
    jset = JaxDataset(data_path, tokenizer,
                      JaxDataConfig(video_folder=root, num_frames=8, model_max_length=64),
                      video_processor=JaxVideoProcessor(size=CFG.vision.image_size))
    for i in range(len(jset)):
        jset[i]
    port_set = _dataset(videos, tokenizer=copy.deepcopy(tokenizer))
    jtrainer = JaxTrainer(CFG, JaxTrainConfig(output_dir=str(tmp_path / "jax"), **kw),
                          jax.tree.map(jax.numpy.asarray, jax_params(CFG, seed=1)), jset,
                          log_fn=jlogs.append,
                          collator=JaxCollator(bucket=16, max_length=CFG.max_length))
    jtrainer.global_batch = 2  # the CPU backend shows several devices
    jtrainer.train()

    logs = []
    trainer = _trainer(videos, str(tmp_path / "port"), logs.append, dataset=port_set,
                       lr_schedule="linear")
    state = trainer.train()
    assert state.step == 3 == len(logs)
    for got, want in zip(logs, [m for m in jlogs if "loss" in m]):
        assert got["step"] == want["step"] and got["tokens"] == want["tokens"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=RUN_LOSS_RTOL)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=RUN_LOSS_RTOL)

    path = latest_checkpoint(str(tmp_path / "port"))
    assert path.endswith("checkpoint-3")
    fresh = port_model(CFG, jax_params(CFG, seed=1))
    tx = create_optimizer(trainer.train_cfg, 10, fresh)
    restored = restore_checkpoint(path, create_train_state(fresh, tx))
    assert restored.step == 3
    for (name, a), b in zip(state.model.named_parameters(), fresh.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
    assert tx.updates == trainer.tx.updates == 3
    for s1, s2 in zip(trainer.tx.adamw.state.values(), tx.adamw.state.values()):
        torch.testing.assert_close(s1["exp_avg"], s2["exp_avg"], rtol=0, atol=0)


def test_resume_decodes_no_skipped_batch(videos, tmp_path):
    from videollamb_torch.train.dataset import SupervisedDataset

    class Counting(SupervisedDataset):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.loaded = []

        def __getitem__(self, i):
            self.loaded.append(i)
            return super().__getitem__(i)

    ds = _dataset(videos, Counting)
    trainer = _trainer(videos, str(tmp_path / "ckpt"), dataset=ds)
    trainer.state.step = 1  # as if resumed from a checkpoint at step 1
    trainer.train()
    skipped = set(trainer._batch_order(0)[:2])
    assert not skipped & set(ds.loaded), (skipped, ds.loaded)
    assert trainer.state.step == 3


def test_preemption_checkpoints_and_resumes(videos, tmp_path):
    from videollamb_torch.train.checkpoint import latest_checkpoint
    from videollamb_torch.train.trainer import GracefulShutdown

    outdir = str(tmp_path / "preempt")
    shutdown = GracefulShutdown()
    logs = []

    def log(m):
        logs.append(m)
        if m.get("step") == 2 and "loss" in m:
            shutdown.request()

    trainer = _trainer(videos, outdir, log, num_train_epochs=2)
    g_after_two = None
    state = trainer.train(shutdown=shutdown)
    g_after_two = trainer.generator.get_state()
    assert state.step == 2 and any(m.get("preempted") for m in logs)
    assert latest_checkpoint(outdir).endswith("checkpoint-2")

    again = _trainer(videos, outdir, num_train_epochs=2)
    assert again.state.step == 2 and again.tx.updates == 2
    assert torch.equal(again.generator.get_state(), g_after_two)
    for a, b in zip(trainer.state.model.parameters(), again.state.model.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert again.train().step == 6


def test_sigterm_leads_to_a_checkpoint(videos, tmp_path):
    from videollamb_torch.train.checkpoint import latest_checkpoint

    outdir = str(tmp_path / "sigterm")

    def log(m):
        if m.get("step") == 1 and "loss" in m:
            os.kill(os.getpid(), signal.SIGTERM)

    before = signal.getsignal(signal.SIGTERM)
    state = _trainer(videos, outdir, log).train()
    assert state.step == 1
    assert latest_checkpoint(outdir).endswith("checkpoint-1")
    assert signal.getsignal(signal.SIGTERM) is before  # the handler is put back


def test_rotation_keeps_the_newest(tmp_path):
    from videollamb_torch.train.checkpoint import latest_checkpoint, save_checkpoint
    from videollamb_torch.train.step import create_optimizer, create_train_state

    model = port_model(CFG, jax_params(CFG, seed=2))
    state = create_train_state(model, create_optimizer(TrainConfig(tune_mode="adapter"), 10,
                                                       model))
    for step in (1, 2, 3):
        save_checkpoint(str(tmp_path), state, step=step, save_total_limit=2)
    assert sorted(os.listdir(tmp_path)) == ["checkpoint-2", "checkpoint-3"]
    assert latest_checkpoint(str(tmp_path)).endswith("checkpoint-3")
    assert latest_checkpoint(str(tmp_path / "none")) is None


def test_adapter_record_and_reference_bin_equal_jax_export(tmp_path):
    from videollamb_tpu.models.bridge.convert import export_rmt_r_state_dict
    from videollamb_torch.train.checkpoint import restore_adapter, save_checkpoint
    from videollamb_torch.train.step import create_optimizer, create_train_state

    tree = jax_params(CFG, seed=4)
    model = port_model(CFG, tree)
    state = create_train_state(model, create_optimizer(TrainConfig(tune_mode="adapter"), 10,
                                                       model))
    path = save_checkpoint(str(tmp_path), state, step=7, adapter_only=True,
                           include_embed_tokens=True)
    sd = torch.load(os.path.join(path, "mm_projector.bin"), weights_only=True)
    want = export_rmt_r_state_dict(tree["mm_projector"], prefix="model.mm_projector.")
    want["model.embed_tokens.weight"] = tree["lm"]["embed_tokens"]
    assert sorted(sd) == sorted(want)
    for key, value in want.items():
        np.testing.assert_array_equal(sd[key].numpy(), np.asarray(value), err_msg=key)

    fresh = port_model(CFG, jax_params(CFG, seed=5))
    restore_adapter(path, fresh)
    for (name, a), b in zip(model.mm_projector.named_parameters(),
                            fresh.mm_projector.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
    torch.testing.assert_close(fresh.lm.model.embed_tokens.weight,
                               model.lm.model.embed_tokens.weight, rtol=0, atol=0)


def test_reference_bin_export_raises_for_another_bridge(tmp_path):
    from videollamb_torch.train.checkpoint import export_rmt_r_state_dict

    with pytest.raises(TypeError, match="RMT-R"):
        export_rmt_r_state_dict(torch.nn.Linear(2, 2))


def test_prefetcher_bounds_lookahead_and_hands_on_errors():
    from videollamb_torch.train.trainer import Prefetcher

    calls = []
    lock = threading.Lock()

    class Counting:
        def __getitem__(self, i):
            with lock:
                calls.append(i)
            return i

    pf = Prefetcher(Counting(), list(range(64)), 1, list, num_threads=2, depth=3)
    time.sleep(0.3)
    assert len(calls) <= 3 + 2
    assert len(list(pf)) == 64 and sorted(calls) == list(range(64))

    class Broken:
        def __getitem__(self, i):
            if i == 5:
                raise OSError("unreadable sample")
            return i

    with pytest.raises(OSError, match="unreadable"):
        list(Prefetcher(Broken(), list(range(10)), 1, list, num_threads=2, depth=2))


def test_process_local_order_slices_every_global_batch():
    from videollamb_tpu.train.trainer import process_local_order as jax_order
    from videollamb_torch.train.trainer import process_local_order

    order = list(range(100, 148))
    for p in range(2):
        assert process_local_order(order, 8, 2, p) == jax_order(order, 8, 2, p)


CLI_ARGV = ["--model_name_or_path", "ckpts/llava-v1.5-7b", "--version", "v1",
            "--data_path", "data/video_image.json", "--video_folder", "data",
            "--video_tower", "ckpts/LanguageBind_Video_merge",
            "--mm_projector_type", "rmt_r_transformer1x", "--num_frames", "16",
            "--bf16", "True", "--per_device_train_batch_size", "8",
            "--learning_rate", "2e-5", "--lr_scheduler_type", "cosine",
            "--gradient_checkpointing", "True", "--output_dir", "out",
            "--lora_enable", "--lora_r", "64", "--pack_sequences"]


def test_cli_flags_equal_jax(monkeypatch):
    from videollamb_tpu.train import cli as jax_cli
    from videollamb_torch.train import cli

    monkeypatch.setattr(sys, "argv", ["prog"] + CLI_ARGV)
    want = vars(jax_cli.parse_args())
    got = vars(cli.parse_args(CLI_ARGV))
    assert got.pop("device") == "cuda"
    assert got == want


def test_cli_trains_a_tiny_checkpoint_on_the_cpu(tmp_path, monkeypatch):
    from test_torch_parity_utils import write_reference_checkpoint

    from videollamb_torch.train import cli
    from videollamb_torch.train.checkpoint import latest_checkpoint

    model_dir, tower_dir = write_reference_checkpoint(str(tmp_path), seed=1)
    records = [{"conversations": [{"from": "human", "value": f"say {w}"},
                                  {"from": "gpt", "value": f"{w} {w}"}]}
               for w in ("one", "two", "three", "four")]
    data = tmp_path / "data.json"
    data.write_text(json.dumps(records))
    argv = ["--model_name_or_path", model_dir, "--video_tower", tower_dir,
            "--data_path", str(data), "--output_dir", str(tmp_path / "out"),
            "--per_device_train_batch_size", "2", "--bf16", "False",
            "--tune_mm_mlp_adapter", "--learning_rate", "1e-3", "--device", "cpu",
            "--model_max_length", "64"]
    logs = []
    state = cli.main(argv, tokenizer=WordTokenizer(), log_fn=logs.append)
    assert state.step == 2 and all(np.isfinite(m["loss"]) for m in logs if "loss" in m)
    path = latest_checkpoint(str(tmp_path / "out"))
    assert os.path.exists(os.path.join(path, "mm_projector.bin"))

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main([a for a in argv if a not in ("--device", "cpu")], tokenizer=WordTokenizer())
    with pytest.raises(ValueError, match="need as many ranks"):
        cli.main(argv + ["--sequence_parallel", "2"], tokenizer=WordTokenizer())


def test_loader_starts_a_seeded_projector_only_when_asked(tmp_path):
    """A base LM without a projector (stage 1's start) loads with a seeded new
    bridge under ``bridge_seed`` and fails to load without it."""
    from test_torch_parity_utils import write_reference_checkpoint

    from videollamb_torch.models.builder import load_pretrained_model

    model_dir, tower_dir = write_reference_checkpoint(str(tmp_path), seed=2)
    path = os.path.join(model_dir, "pytorch_model.bin")
    sd = torch.load(path, weights_only=True)
    torch.save({k: v for k, v in sd.items() if "mm_projector" not in k}, path)
    kw = dict(video_tower_path=tower_dir, dtype="float32", load_tokenizer=False, device="cpu")
    with pytest.raises(RuntimeError, match="Missing key"):
        load_pretrained_model(model_dir, **kw)
    _, a, _, _, _ = load_pretrained_model(model_dir, bridge_seed=5, **kw)
    _, b, _, _, _ = load_pretrained_model(model_dir, bridge_seed=5, **kw)
    for x, y in zip(a.mm_projector.parameters(), b.mm_projector.parameters()):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert float(a.mm_projector.projector.proj[0].weight.abs().sum()) > 0


def test_cli_builds_the_flagged_projector_on_a_base_lm(tmp_path, monkeypatch):
    """A checkpoint without a projector: the CLI's seeded bridge and its model
    config follow ``--mm_projector_type`` (2 layers here, where config.json
    says nothing), with the parameter names and shapes of JAX's
    ``init_bridge_params`` tree for the same flag."""
    from test_torch_parity_utils import np_tree, write_reference_checkpoint

    from videollamb_tpu.models.bridge.builder import init_bridge_params
    from videollamb_torch.models.convert import from_jax_params
    from videollamb_torch.train import cli
    from videollamb_torch.train import trainer as trainer_mod

    model_dir, tower_dir = write_reference_checkpoint(str(tmp_path), seed=1)
    path = os.path.join(model_dir, "pytorch_model.bin")
    sd = torch.load(path, weights_only=True)
    torch.save({k: v for k, v in sd.items() if "mm_projector" not in k}, path)
    with open(os.path.join(model_dir, "config.json")) as f:
        raw = json.load(f)
    raw.pop("mm_projector_type")
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(raw, f)
    data = tmp_path / "data.json"
    data.write_text(json.dumps([{"conversations": [{"from": "human", "value": "say one"},
                                                   {"from": "gpt", "value": "one"}]}]))
    built = {}
    monkeypatch.setattr(trainer_mod.Trainer, "train", lambda self: built.setdefault("t", self))
    cli.main(["--model_name_or_path", model_dir, "--video_tower", tower_dir,
              "--data_path", str(data), "--output_dir", str(tmp_path / "out"),
              "--bf16", "False", "--tune_mm_mlp_adapter", "--device", "cpu",
              "--mm_projector_type", "rmt_r_transformer2x"], tokenizer=WordTokenizer())
    trainer = built["t"]
    flag = BridgeConfig.from_projector_type("rmt_r_transformer2x", hidden_size=32)
    assert trainer.model_cfg.bridge.depth == flag.depth == 2
    tree = np_tree(init_bridge_params(jax.random.PRNGKey(0), flag, 64))
    want = {k: tuple(v.shape) for k, v in from_jax_params({"mm_projector": tree}).items()}
    got = {f"mm_projector.{k}": tuple(v.shape)
           for k, v in trainer.state.model.mm_projector.state_dict().items()}
    assert got == want
    assert any(".layers.1." in k for k in got)
