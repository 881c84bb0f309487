"""The port's main path end to end against the JAX package, on the CPU.

A seeded reference-format checkpoint (model dir + LanguageBind tower dir)
is loaded by both packages' ``load_pretrained_model``; greedy ``generate``
must give the same tokens, token for token, in f32. Also: the port's
``Chat.ask_about_video`` with a tiny tokenizer, the CLI's image flags
against the JAX CLI, and that no port module imports jax.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from test_torch_parity_utils import REPO, tiny_tokenizer, write_reference_checkpoint  # noqa: E402

from videollamb_tpu.constants import VIDEO_TOKEN_INDEX  # noqa: E402

MAX_NEW = 8


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    return write_reference_checkpoint(str(tmp_path_factory.mktemp("ckpt")), seed=3)


def _inputs(cfg, prompt_lens, frames=16, seed=0):
    rng = np.random.default_rng(seed)
    b, t = len(prompt_lens), max(prompt_lens)
    ids = rng.integers(4, cfg.lm.vocab_size, size=(b, t)).astype(np.int32)
    ids[:, 2] = VIDEO_TOKEN_INDEX
    mask = (np.arange(t)[None] < np.asarray(prompt_lens)[:, None]).astype(np.int32)
    img = cfg.vision.image_size
    videos = rng.normal(size=(b, frames, 3, img, img)).astype(np.float32)
    return ids, mask, videos


@pytest.mark.parametrize("prompt_lens", [[40], [40, 27]], ids=["b1", "b2_ragged"])
def test_greedy_tokens_equal_jax(checkpoint, prompt_lens):
    import jax.numpy as jnp

    from videollamb_tpu.models.assembly import MultimodalBatch as JBatch
    from videollamb_tpu.models.builder import load_pretrained_model as jax_load
    from videollamb_tpu.models.engine import generate as jax_generate
    from videollamb_torch.models.assembly import MultimodalBatch
    from videollamb_torch.models.builder import load_pretrained_model
    from videollamb_torch.models.engine import generate

    model_dir, tower_dir = checkpoint
    _, params, jcfg, _, _ = jax_load(model_dir, video_tower_path=tower_dir,
                                     dtype="float32", load_tokenizer=False)
    _, model, cfg, _, ctx = load_pretrained_model(
        model_dir, video_tower_path=tower_dir, dtype="float32", load_tokenizer=False,
        device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert ctx == cfg.max_length == 2048
    ids, mask, videos = _inputs(cfg, prompt_lens)
    max_seq = cfg.max_length + 64

    ref = jax_generate(params, jcfg, JBatch(jnp.asarray(ids), jnp.asarray(mask), None,
                                            jnp.asarray(videos), None),
                       jax.random.PRNGKey(0), max_new_tokens=MAX_NEW, do_sample=False,
                       max_seq_len=max_seq)
    out = generate(model, cfg, MultimodalBatch(torch.from_numpy(ids), torch.from_numpy(mask),
                                               None, torch.from_numpy(videos)),
                   max_new_tokens=MAX_NEW, do_sample=False, max_seq_len=max_seq)
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(out.lengths.numpy(), np.asarray(ref.lengths))


def test_chat_ask_about_video(checkpoint, tmp_path):
    from videollamb_torch.models.builder import load_pretrained_model
    from videollamb_torch.serve.chat import Chat

    model_dir, tower_dir = checkpoint
    _, model, cfg, processors, _ = load_pretrained_model(
        model_dir, video_tower_path=tower_dir, dtype="float32", load_tokenizer=False,
        device="cpu")
    tokenizer = tiny_tokenizer(str(tmp_path))
    chat = Chat(tokenizer, model, cfg, processors)
    frames = np.random.default_rng(1).integers(0, 255, (16, 64, 80, 3), dtype=np.uint8)
    pixels = processors["VIDEO"](frames)
    assert pixels.shape == (16, 3, 56, 56)
    answer = chat.ask_about_video("what is happening in this video", pixels,
                                  max_new_tokens=6, do_sample=False)
    assert isinstance(answer, str)
    assert chat.conv.messages[-1][1] == answer
    follow_up = chat.ask_about_video("describe it", pixels, first_turn=False,
                                     max_new_tokens=4, temperature=0.7, do_sample=True)
    assert isinstance(follow_up, str) and len(chat.conv.messages) == 4


@pytest.mark.parametrize("flag", [["--image-tower", "tower"], ["--image-file", "x.png"]])
def test_cli_rejects_unported_flags(checkpoint, tmp_path, monkeypatch, capsys, flag):
    """(The name dates from before the image path.) ``--image-file`` through
    the video tower at one frame, or through the ``--image-tower`` dir: the
    port's CLI prints the JAX CLI's greedy answers, turn by turn, both in f32
    (the JAX config is set to f32 too: its Chat casts inputs to
    ``cfg.dtype``). Both cases load the video tower, without which the JAX
    package cannot encode (``_tower_features`` reads ``params["video_tower"]``
    first)."""
    import builtins

    import cv2

    import videollamb_tpu.models.builder as jax_builder
    from test_torch_parity_utils import write_image_tower
    from videollamb_torch.serve import cli
    from videollamb_tpu.serve import cli as jax_cli

    model_dir, tower_dir = checkpoint
    tiny_tokenizer(model_dir)
    image = str(tmp_path / "x.png")
    cv2.imwrite(image, np.random.default_rng(4).integers(0, 255, (60, 70, 3)).astype(np.uint8))
    towers = ["--video-tower", tower_dir]
    if flag[0] == "--image-tower":
        towers += ["--image-tower", write_image_tower(str(tmp_path), seed=9)]
    argv = ["--model-path", model_dir, *towers, "--image-file", image, "--fp32",
            "--temperature", "0", "--max-new-tokens", "6"]
    load = jax_builder.load_pretrained_model

    def load_f32(*args, **kwargs):
        tok, params, cfg, processors, n = load(*args, **kwargs)
        return tok, params, dataclasses.replace(cfg, dtype="float32"), processors, n

    monkeypatch.setattr(jax_builder, "load_pretrained_model", load_f32)
    out = {}
    for side, run in (("torch", lambda: cli.main(cli.parse_args(argv + ["--device", "cpu"]))),
                      ("jax", lambda: jax_cli.main(jax_cli.parse_args()))):
        lines = iter(["describe it", "what is happening in this video", ""])
        monkeypatch.setattr(builtins, "input", lambda prompt="": next(lines))
        monkeypatch.setattr(sys, "argv", ["cli", *argv])
        capsys.readouterr()
        run()
        out[side] = capsys.readouterr().out
    assert out["torch"] == out["jax"]
    assert out["torch"].count("ASSISTANT: ") == 2


def test_port_imports_no_jax():
    """Importing every module of the port, the training modules, the serving
    surfaces, the eval drivers, anyres, the research towers, EgoVLP's text
    side, the multi-GPU modules, the weight tools, the utilities and the
    native decoder included, leaves jax and every module of the JAX package
    out of sys.modules."""
    code = (
        "import pkgutil, importlib, sys\n"
        "import videollamb_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(videollamb_torch.__path__, "
        "'videollamb_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert len(names) > 30, names\n"
        "train = {'videollamb_torch.train.' + m for m in ('step', 'dataset', 'preprocess', "
        "'checkpoint', 'trainer', 'retro', 'cli')}\n"
        "assert train <= set(names), sorted(train - set(names))\n"
        "surfaces = {'videollamb_torch.' + m for m in ('data.device_preprocess', 'data.media', "
        "'data.audio_reader', 'models.binding', 'models.vision.modalities', 'serve.embeddings', "
        "'serve.openai_api', 'serve.streams_api', 'serve.http_server', 'serve.gradio_demo')}\n"
        "assert surfaces <= set(names), sorted(surfaces - set(names))\n"
        "evals = {'videollamb_torch.eval.' + m for m in ('videoqa_mc', 'videoqa', "
        "'videoqa_consistency', 'videoqa_moviechat', 'videoqa_likelihood', 'videoqa_mixed', "
        "'niavh', 'acc', 'gpt_judge')}\n"
        "assert evals <= set(names), sorted(evals - set(names))\n"
        "breadth = {'videollamb_torch.' + m for m in ('models.anyres', 'models.vision.builder', "
        "'models.vision.vit', 'models.vision.rmt_clip_vit', 'models.vision.deform_clip', "
        "'models.vision.deformable', 'models.vision.egovlp')}\n"
        "assert breadth <= set(names), sorted(breadth - set(names))\n"
        "rest = {'videollamb_torch.' + m for m in ('models.vision.egovlp_text', "
        "'parallel.mesh', 'parallel.sharding', 'parallel.ring_attention', "
        "'parallel.seq_parallel', 'parallel.pipeline', 'parallel.tensor_parallel', "
        "'tools.weights', 'utils.logging', 'utils.profiling', 'native.video_decoder')}\n"
        "assert rest <= set(names), sorted(rest - set(names))\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'videollamb_tpu')]\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_port_sources_import_nothing_of_the_jax_package():
    """No module of the port, and not chip_smoke.py, imports videollamb_tpu or
    jax; the JAX package appears only in comments and strings there."""
    import re

    pattern = re.compile(r"^\s*(from|import)\s+(videollamb_tpu|jax)\b", re.M)
    files = [os.path.join(root, f) for root, _, names in
             os.walk(os.path.join(REPO, "videollamb_torch")) for f in names if f.endswith(".py")]
    files.append(os.path.join(REPO, "chip_smoke.py"))
    assert len(files) > 30
    rel = {os.path.relpath(f, REPO) for f in files}
    for module in ("models/anyres.py", "models/vision/builder.py", "models/vision/vit.py",
                   "models/vision/rmt_clip_vit.py", "models/vision/deform_clip.py",
                   "models/vision/deformable.py", "models/vision/egovlp.py",
                   "models/vision/egovlp_text.py", "parallel/mesh.py", "parallel/sharding.py",
                   "parallel/ring_attention.py", "parallel/seq_parallel.py",
                   "parallel/pipeline.py", "parallel/tensor_parallel.py", "tools/weights.py",
                   "utils/logging.py", "utils/profiling.py", "native/video_decoder.py"):
        assert os.path.join("videollamb_torch", module) in rel, module
    offenders = [f for f in files if pattern.search(open(f).read())]
    assert not offenders, offenders


def test_cli_without_device_needs_a_gpu(monkeypatch):
    """The card is the default device: without CUDA and without --device cpu
    the CLI raises instead of running on the CPU."""
    from videollamb_torch.serve import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = cli.parse_args(["--model-path", "unused", "--video-file", "v.mp4"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(args)


def test_load_pretrained_model_defaults_to_the_card(checkpoint, monkeypatch):
    from videollamb_torch.models.builder import load_pretrained_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model_dir, tower_dir = checkpoint
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_pretrained_model(model_dir, video_tower_path=tower_dir, load_tokenizer=False)
