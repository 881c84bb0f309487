"""Image, audio and mixed-modality rows of the port against the JAX package,
on the CPU, on ``ModelConfig.tiny(max_length=128)`` in f32.

One seeded JAX parameter tree feeds both packages, with and without a
separate image tower (without one, an image goes through the video tower at
one frame). Audio blocks are 56 x 56 mel images (an ``AudioProcessor`` at
the tiny tower's image size) that ride the image path, as in the JAX
package. Each package gets its own ``ChatTokenizer`` seeded with every word
the tests send, so ids agree.

- ``tokenizer_multi_x_token``: ids and modality order exactly equal;
- ``encode_images`` / ``encode_mixed``: max |port - JAX| <= ENCODE_RTOL of
  max |JAX| (f32 on both sides, summation order differs);
- ``Chat.generate_text(images=)``, ``stream_text(images=)``, ``ask_mixed``:
  greedy answers equal; a single-video ``ask_mixed`` equals
  ``ask_about_video``;
- ``load_pretrained_model(image_tower_path=)`` on a reference-format tower
  dir: the config and the image tower's leaves equal the JAX loader's;
- the batch CLI's image, audio and mixed rows through the dense engine and
  the paged engine (f32 and int8 pools): tokens equal to the JAX engines';
- automatic prefix caching of two rows with one prompt and two images in a
  one-entry cache: tokens and (misses, hits) equal to the JAX engine's (the
  cache key hashes the images).
"""

from __future__ import annotations

import dataclasses
import json
import os
import wave

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
cv2 = pytest.importorskip("cv2")

import jax.numpy as jnp  # noqa: E402
from test_serving import ChatTokenizer  # noqa: E402
from test_torch_parity_utils import (  # noqa: E402
    jax_params,
    np_tree,
    port_config,
    write_image_tower,
    write_reference_checkpoint,
)

from videollamb_tpu.config import ModelConfig  # noqa: E402

CFG = ModelConfig.tiny(max_length=128)
# f32 encoders on both sides: the outputs part by summation order only.
ENCODE_RTOL = 1e-5
MAX_NEW = 4
WORDS = ("A chat between a curious human and an artificial intelligence assistant "
         "compare with what changed describe the scene what do you hear is happening "
         "and now tell me more <image> <video> <audio>")
TOWERS = ["video_tower", "image_tower"]


def _tokenizer():
    tok = ChatTokenizer()
    tok(WORDS)
    return tok


def _tree(towers: str) -> dict:
    """The seeded tree; with ``image_tower``, a separate image tower without
    temporal layers."""
    from videollamb_tpu.models.vision.clip_vit import init_vision_params

    tree = jax_params(CFG, 0)
    if towers == "image_tower":
        vision = dataclasses.replace(CFG.vision, add_time_attn=False)
        tree["image_tower"] = np_tree(init_vision_params(jax.random.PRNGKey(7), vision))
    return tree


def _port_model(tree: dict):
    from videollamb_torch.models.assembly import VideoLLaMB
    from videollamb_torch.models.bridge.rmt_r import RMTRBridge
    from videollamb_torch.models.convert import from_jax_params
    from videollamb_torch.models.lm.llama import LlamaForCausalLM
    from videollamb_torch.models.vision.clip_vit import CLIPVisionTower

    cfg = port_config(CFG)
    image_tower = (CLIPVisionTower(dataclasses.replace(cfg.vision, add_time_attn=False))
                   if "image_tower" in tree else None)
    model = VideoLLaMB(CLIPVisionTower(cfg.vision), RMTRBridge(cfg.bridge, cfg.lm.hidden_size),
                       LlamaForCausalLM(cfg.lm), image_tower)
    model.load_state_dict(from_jax_params(tree), strict=True)
    return model.eval(), cfg


def _processors(side: str) -> dict:
    if side == "jax":
        from videollamb_tpu.data.processing import ImageProcessor, VideoProcessor
        from videollamb_tpu.models.vision.modalities import AudioProcessor
    else:
        from videollamb_torch.data.processing import ImageProcessor, VideoProcessor
        from videollamb_torch.models.vision.modalities import AudioProcessor
    size = CFG.vision.image_size
    return {"VIDEO": VideoProcessor(size=size), "IMAGE": ImageProcessor(size=size),
            "AUDIO": AudioProcessor(num_mel_bins=size, target_length=size)}


def _both(towers: str) -> dict:
    """{"jax": (Chat, params), "torch": (Chat, model)} over one seeded tree."""
    from videollamb_torch.serve.chat import Chat
    from videollamb_tpu.serve.chat import Chat as JChat

    tree = _tree(towers)
    params = jax.tree.map(jnp.asarray, tree)
    model, pcfg = _port_model(tree)
    return {"jax": (JChat(_tokenizer(), params, CFG, _processors("jax"), text_bucket=32), params),
            "torch": (Chat(_tokenizer(), model, pcfg, _processors("torch"), text_bucket=32),
                      model)}


@pytest.fixture(scope="module", params=TOWERS)
def both(request):
    return _both(request.param)


@pytest.fixture(scope="module")
def served():
    """The engines' model: images through a separate image tower."""
    return _both("image_tower")


def _pixels(seed: int):
    """(video (8, 3, 56, 56), image (3, 56, 56), audio mel image (3, 56, 56)),
    processed from seeded uint8 frames and a seeded waveform."""
    rng = np.random.default_rng(seed)
    procs = _processors("jax")
    video = procs["VIDEO"](rng.integers(0, 255, (8, 64, 72, 3)).astype(np.uint8))
    image = procs["IMAGE"](rng.integers(0, 255, (60, 70, 3)).astype(np.uint8))
    audio = procs["AUDIO"](rng.normal(size=8000).astype(np.float32) * 0.1, origin_sr=16000)
    return video, image, audio


@pytest.mark.parametrize("prompt", [
    "<video>\ncompare with <image>\nwhat changed",
    "<image>\n<audio>\n<video>\nwhat do you hear",
    "<video>\nwhat is happening",
    "describe the scene",
], ids=["video_image", "three", "one", "none"])
def test_tokenizer_multi_x_token_equals_jax(prompt):
    from videollamb_torch.mm_utils import tokenizer_multi_x_token
    from videollamb_tpu.mm_utils import tokenizer_multi_x_token as jax_multi

    ids, mods = tokenizer_multi_x_token(prompt, _tokenizer(), return_tensors="np")
    want_ids, want_mods = jax_multi(prompt, _tokenizer(), return_tensors="np")
    assert mods == want_mods
    np.testing.assert_array_equal(ids, want_ids)
    assert ids.dtype == want_ids.dtype


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got.numpy() - want).max())
    assert err <= ENCODE_RTOL * float(np.abs(want).max()), err


def test_encode_images_and_mixed_equal_jax(both):
    from videollamb_torch.models.assembly import encode_images, encode_mixed
    from videollamb_tpu.models.assembly import encode_images as jax_images
    from videollamb_tpu.models.assembly import _encode_mixed_jit as jax_mixed

    (_, params), (_, model) = both["jax"], both["torch"]
    pcfg = both["torch"][0].cfg
    video, image, audio = _pixels(0)
    images = np.stack([image, _pixels(1)[1]])
    want_tok, want_mask = jax.jit(jax_images, static_argnums=1)(params, CFG, jnp.asarray(images))
    with torch.no_grad():
        tok, mask = encode_images(model, pcfg, torch.from_numpy(images))
    _close(tok, want_tok)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))

    blocks = (("VIDEO", video), ("IMAGE", image), ("AUDIO", audio))
    # The JAX package's jitted route to encode_mixed (modalities static).
    want_x, want_m = jax_mixed(params, CFG, tuple(m for m, _ in blocks),
                               tuple(jnp.asarray(p) for _, p in blocks))
    with torch.no_grad():
        x, m = encode_mixed(model, pcfg, tuple((k, torch.from_numpy(p)) for k, p in blocks))
    _close(x, want_x)
    np.testing.assert_array_equal(m.numpy(), np.asarray(want_m))
    assert x.shape[:2] == (1, 3) and not m[0, 1, tok.shape[1]:].any()


def test_generate_and_stream_text_with_an_image_equal_jax(both):
    _, image, _ = _pixels(2)
    out = {}
    for side, (chat, _) in both.items():
        chat.reset()
        chat.conv.append_message(chat.conv.roles[0], "<image>\ndescribe the scene")
        chat.conv.append_message(chat.conv.roles[1], None)
        prompt = chat.conv.get_prompt()
        text = chat.generate_text(prompt, images=image, max_new_tokens=MAX_NEW,
                                  temperature=0.0, do_sample=False)
        stream = list(chat.stream_text(prompt, images=image, max_new_tokens=MAX_NEW,
                                       temperature=0.0, do_sample=False))
        out[side] = (text, stream)
    assert out["torch"] == out["jax"]
    assert out["torch"][0] and out["torch"][1][-1] == out["torch"][0]


def test_ask_mixed_answers_equal_jax(both):
    """Tags prepended by ask_mixed, then a question that places its own tags
    in another order; greedy answers equal."""
    video, image, audio = _pixels(3)
    blocks = [("VIDEO", video), ("IMAGE", image), ("AUDIO", audio)]
    placed = "compare <audio> with <image> and <video>"
    out = {}
    for side, (chat, _) in both.items():
        chat.reset()
        first = chat.ask_mixed("what changed", blocks, max_new_tokens=MAX_NEW)
        chat.reset()
        second = chat.ask_mixed(placed, blocks, max_new_tokens=MAX_NEW)
        out[side] = (first, second, chat.conv.get_prompt())
    assert out["torch"] == out["jax"]


def test_ask_mixed_rejects_tags_without_blocks_like_jax(both):
    video, _, _ = _pixels(4)
    for side, (chat, _) in both.items():
        chat.reset()
        with pytest.raises(ValueError, match="do not match the supplied blocks"):
            chat.ask_mixed("<image>\nwhat changed", [("VIDEO", video)], max_new_tokens=2)


def test_single_video_ask_mixed_equals_ask_about_video(both):
    chat, _ = both["torch"]
    video, _, _ = _pixels(5)
    chat.reset()
    plain = chat.ask_about_video("what is happening", video, max_new_tokens=6,
                                 temperature=0.0, do_sample=False)
    chat.reset()
    assert chat.ask_mixed("what is happening", [("VIDEO", video)], max_new_tokens=6) == plain


@pytest.mark.parametrize("with_video_tower", [True, False], ids=["and_video", "image_only"])
def test_load_pretrained_model_image_tower_dir(tmp_path, with_video_tower):
    from videollamb_torch.models.builder import load_pretrained_model
    from videollamb_torch.models.convert import to_jax_params
    from videollamb_tpu.models.builder import load_pretrained_model as jax_load

    model_dir, tower_dir = write_reference_checkpoint(str(tmp_path), seed=2)
    image_dir = write_image_tower(str(tmp_path), seed=9)
    video = tower_dir if with_video_tower else None
    _, params, jcfg, _, _ = jax_load(model_dir, video_tower_path=video,
                                     image_tower_path=image_dir, dtype="float32",
                                     load_tokenizer=False)
    _, model, cfg, _, _ = load_pretrained_model(
        model_dir, video_tower_path=video, image_tower_path=image_dir, dtype="float32",
        load_tokenizer=False, device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert (model.video_tower is not None) == with_video_tower
    got = dict(jax.tree_util.tree_flatten_with_path(
        to_jax_params(model.state_dict())["image_tower"])[0])
    want = jax.tree_util.tree_flatten_with_path(np_tree(params["image_tower"]))[0]
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], leaf)


def _media_files(root) -> dict:
    """A cv2-written frame dir, two PNGs and a WAV."""
    rng = np.random.default_rng(11)
    vid = root / "clip"
    vid.mkdir(exist_ok=True)
    for i in range(8):
        cv2.imwrite(str(vid / f"{i:04d}.jpg"), rng.integers(0, 255, (56, 64, 3)).astype(np.uint8))
    files = {"video": str(vid)}
    for name in ("img_a", "img_b"):
        path = root / f"{name}.png"
        cv2.imwrite(str(path), rng.integers(0, 255, (60, 70, 3)).astype(np.uint8))
        files[name] = str(path)
    path = root / "a.wav"
    wav = 0.3 * np.sin(2 * np.pi * 330 * np.linspace(0, 0.5, 8000))
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((wav * 32767).astype(np.int16).tobytes())
    files["audio"] = str(path)
    return files


def _engines(served, engine: str, **kw):
    from videollamb_torch.serve.paged import PagedServingEngine
    from videollamb_torch.serve.server import ServingEngine
    from videollamb_tpu.serve.paged import PagedServingEngine as JPaged
    from videollamb_tpu.serve.server import ServingEngine as JDense

    (_, params), (chat, model) = served["jax"], served["torch"]
    common = dict(num_slots=2, eos_token_id=-1)
    if engine == "dense":
        return {"jax": JDense(params, CFG, **common), "torch": ServingEngine(model, chat.cfg,
                                                                             **common)}
    paged = dict(common, page_size=32, quantize_kv=engine == "paged_int8", **kw)
    return {"jax": JPaged(params, CFG, **paged), "torch": PagedServingEngine(model, chat.cfg,
                                                                             **paged)}


@pytest.mark.parametrize("engine", ["dense", "paged_f32", "paged_int8"])
def test_batch_cli_image_audio_and_mixed_rows_equal_jax(served, tmp_path, engine):
    from videollamb_torch.serve.batch_cli import build_requests, serve_requests
    from videollamb_tpu.serve.batch_cli import build_requests as jax_build
    from videollamb_tpu.serve.batch_cli import serve_requests as jax_serve

    f = _media_files(tmp_path)
    lines = [
        {"id": "image", "prompt": "describe the scene", "image": f["img_a"],
         "max_new_tokens": MAX_NEW},
        {"id": "audio", "prompt": "what do you hear", "audio": f["audio"],
         "max_new_tokens": MAX_NEW},
        {"id": "mixed", "prompt": "what changed", "video": f["video"], "image": f["img_b"],
         "max_new_tokens": MAX_NEW},
        {"id": "placed", "prompt": "compare <audio> with <image>", "image": f["img_a"],
         "audio": f["audio"], "max_new_tokens": MAX_NEW},
    ]
    engines = _engines(served, engine)
    reqs = build_requests(lines, served["torch"][0])
    assert reqs[0].batch.images.shape == (1, 3, 56, 56) and reqs[0].batch.videos is None
    assert [m for m, _ in reqs[2].batch.blocks] == ["VIDEO", "IMAGE"]
    assert [m for m, _ in reqs[3].batch.blocks] == ["AUDIO", "IMAGE"]
    got = serve_requests(engines["torch"], reqs, served["torch"][0].tokenizer, k=2)
    want = jax_serve(engines["jax"], jax_build(lines, served["jax"][0]),
                     served["jax"][0].tokenizer, k=2)
    assert sorted(got, key=lambda r: r["id"]) == sorted(want, key=lambda r: r["id"])
    assert all(r["tokens"] == MAX_NEW for r in got)


@pytest.mark.parametrize("engine", ["paged_f32", "paged_int8"])
def test_shared_prefix_rows_with_two_images_equal_jax(served, tmp_path, engine):
    """Two rows with one prompt and two different images through a one-entry
    prefix cache: each image is its own prefix (two misses), as in JAX."""
    from videollamb_torch.serve.batch_cli import build_requests, serve_requests
    from videollamb_tpu.serve.batch_cli import build_requests as jax_build
    from videollamb_tpu.serve.batch_cli import serve_requests as jax_serve

    f = _media_files(tmp_path)
    lines = [{"id": name, "prompt": "describe the scene", "image": f[name],
              "max_new_tokens": MAX_NEW, "shared_prefix": True} for name in ("img_a", "img_b")]
    engines = _engines(served, engine, prefix_cache_size=1)
    out = {}
    for side, build, run in (("torch", build_requests, serve_requests),
                             ("jax", jax_build, jax_serve)):
        chat = served[side][0]
        rows = []
        for line in lines:  # one row at a time: the second may reuse the first's prefix
            rows += run(engines[side], build([line], chat), chat.tokenizer, k=2)
        out[side] = (rows, engines[side].prefix_misses, engines[side].prefix_hits)
    assert out["torch"] == out["jax"]
    assert out["torch"][1:] == (2, 0)
