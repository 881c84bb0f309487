"""The port's on-device video preprocessing and host media layer against the
JAX package, on the CPU.

- ``device_video_preprocess``: the JAX function and the port's (plain torch
  ``F.interpolate`` bilinear, half-pixel, no antialias) on the same uint8
  frames within 1e-5, for down- and up-scales, both orientations, the
  identity size and a single frame; the port against the host cv2
  ``VideoProcessor`` within the JAX test's bound (cv2's fixed-point
  bilinear, < 1/255 per pixel before normalising).
- ``DeviceVideoProcessor``: shape, dtype and device of its output; the
  loader builds it for ``device_preprocess``; a ``Chat`` fed by it answers
  as from the same frames in numpy.
- The media layer: ``ImageProcessor``, ``AudioProcessor`` (short clips
  repeated and padded, long clips in three chunks, resampling), the depth
  and thermal processors, ``load_audio`` and ``load_media_blocks`` give the
  JAX package's arrays exactly.
"""

from __future__ import annotations

import wave

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

# Float resize of the same uint8 frames: the two packages sum the same two
# taps in f32 in another order.
DEVICE_ATOL = 1e-5


def _frames(t=4, h=360, w=640, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=(t, h, w, 3)).astype(np.uint8)


@pytest.mark.parametrize("t,h,w,size", [(4, 360, 640, 224), (3, 640, 360, 224),
                                        (2, 48, 64, 56), (2, 224, 224, 224),
                                        (1, 301, 299, 56), (2, 30, 40, 56)],
                         ids=["down_wide", "down_tall", "down_small", "identity",
                              "single_frame", "upscale"])
def test_device_preprocess_equals_jax(t, h, w, size):
    from videollamb_tpu.data.device_preprocess import device_video_preprocess as jax_pre
    from videollamb_torch.data.device_preprocess import device_video_preprocess

    frames = _frames(t, h, w, seed=h * w + t)
    want = np.asarray(jax_pre(jnp.asarray(frames), size=size))
    got = device_video_preprocess(frames, size=size, device="cpu")
    assert got.shape == want.shape == (t, 3, size, size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=DEVICE_ATOL)


@pytest.mark.parametrize("h,w", [(360, 640), (640, 360), (224, 224), (300, 300)])
def test_device_preprocess_matches_host_processor(h, w):
    pytest.importorskip("cv2")
    from videollamb_torch.data.device_preprocess import device_video_preprocess
    from videollamb_torch.data.processing import VideoProcessor

    frames = _frames(h=h, w=w, seed=h + w)
    host = VideoProcessor(size=224)(frames)
    dev = device_video_preprocess(frames, size=224).numpy()
    assert dev.shape == host.shape == (4, 3, 224, 224)
    # The JAX test's bound: < 1/255 per pixel, divided by std ~0.26.
    assert np.abs(dev - host).max() < 4.5 / 255 / 0.26
    if (h, w) == (224, 224):  # no resize: exact up to the normalise
        np.testing.assert_allclose(dev, host, rtol=0, atol=1e-5)


def test_device_processor_contract():
    from videollamb_torch.data.device_preprocess import DeviceVideoProcessor

    proc = DeviceVideoProcessor(size=56, out_dtype=torch.bfloat16, device="cpu")
    out = proc(_frames(t=2, h=64, w=80))
    assert out.shape == (2, 3, 56, 56) and out.dtype == torch.bfloat16
    assert out.device.type == "cpu"
    one = proc(_frames(t=1, h=64, w=80)[0])  # (H, W, 3) promotes to T = 1
    assert one.shape == (1, 3, 56, 56)


def test_loader_builds_the_device_processor(tmp_path):
    from test_torch_parity_utils import write_reference_checkpoint

    from videollamb_torch.data.device_preprocess import DeviceVideoProcessor
    from videollamb_torch.data.processing import ImageProcessor, VideoProcessor
    from videollamb_torch.models.builder import load_pretrained_model

    model_dir, tower_dir = write_reference_checkpoint(str(tmp_path), seed=4)
    kw = dict(video_tower_path=tower_dir, dtype="float32", load_tokenizer=False, device="cpu")
    _, _, cfg, procs, _ = load_pretrained_model(model_dir, device_preprocess=True, **kw)
    assert isinstance(procs["VIDEO"], DeviceVideoProcessor)
    assert procs["VIDEO"].size == cfg.vision.image_size and procs["VIDEO"].device.type == "cpu"
    assert isinstance(procs["IMAGE"], ImageProcessor)
    _, _, _, host, _ = load_pretrained_model(model_dir, **kw)
    assert isinstance(host["VIDEO"], VideoProcessor)


def test_chat_takes_device_frames():
    """``--device-preprocess`` end to end: a Chat's video question runs on the
    device processor's tensor and answers as from the same frames in numpy."""
    from test_serving import ChatTokenizer
    from test_torch_parity_utils import tiny_models

    from videollamb_torch.data.device_preprocess import DeviceVideoProcessor
    from videollamb_torch.serve.chat import Chat

    _, _, model, cfg = tiny_models(max_length=128)
    tok = ChatTokenizer()
    tok("A chat between a curious human and an artificial intelligence assistant")
    proc = DeviceVideoProcessor(size=cfg.vision.image_size, device="cpu")
    raw = _frames(t=8, h=80, w=120, seed=7)
    frames = proc(raw)
    answers = []
    for clip in (frames, frames.numpy()):
        chat = Chat(tok, model, cfg, {"VIDEO": proc}, text_bucket=32)
        answers.append(chat.ask_about_video("what happens", clip, max_new_tokens=4,
                                            do_sample=False))
    assert answers[0] == answers[1] and answers[0]


# ---------------------------------------------------------------------------
# The host media layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(48, 64, 3), (90, 40, 3), (33, 33)], ids=["wide", "tall", "gray"])
def test_image_processor_equals_jax(shape):
    pytest.importorskip("cv2")
    from videollamb_tpu.data.processing import ImageProcessor as JaxImage
    from videollamb_torch.data.processing import ImageProcessor

    img = np.random.default_rng(sum(shape)).integers(0, 256, shape).astype(np.uint8)
    want = JaxImage(size=28)(img)
    got = ImageProcessor(size=28)(img)
    assert got.shape == (3, 28, 28)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seconds,sr", [(0.7, 16000), (2.0, 8000), (11.0, 16000)],
                         ids=["short_repeated", "resampled", "three_chunks"])
def test_audio_processor_equals_jax(seconds, sr):
    from videollamb_tpu.models.vision import modalities as jm
    from videollamb_torch.models.vision import modalities as pm

    wav = np.random.default_rng(int(seconds * 10)).normal(size=int(seconds * sr)).astype(np.float32)
    kw = dict(num_mel_bins=16, target_length=96) if seconds > 10 else {}
    want = jm.AudioProcessor(**kw)(wav * 0.1, origin_sr=sr)
    got = pm.AudioProcessor(**kw)(wav * 0.1, origin_sr=sr)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pm.log_mel_fbank(wav[:4000]), jm.log_mel_fbank(wav[:4000]))


def test_depth_thermal_and_configs_equal_jax():
    pytest.importorskip("cv2")
    import dataclasses

    from videollamb_tpu.models.vision import modalities as jm
    from videollamb_torch.models.vision import modalities as pm

    rng = np.random.default_rng(3)
    depth = rng.uniform(0, 12000, (40, 50)).astype(np.float32)
    np.testing.assert_array_equal(pm.DepthProcessor(size=28)(depth),
                                  jm.DepthProcessor(size=28)(depth))
    thermal = rng.integers(0, 256, (40, 50)).astype(np.uint8)
    np.testing.assert_array_equal(pm.ThermalProcessor(size=28)(thermal),
                                  jm.ThermalProcessor(size=28)(thermal))
    a, b = pm.audio_tower_config(), jm.audio_tower_config()
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert a.grid_hw == (8, 74) and a.seq_len == 593


def _write_wav(path, data, rate=16000, width=2, channels=1):
    scale = {1: 127, 2: 32767, 4: 2 ** 31 - 1}[width]
    ints = np.clip(data * scale, -scale, scale)
    ints = {1: (ints + 128).astype(np.uint8), 2: ints.astype(np.int16),
            4: ints.astype(np.int32)}[width]
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(rate)
        w.writeframes(ints.tobytes())


@pytest.mark.parametrize("width,channels", [(1, 1), (2, 2), (4, 1)])
def test_load_audio_equals_jax(tmp_path, width, channels):
    from videollamb_tpu.data.audio_reader import load_audio as jax_load
    from videollamb_torch.data.audio_reader import load_audio

    data = np.random.default_rng(width).uniform(-0.9, 0.9, 800 * channels)
    path = tmp_path / "a.wav"
    _write_wav(path, data, rate=8000, width=width, channels=channels)
    got, rate = load_audio(str(path))
    want, want_rate = jax_load(str(path))
    assert rate == want_rate == 8000 and got.shape == (800,)
    np.testing.assert_array_equal(got, want)


def test_load_media_blocks_equals_jax(tmp_path):
    cv2 = pytest.importorskip("cv2")
    from videollamb_tpu.data import media as jmedia
    from videollamb_tpu.data.processing import ImageProcessor as JImage
    from videollamb_tpu.data.processing import VideoProcessor as JVideo
    from videollamb_torch.data import media
    from videollamb_torch.data.processing import ImageProcessor, VideoProcessor

    rng = np.random.default_rng(5)
    video = tmp_path / "v.mp4"
    writer = cv2.VideoWriter(str(video), cv2.VideoWriter_fourcc(*"mp4v"), 30, (64, 48))
    for _ in range(30):
        writer.write(rng.integers(0, 255, (48, 64, 3)).astype(np.uint8))
    writer.release()
    image = tmp_path / "i.png"
    cv2.imwrite(str(image), rng.integers(0, 255, (40, 52, 3)).astype(np.uint8))
    audio = tmp_path / "a.wav"
    _write_wav(audio, rng.uniform(-0.5, 0.5, 16000))
    paths = {"AUDIO": str(audio), "IMAGE": str(image), "VIDEO": str(video)}
    want = jmedia.load_media_blocks(paths, {"VIDEO": JVideo(size=28), "IMAGE": JImage(size=28)},
                                    num_frames=4)
    got = media.load_media_blocks(paths, {"VIDEO": VideoProcessor(size=28),
                                          "IMAGE": ImageProcessor(size=28)}, num_frames=4)
    assert [m for m, _ in got] == [m for m, _ in want] == ["VIDEO", "IMAGE", "AUDIO"]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w)
    missing = {"IMAGE": str(tmp_path / "nope.png")}
    assert media.load_media_blocks(missing, {"IMAGE": ImageProcessor(28)}, strict=False) is None
    with pytest.raises(FileNotFoundError):
        media.load_media_blocks(missing, {"IMAGE": ImageProcessor(28)})
