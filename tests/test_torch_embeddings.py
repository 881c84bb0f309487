"""The port's LanguageBind binding model and embeddings service against the
JAX package, on the CPU, at a small size (towers and text encoder 2 layers
at width 32) in f32.

- ``models/convert.binding_from_jax`` carries a seeded JAX binding tree
  (video with temporal layers, image, audio on a rectangular mel grid, the
  text encoder, projections and logit scales) into the port, and
  ``binding_to_jax`` carries it back leaf for leaf.
- Text, video, image and audio embeddings (with and without the logit-scale
  temperature) and ``language_bind_forward`` equal JAX's within EMB_ATOL.
- ``load_binding_checkpoints`` on seeded HF-layout directories gives the
  tree that JAX's loader gives.
- ``EmbeddingService.openai_embeddings``: the same response as JAX's
  service (text batches in power-of-two buckets, a mixed text / video /
  image / audio batch, base64 encoding, usage) and the same errors.
"""

from __future__ import annotations

import base64
import dataclasses
import io
import json
import os
import wave

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from test_torch_parity_utils import export_vision_state_dict, np_tree  # noqa: E402

from videollamb_tpu.config import VisionConfig  # noqa: E402

# f32 on both sides; the towers sum in other orders. Embeddings are unit
# vectors (times exp(logit_scale) = 14.3 with the temperature).
EMB_ATOL = 2e-5

VISION = VisionConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                      num_attention_heads=4, image_size=56, patch_size=14)
AUDIO_HW = (28, 70)  # a 2 x 5 patch grid; the real one is 112 x 1036 (8 x 74)


def _configs():
    from videollamb_tpu.models.binding import TextConfig

    vcfgs = {"video": VISION,
             "image": dataclasses.replace(VISION, add_time_attn=False),
             "audio": dataclasses.replace(VISION, add_time_attn=False, image_size_hw=AUDIO_HW)}
    text = TextConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                      num_attention_heads=4, vocab_size=64, max_position_embeddings=16)
    return vcfgs, text


def _port_cfgs(vcfgs, text):
    from videollamb_torch import config as pc
    from videollamb_torch.models.binding import TextConfig

    return ({k: pc.VisionConfig(**dataclasses.asdict(v)) for k, v in vcfgs.items()},
            TextConfig(**dataclasses.asdict(text)))


@pytest.fixture(scope="module")
def binding():
    """(JAX tree, JAX cfgs, port model, port cfgs) of one seeded tree."""
    from videollamb_tpu.models.binding import init_binding_params
    from videollamb_torch.models.binding import LanguageBind
    from videollamb_torch.models.convert import binding_from_jax

    vcfgs, text = _configs()
    tree = np_tree(init_binding_params(jax.random.PRNGKey(0), vcfgs, text, projection_dim=24))
    pv, pt = _port_cfgs(vcfgs, text)
    model = LanguageBind(pv, pt, projection_dim=24)
    model.load_state_dict(binding_from_jax(tree), strict=True)
    return tree, (vcfgs, text), model.eval(), (pv, pt)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 60, size=(3, 16))
    ids[0, 5], ids[1, 15], ids[2, 9] = 63, 63, 63  # EOT (the highest id)
    ids[0, 6:] = 0
    return {
        "language": ids,
        "video": rng.normal(size=(2, 8, 3, 56, 56)).astype(np.float32),
        "image": rng.normal(size=(2, 1, 3, 56, 56)).astype(np.float32),
        "audio": rng.normal(size=(1, 1, 3) + AUDIO_HW).astype(np.float32),
    }


def test_binding_tree_converts_both_ways(binding):
    from videollamb_torch.models.convert import binding_to_jax

    tree, _, model, _ = binding
    back = binding_to_jax(model.state_dict())
    want = dict(jax.tree_util.tree_leaves_with_path(tree))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert set(got) == set(want)
    for path, leaf in want.items():
        np.testing.assert_array_equal(np.asarray(got[path]), np.asarray(leaf), err_msg=str(path))
    assert model.modalities["video"].logit_scale.dtype == torch.float32


@pytest.mark.parametrize("use_temp", [True, False], ids=["temp", "unscaled"])
def test_binding_embeddings_equal_jax(binding, use_temp):
    from videollamb_tpu.models import binding as jb
    from videollamb_torch.models import binding as pb

    tree, (vcfgs, text), model, (pv, pt) = binding
    x = _inputs()
    jparams = jax.tree.map(jnp.asarray, tree)
    want = jb.language_bind_forward(jparams, {k: jnp.asarray(v) for k, v in x.items()},
                                    vcfgs, text, use_temp=use_temp)
    with torch.no_grad():
        got = pb.language_bind_forward(model, {k: torch.from_numpy(v) for k, v in x.items()},
                                       pv, pt, use_temp=use_temp)
    assert set(got) == set(want) == set(x)
    for name in x:
        g, w = got[name].numpy(), np.asarray(want[name])
        assert g.shape == w.shape == (x[name].shape[0], 24), name
        np.testing.assert_allclose(g, w, rtol=0, atol=EMB_ATOL * (15 if use_temp else 1),
                                   err_msg=name)


def _export_text(tree):
    """JAX text tree -> HF ``CLIPTextModel`` state dict (numpy)."""
    out = {"text_model.embeddings.token_embedding.weight": tree["token_embedding"],
           "text_model.embeddings.position_embedding.weight": tree["position_embedding"],
           "text_model.final_layer_norm.weight": tree["final_layer_norm"]["scale"],
           "text_model.final_layer_norm.bias": tree["final_layer_norm"]["bias"]}
    for i, layer in enumerate(tree["layers"]):
        pre = f"text_model.encoder.layers.{i}."
        for ln in ("layer_norm1", "layer_norm2"):
            out[pre + ln + ".weight"] = layer[ln]["scale"]
            out[pre + ln + ".bias"] = layer[ln]["bias"]
        for parent, names in (("self_attn", ("q_proj", "k_proj", "v_proj", "out_proj")),
                              ("mlp", ("fc1", "fc2"))):
            for n in names:
                out[f"{pre}{parent}.{n}.weight"] = layer[parent][n]["kernel"].T
                out[f"{pre}{parent}.{n}.bias"] = layer[parent][n]["bias"]
    return out


def _write_hf_dirs(root, tree, vcfgs, text):
    """One LanguageBind-layout dir per modality; the video dir also carries
    the text branch, as LanguageBind_Video_merge does."""
    paths = {}
    for name in ("image", "video"):
        d = os.path.join(root, name)
        os.makedirs(d, exist_ok=True)
        mod = tree["modalities"][name]
        sd = export_vision_state_dict(mod["tower"])
        sd["visual_projection.weight"] = np.asarray(mod["projection"]).T
        sd["logit_scale"] = np.asarray(mod["logit_scale"]) + (0.5 if name == "image" else 0.0)
        if name == "video":
            sd.update(_export_text(tree["text"]["encoder"]))
            sd["text_projection.weight"] = np.asarray(tree["text"]["projection"]).T
        torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                   os.path.join(d, "pytorch_model.bin"))
        v = vcfgs[name]
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump({"vision_config": {
                "hidden_size": v.hidden_size, "intermediate_size": v.intermediate_size,
                "num_hidden_layers": v.num_hidden_layers,
                "num_attention_heads": v.num_attention_heads, "image_size": v.image_size,
                "patch_size": v.patch_size, "num_frames": v.num_frames},
                "text_config": dataclasses.asdict(text)}, f)
        paths[name] = d
    return paths


def test_load_binding_checkpoints_equals_jax(binding, tmp_path):
    from videollamb_tpu.models.binding import load_binding_checkpoints as jax_load
    from videollamb_torch.models.binding import load_binding_checkpoints
    from videollamb_torch.models.convert import binding_to_jax

    tree, (vcfgs, text), _, _ = binding
    paths = _write_hf_dirs(str(tmp_path), tree, vcfgs, text)
    jtree, jv, jt = jax_load(paths)
    model, pv, pt = load_binding_checkpoints(paths, device="cpu")
    assert dataclasses.asdict(pt) == dataclasses.asdict(jt)
    assert {k: dataclasses.asdict(v) for k, v in pv.items()} == \
        {k: dataclasses.asdict(v) for k, v in jv.items()}
    assert not pv["image"].add_time_attn and pv["video"].add_time_attn
    want = dict(jax.tree_util.tree_leaves_with_path(np_tree(jtree)))
    got = dict(jax.tree_util.tree_leaves_with_path(binding_to_jax(model.state_dict())))
    assert set(got) == set(want)
    for path, leaf in want.items():
        np.testing.assert_array_equal(np.asarray(got[path]), leaf, err_msg=str(path))
    with pytest.raises(ValueError, match="text branch"):
        load_binding_checkpoints({"image": paths["image"]}, device="cpu")


# ---------------------------------------------------------------------------
# EmbeddingService
# ---------------------------------------------------------------------------


class WordIds:
    """Words -> ids below 60, then EOT = 63 (the highest id, as CLIP's BPE)."""

    class _Out:
        def __init__(self, ids):
            self.input_ids = ids

    def __call__(self, text):
        return self._Out([1 + (sum(map(ord, w)) % 59) for w in text.split()] + [63])


def _media(tmp_path):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(9)
    video = tmp_path / "v.mp4"
    writer = cv2.VideoWriter(str(video), cv2.VideoWriter_fourcc(*"mp4v"), 30, (64, 48))
    for _ in range(24):
        writer.write(rng.integers(0, 255, (48, 64, 3)).astype(np.uint8))
    writer.release()
    image = tmp_path / "i.png"
    cv2.imwrite(str(image), rng.integers(0, 255, (60, 70, 3)).astype(np.uint8))
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((rng.uniform(-0.3, 0.3, 8000) * 32767).astype(np.int16).tobytes())
    return str(video), str(image), base64.b64encode(buf.getvalue()).decode()


def _services(binding):
    from videollamb_tpu.data.processing import ImageProcessor as JImage
    from videollamb_tpu.data.processing import VideoProcessor as JVideo
    from videollamb_tpu.models.vision.modalities import AudioProcessor as JAudio
    from videollamb_tpu.serve.embeddings import EmbeddingService as JaxService
    from videollamb_torch.data.processing import ImageProcessor, VideoProcessor
    from videollamb_torch.models.vision.modalities import AudioProcessor
    from videollamb_torch.serve.embeddings import EmbeddingService

    tree, (vcfgs, text), model, (pv, pt) = binding
    audio_kw = dict(num_mel_bins=AUDIO_HW[0], target_length=AUDIO_HW[1])
    jax_svc = JaxService(jax.tree.map(jnp.asarray, tree), vcfgs, WordIds(),
                         {"video": JVideo(size=56), "image": JImage(size=56),
                          "audio": JAudio(**audio_kw)}, text_cfg=text)
    svc = EmbeddingService(model, pv, WordIds(),
                           {"video": VideoProcessor(size=56), "image": ImageProcessor(size=56),
                            "audio": AudioProcessor(**audio_kw)}, text_cfg=pt, device="cpu")
    return jax_svc, svc


def _assert_same_response(got, want):
    assert {k: v for k, v in got.items() if k != "data"} == \
        {k: v for k, v in want.items() if k != "data"}
    assert len(got["data"]) == len(want["data"])
    for g, w in zip(got["data"], want["data"]):
        assert g["object"] == w["object"] == "embedding" and g["index"] == w["index"]
        ge, we = g["embedding"], w["embedding"]
        if isinstance(we, str):
            ge = np.frombuffer(base64.b64decode(ge), "<f4")
            we = np.frombuffer(base64.b64decode(we), "<f4")
        np.testing.assert_allclose(np.asarray(ge), np.asarray(we), rtol=0, atol=EMB_ATOL)


def test_embedding_service_equals_jax(binding, tmp_path):
    from videollamb_tpu.serve.openai_api import BadRequest as JaxBadRequest
    from videollamb_torch.serve.openai_api import BadRequest

    jax_svc, svc = _services(binding)
    video, image, audio_b64 = _media(tmp_path)
    bodies = [
        {"input": "a dog runs"},
        {"input": ["one", "two three", "four five six"], "encoding_format": "base64"},
        {"input": [{"type": "text", "text": "a clip"},
                   {"type": "video_url", "video_url": {"url": video}},
                   {"type": "image_url", "image_url": {"url": "file://" + image}},
                   {"type": "input_audio", "input_audio": {"data": audio_b64,
                                                           "format": "wav"}},
                   "and text"]},
    ]
    for body in bodies:
        _assert_same_response(svc.openai_embeddings(body), jax_svc.openai_embeddings(body))
    errors = [{"input": "x", "model": "other"}, {"input": "x", "encoding_format": "hex"},
              {}, {"input": []}, {"input": [{"type": "bogus"}]},
              {"input": [{"type": "video_url", "video_url": {}}]}]
    for body in errors:
        with pytest.raises(JaxBadRequest) as want:
            jax_svc.openai_embeddings(body)
        with pytest.raises(BadRequest) as got:
            svc.openai_embeddings(body)
        assert (str(got.value), got.value.status, got.value.code) == \
            (str(want.value), want.value.status, want.value.code)


def test_text_batches_pad_to_power_of_two_buckets(binding, monkeypatch):
    from videollamb_torch.models import binding as pb

    _, svc = _services(binding)
    seen = []
    encode = pb.binding_encode_text

    def spy(model, ids, cfg):
        seen.append(tuple(ids.shape))
        return encode(model, ids, cfg)

    monkeypatch.setattr(pb, "binding_encode_text", spy)
    one, n1 = svc.embed_texts(["a b c"])
    many, n5 = svc.embed_texts(["a b c", "d", "e f", "g", "h i j k"])
    assert seen == [(1, 16), (8, 16)]
    assert many.shape == (5, 24) and (n1, n5) == (4, 4 + 2 + 3 + 2 + 5)
    np.testing.assert_allclose(many[0], one[0], rtol=0, atol=1e-6)
