"""The port's training data path against the JAX package's, exactly: the
conversation templates' ids and label masks (v1, llama_2, mpt, plain and the
v0 default, legacy and non-legacy tokenizer counting), the collators' arrays,
the packer's rows and carry, the modality-grouped order, and the dataset's
decoded samples, image rows included."""

from __future__ import annotations

import copy
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from test_preprocess import WordTokenizer  # noqa: E402

from videollamb_tpu.constants import IGNORE_INDEX, VIDEO_TOKEN_INDEX  # noqa: E402
from videollamb_tpu.train import dataset as jds  # noqa: E402
from videollamb_tpu.train import preprocess as jpre  # noqa: E402
from videollamb_torch.train import dataset as pds  # noqa: E402
from videollamb_torch.train import preprocess as ppre  # noqa: E402


class NonLegacyTokenizer(WordTokenizer):
    legacy = False


SOURCES = {
    "video_one_turn": ([[{"from": "human", "value": "what is happening <video>"},
                         {"from": "gpt", "value": "a dog runs"}]], "VIDEO"),
    "video_two_turns": ([[{"from": "human", "value": "<video> describe"},
                          {"from": "gpt", "value": "cats playing"},
                          {"from": "human", "value": "how many"},
                          {"from": "gpt", "value": "two cats"}]], "VIDEO"),
    "text_two_turns": ([[{"from": "human", "value": "hello there"},
                         {"from": "gpt", "value": "hi"},
                         {"from": "human", "value": "and then"},
                         {"from": "gpt", "value": "nothing more"}]], None),
}


@pytest.fixture(autouse=True)
def _restore_templates():
    yield
    jpre.set_default_conversation("v1")
    ppre.set_default_conversation("v1")


def _both(version, sources, x, tokenizer_cls, mm_use_x_start_end=False):
    out = []
    for pre in (jpre, ppre):
        pre.set_default_conversation(version)
        src = copy.deepcopy(sources)
        if x is not None:
            src = pre.preprocess_multimodal(src, mm_use_x_start_end=mm_use_x_start_end)
        out.append(pre.preprocess(src, tokenizer_cls(), x=x))
    return out


@pytest.mark.parametrize("version", ["v1", "llama_2", "mpt", "v0"])
@pytest.mark.parametrize("source", list(SOURCES))
@pytest.mark.parametrize("tokenizer_cls", [WordTokenizer, NonLegacyTokenizer],
                         ids=["legacy", "nonlegacy"])
def test_template_ids_and_labels_equal_jax(version, source, tokenizer_cls):
    sources, x = SOURCES[source]
    want, got = _both(version, sources, x, tokenizer_cls)
    for key in ("input_ids", "labels"):
        assert len(got[key]) == len(want[key]) == 1
        np.testing.assert_array_equal(got[key][0], want[key][0])
        assert got[key][0].dtype == want[key][0].dtype
    if x is not None:
        assert VIDEO_TOKEN_INDEX in got["input_ids"][0].tolist()


def test_plain_template_and_start_end_tokens_equal_jax():
    sources = [[{"from": "human", "value": "<video>"},
                {"from": "gpt", "value": "caption words here"}]]
    want, got = _both("plain", sources, "VIDEO", WordTokenizer)
    for key in ("input_ids", "labels"):
        np.testing.assert_array_equal(got[key][0], want[key][0])
    sources, _ = SOURCES["video_one_turn"]
    want, got = _both("v1", sources, "VIDEO", WordTokenizer, mm_use_x_start_end=True)
    for key in ("input_ids", "labels"):
        np.testing.assert_array_equal(got[key][0], want[key][0])


def _samples(seed, lens=(10, 21, 7, 15, 30), video_every=2, frames=(8, 8, 16)):
    rng = np.random.default_rng(seed)
    out = []
    for i, n in enumerate(lens):
        ids = rng.integers(4, 64, size=n).astype(np.int32)
        labels = ids.copy()
        labels[: n // 2] = IGNORE_INDEX
        s = {"input_ids": ids, "labels": labels}
        if i % video_every == 0:
            ids[1] = VIDEO_TOKEN_INDEX
            s["video"] = rng.normal(size=(frames[i % len(frames)], 3, 4, 4)).astype(np.float32)
        out.append(s)
    return out


def _assert_batches_equal(got, want):
    for name in ("input_ids", "attention_mask", "labels", "videos", "segment_ids"):
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None), name
        if g is not None:
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)
            assert g.dtype == np.asarray(w).dtype, name
    if want.video_block_mask is not None or got.video_block_mask is not None:
        np.testing.assert_array_equal(got.video_block_mask, want.video_block_mask)


@pytest.mark.parametrize("bucket,max_length", [(16, 64), (8, 24)])
def test_collator_equals_jax(bucket, max_length):
    samples = _samples(0)
    want = jds.Collator(pad_token_id=3, bucket=bucket, max_length=max_length)(samples)
    got = pds.Collator(pad_token_id=3, bucket=bucket, max_length=max_length)(samples)
    _assert_batches_equal(got, want)
    text = [s for s in samples if "video" not in s]
    _assert_batches_equal(pds.Collator(bucket=bucket)(text), jds.Collator(bucket=bucket)(text))


@pytest.mark.parametrize("fixed_rows", [None, 2])
def test_packed_collator_equals_jax(fixed_rows):
    kw = dict(max_length=64, block_tokens=12, k_max=2, rows_bucket=4, bucket=16,
              fixed_rows=fixed_rows, fixed_frames=16 if fixed_rows else None)
    jcol, pcol = jds.PackedCollator(**kw), pds.PackedCollator(**kw)
    for seed in range(3):  # with fixed rows, overflow carries into the next call
        samples = _samples(seed, lens=(10, 21, 7, 15, 30, 12), video_every=2)
        assert pcol.pack(samples) == jcol.pack(samples)
        _assert_batches_equal(pcol(samples), jcol(samples))
        assert len(pcol._carry) == len(jcol._carry)


def test_packer_guards_equal_jax():
    bad = _samples(0)[1]
    bad = dict(bad, input_ids=np.where(np.arange(len(bad["input_ids"])) == 2,
                                       VIDEO_TOKEN_INDEX, bad["input_ids"]))
    for mod in (jds, pds):
        with pytest.raises(ValueError, match="sentinel"):
            mod.PackedCollator(block_tokens=4)._cost(bad)


@pytest.mark.parametrize("batch_size,world_size,seed", [(2, 1, 0), (3, 2, 5), (1, 1, 9)])
def test_modality_grouped_order_equals_jax(batch_size, world_size, seed):
    rng = np.random.default_rng(seed)
    lengths = [int(x) for x in rng.integers(1, 30, size=23) * rng.choice([-1, 1], size=23)]
    want = jds.modality_grouped_indices(lengths, batch_size, world_size, seed=seed)
    assert pds.modality_grouped_indices(lengths, batch_size, world_size, seed=seed) == want


def test_measure_block_tokens_equals_jax():
    from test_torch_parity_utils import jax_params, port_config

    from videollamb_tpu.config import ModelConfig
    from videollamb_tpu.models.assembly import measure_block_tokens as jax_measure
    from videollamb_torch.models.assembly import measure_block_tokens

    cfg = ModelConfig.tiny()
    params = jax.tree.map(jax.numpy.asarray, jax_params(cfg))
    for modality in ("video", "image"):
        assert measure_block_tokens(port_config(cfg), modality) == jax_measure(
            params, cfg, modality)


def test_dataset_samples_equal_jax(tmp_path):
    cv2 = pytest.importorskip("cv2")
    from videollamb_tpu.data.processing import ImageProcessor as JaxImageProcessor
    from videollamb_tpu.data.processing import VideoProcessor as JaxVideoProcessor
    from videollamb_torch.data.processing import ImageProcessor, VideoProcessor

    path = str(tmp_path / "a.mp4")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30, (64, 48))
    for i in range(30):
        writer.write(np.full((48, 64, 3), (i * 8) % 255, np.uint8))
    writer.release()
    records = [
        {"video": "a.mp4", "conversations": [{"from": "human", "value": "<video> what"},
                                             {"from": "gpt", "value": "a gradient"}]},
        {"conversations": [{"from": "human", "value": "hello"},
                           {"from": "gpt", "value": "hi there"}]},
        {"image": "x.png", "conversations": [{"from": "human", "value": "<image> what"},
                                             {"from": "gpt", "value": "a picture"}]},
    ]
    cv2.imwrite(str(tmp_path / "x.png"),
                np.random.default_rng(0).integers(0, 255, (40, 70, 3)).astype(np.uint8))
    data_path = tmp_path / "data.json"
    data_path.write_text(json.dumps(records))
    folders = dict(video_folder=str(tmp_path), image_folder=str(tmp_path), num_frames=8)
    jset = jds.SupervisedDataset(str(data_path), WordTokenizer(), jds.DataConfig(**folders),
                                 video_processor=JaxVideoProcessor(size=56),
                                 image_processor=JaxImageProcessor(size=56))
    pset = pds.SupervisedDataset(str(data_path), WordTokenizer(), pds.DataConfig(**folders),
                                 video_processor=VideoProcessor(size=56),
                                 image_processor=ImageProcessor(size=56))
    assert len(pset) == 3 and pset.modality_lengths() == jset.modality_lengths()
    assert [pset.modality(i) for i in range(3)] == [jset.modality(i) for i in range(3)]
    for i in range(3):
        want, got = jset[i], pset[i]
        assert sorted(got) == sorted(want)
        for key in got:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    # The image row (padded to square) collates as the JAX package's does.
    want = jds.Collator()([jset[2], jset[1]])
    got = pds.Collator()([pset[2], pset[1]])
    for key in ("input_ids", "attention_mask", "labels", "images"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key), err_msg=key)
    assert got.videos is None and want.videos is None
