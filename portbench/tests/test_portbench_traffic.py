"""The traffic generators: the same seed gives the same inputs, every seed the
same sizes, and planted scenes give SceneTilling the planned boundaries."""

import collections
import statistics

import pytest
import torch

from portbench import gen
from portbench.reference.videollamb import scene_bounds
from portbench.tests import tiny

MIX = tiny.traffic("mistral7b-mc-longvideo")
SWEEP = tiny.traffic("mistral7b-sweep-24slots")


def _plans(traffic, seed, n):
    return [gen.video_request(traffic, seed, i, 32000, 144) for i in range(n)]


def test_same_seed_same_requests():
    a, b = _plans(MIX, tiny.SEED, 12), _plans(MIX, tiny.SEED, 12)
    assert a == b
    ca = gen.make_clip(a[5], MIX, 56, "cpu", torch.float32)
    cb = gen.make_clip(b[5], MIX, 56, "cpu", torch.float32)
    assert torch.equal(ca, cb)
    assert _plans(MIX, tiny.SEED + 1, 12) != a


def test_every_seed_the_same_sizes():
    for traffic in (MIX, SWEEP):
        n = traffic["block"] * 3
        sizes = [collections.Counter((p.frames, len(p.ids), p.answer_tokens)
                                     for p in _plans(traffic, s, n)) for s in (1, 2 ** 33 + 7)]
        assert sizes[0] == sizes[1]


def test_answer_lengths_follow_the_mix():
    lens = [p.answer_tokens for p in _plans(tiny.traffic("mistral7b-sweep-24slots"), 3, 24)]
    assert min(lens) >= 2 and max(lens) <= 12
    full = gen._quantile_ints({"kind": "lognormal", "median": 64, "sigma": 0.7, "lo": 16,
                               "hi": 256}, 24)
    assert abs(statistics.median(full) - 64) <= 3 and min(full) >= 16 and max(full) <= 256


def test_planted_scenes_give_the_planned_boundaries():
    """Frame features that follow the pixels (the flattened frame) cut the clip
    at the three strong cuts; the plan leaves a full last segment."""
    for traffic in (gen_full("mc_longvideo"), gen_full("sweep_24slots")):
        for i in range(12):
            p = gen.video_request(traffic, 99, i, 32000, 144)
            assert len(p.strong_cuts) == 3 and p.frames - 1 - p.strong_cuts[-1] >= 8
            assert sum(p.scene_frames) == p.frames and min(p.scene_frames) >= 2
            assert p.prompt_len == len(p.ids) - 1 + 8 * 144
            clip = gen.make_clip(p, traffic, 56, "cpu", torch.float32)
            feats = clip.reshape(p.frames, -1)
            assert scene_bounds(feats, 3) == gen.expected_bounds(p)


def gen_full(name):
    from portbench.harness import load_json, traffic_path

    return load_json(traffic_path(name))


def test_index_batches_repeat_by_seed():
    tr = tiny.traffic("languagebind-video-index")
    a = gen.index_batches(tr, 5, 56, "cpu", torch.float32)
    b = gen.index_batches(tr, 5, 56, "cpu", torch.float32)
    assert len(a) == tr["distinct"] and all(torch.equal(x, y) for x, y in zip(a, b))
    assert a[0].shape == (tr["batch"], tr["frames"], 3, 56, 56)


def test_open_arrivals_offer_the_same_load_for_every_seed():
    arr = {"kind": "open", "rate_per_s": 4.0, "burst": 2}
    a, b = (gen.arrival_offsets(arr, s, 12, 10.0) for s in (5, 2 ** 33 + 1))
    assert a != b and a[0] == a[1]
    block = 24  # 12 gaps, each before a burst of 2
    assert a[block - 1] == pytest.approx(b[block - 1])
    assert a[-1] > 80.0
    assert block / a[block - 1] == pytest.approx(4.0, rel=0.2)
