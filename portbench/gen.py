"""Traffic generation from a mix's data file and the run's seed.

``video_qa``: requests of one clip and a question. Request i belongs to a
block of ``block`` requests that holds the same requests' sizes for every
seed (the frame counts cycled, the question and answer lengths at evenly
spaced quantiles of their distributions, paired the same way), in an order
the seed shuffles; so two seeds differ in order and content, not in the
work they ask for.

Each clip is a sequence of planted scenes: a smooth random base image per
scene plus a little noise per frame. Three of the cuts between scenes are
strong (a new base image) and the rest weak (the base partly blended
towards a new one), so SceneTilling's top three depths are the strong cuts
whatever the rounding, and the last strong cut leaves at least
``last_segment_frames`` frames after it: every prompt then carries the same
number of visual tokens. Cuts fall where the tower can see them sharply:
see ``_scene_plan``.

Open arrivals (``arrival_offsets``): blocks of ``block`` gaps at evenly
spaced quantiles of an exponential of rate ``rate_per_s``, shuffled by the
seed, requests in bursts of ``burst``; every seed offers the same load in
another order.

``clip_batches``: ``distinct`` batches of ``batch`` clips of ``frames``
frames, each clip one scene.
"""

from __future__ import annotations

import statistics
from dataclasses import dataclass
from typing import List

import numpy as np
import torch
import torch.nn.functional as F

STRONG_CUTS = 3
BOS = 1
VIDEO_SENTINEL = -201  # the video placeholder id of the LLaVA family's prompts
FIRST_WORD_ID = 3  # ids 0-2 are unk, bos and eos


def _rng(*keys: int) -> np.random.Generator:
    return np.random.default_rng([int(k) % (2 ** 64) for k in keys])


def _quantile_ints(dist: dict, n: int) -> List[int]:
    """n lengths at the quantiles (j + 0.5) / n of ``dist``."""
    out = []
    for j in range(n):
        u = (j + 0.5) / n
        if dist["kind"] == "uniform":
            out.append(dist["lo"] + int(u * (dist["hi"] - dist["lo"] + 1)))
        elif dist["kind"] == "lognormal":
            z = statistics.NormalDist().inv_cdf(u)
            x = round(dist["median"] * float(np.exp(dist["sigma"] * z)))
            out.append(int(min(max(x, dist["lo"]), dist["hi"])))
        else:
            raise ValueError(f"unknown length distribution {dist['kind']!r}")
    return out


@dataclass
class VideoRequest:
    index: int
    frames: int
    ids: List[int]           # text ids with one negative sentinel
    answer_tokens: int
    scene_frames: List[int]  # frames per planted scene
    strong_cuts: List[int]   # the last frame before each strong cut
    clip_seed: int
    prompt_len: int          # spliced length the plan implies


def _block(traffic: dict, seed: int, b: int):
    n = traffic["block"]
    frames = [traffic["frames"][j % len(traffic["frames"])] for j in range(n)]
    lo, hi = traffic["text_ids"]
    texts = _quantile_ints({"kind": "uniform", "lo": lo, "hi": hi}, n)
    answers = _quantile_ints(traffic["answer"], n)
    # One fixed pairing of the three sizes for every seed; the seed orders the block.
    fixed = _rng(0)
    texts = list(np.asarray(texts)[fixed.permutation(n)])
    answers = list(np.asarray(answers)[fixed.permutation(n)])
    order = _rng(seed, b, 0).permutation(n)
    return [list(np.asarray(x)[order]) for x in (frames, texts, answers)]


def arrival_offsets(arrivals: dict, seed: int, block: int, seconds: float) -> List[float]:
    """Due times, in seconds from the window's start, of requests 0, 1, ...:
    enough for twice the window and a minute more. Requests come in bursts of
    ``burst`` (default 1) at once, the gap before each burst ``burst`` times a
    gap of the exponential, so the mean rate stays ``rate_per_s``."""
    rate, burst = arrivals["rate_per_s"], arrivals.get("burst", 1)
    gaps = np.asarray([-np.log1p(-(j + 0.5) / block) / rate for j in range(block)])
    out, t, b = [], 0.0, 0
    while t <= 2 * seconds + 60:
        for g in gaps[_rng(seed, b, 4).permutation(block)]:
            t += float(g) * burst
            out.extend([t] * burst)
        b += 1
    return out


def _scene_plan(rng: np.random.Generator, t: int, traffic: dict):
    """(frames per scene, strong cuts). Cuts fall at the ends of the tower's
    temporal windows (``cut_every`` frames): its temporal attention spreads a
    cut inside a window over the window, where rounding can reorder the
    depths. Three cuts are strong and leave at least ``last_segment_frames``
    frames after the last of them; the others are weak."""
    k_lo, k_hi = traffic["scenes"]
    every, tail = traffic["cut_every"], traffic["last_segment_frames"]
    ends = list(range(every - 1, t - 1, every))
    eligible = [c for c in ends if c <= t - 1 - tail]
    if len(eligible) < STRONG_CUTS:
        raise ValueError(f"{t} frames hold {len(eligible)} window ends before a "
                         f"{tail}-frame last segment; {STRONG_CUTS} strong cuts need more")
    strong = sorted(int(c) for c in rng.choice(eligible, STRONG_CUTS, replace=False))
    others = [c for c in ends if c not in strong]
    n_weak = min(max(int(rng.integers(k_lo, k_hi + 1)) - 1 - STRONG_CUTS, 0), len(others))
    weak = [int(c) for c in rng.choice(others, n_weak, replace=False)] if n_weak else []
    cuts = sorted(strong + weak)
    lengths = np.diff([-1] + cuts + [t - 1])
    return [int(x) for x in lengths], strong


def video_request(traffic: dict, seed: int, i: int, vocab: int,
                  tokens_per_frame: int) -> VideoRequest:
    frames, texts, answers = _block(traffic, seed, i // traffic["block"])
    j = i % traffic["block"]
    t, n_text, n_ans = int(frames[j]), int(texts[j]), int(answers[j])
    rng = _rng(seed, i, 1)
    scene_frames, strong = _scene_plan(rng, t, traffic)
    ids = [BOS] + [int(x) for x in rng.integers(FIRST_WORD_ID, vocab, n_text - 1)]
    ids[traffic["sentinel_at"]] = VIDEO_SENTINEL
    last = min(t - 1 - strong[-1], traffic["last_segment_frames"])
    return VideoRequest(index=i, frames=t, ids=ids, answer_tokens=n_ans,
                        scene_frames=scene_frames, strong_cuts=strong,
                        clip_seed=int(rng.integers(0, 2 ** 62)),
                        prompt_len=n_text - 1 + last * tokens_per_frame)


def warm_request(traffic: dict, seed: int, n: int, frames: int, vocab: int,
                 tokens_per_frame: int) -> VideoRequest:
    """The n-th warm-up request (index -1 - n): a clip of ``frames`` frames and
    the mix's longest answer, outside the sequence the window draws from."""
    plan = video_request(traffic, seed, 0, vocab, tokens_per_frame)
    scene_frames, strong = _scene_plan(_rng(seed, n, 9), frames, traffic)
    longest = max(_quantile_ints(traffic["answer"], traffic["block"]))
    return VideoRequest(index=-1 - n, frames=frames, ids=plan.ids, answer_tokens=longest,
                        scene_frames=scene_frames, strong_cuts=strong,
                        clip_seed=plan.clip_seed, prompt_len=plan.prompt_len)


def _smooth_images(g: torch.Generator, n: int, size: int, device) -> torch.Tensor:
    """n random images with structure at every scale, about unit variance."""
    coarse = torch.randn((n, 3, 8, 8), generator=g, device=device)
    fine = torch.randn((n, 3, size, size), generator=g, device=device)
    return F.interpolate(coarse, size=(size, size), mode="bilinear", align_corners=False) \
        + 0.5 * fine


def make_clip(req: VideoRequest, traffic: dict, size: int, device, dtype) -> torch.Tensor:
    """(T, 3, size, size) frames of the request's planted scenes."""
    g = torch.Generator(device=device).manual_seed(req.clip_seed)
    k = len(req.scene_frames)
    fresh = _smooth_images(g, k, size, device)
    noise = torch.randn((req.frames, 3, size, size), generator=g, device=device)
    mix = traffic["weak_cut_mix"]
    bases = [fresh[0]]
    ends = np.cumsum(req.scene_frames) - 1
    for s in range(1, k):
        if int(ends[s - 1]) in req.strong_cuts:
            bases.append(fresh[s])
        else:
            bases.append((1.0 - mix) * bases[-1] + mix * fresh[s])
    scene_of = np.repeat(np.arange(k), req.scene_frames)
    base = torch.stack(bases)[torch.as_tensor(scene_of, device=device)]
    return (base + traffic["frame_noise"] * noise).to(dtype)


def index_batches(traffic: dict, seed: int, size: int, device, dtype) -> List[torch.Tensor]:
    """``distinct`` batches (batch, frames, 3, size, size), each clip one scene."""
    out = []
    b, t = traffic["batch"], traffic["frames"]
    for i in range(traffic["distinct"]):
        g = torch.Generator(device=device).manual_seed(int(_rng(seed, i, 2).integers(0, 2 ** 62)))
        base = _smooth_images(g, b, size, device)
        noise = torch.randn((b, t, 3, size, size), generator=g, device=device)
        out.append((base[:, None] + traffic["frame_noise"] * noise).to(dtype))
    return out


def expected_bounds(req: VideoRequest) -> List[int]:
    return list(req.strong_cuts) + [req.frames - 1]

