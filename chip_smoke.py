"""Smoke run of the PyTorch port on one NVIDIA GPU: kernels, then the main paths.

    python3 chip_smoke.py [--seed 0]

1. Builds the hand-written kernels of ``videollamb_torch/csrc`` with nvcc
   (sm_90a, one nvcc per source, all at once) and holds each against its
   plain PyTorch version at the shapes the main paths give it, with
   CUDA-event times of both, of one PyTorch library call computing the same
   function where there is one, and the least time the card could take.
   K1 and K2 also at the encode path's 256 frames, K1 at the anyres patch
   stack (5, 257, 1024) and the RMT tower's step (1, 385, 1024); K8-K11 at that path's
   shapes (K11 also causal at (4, 32, 512, 128)); K3 also through
   ``multihead_attention`` on the (B, S, H, Dh) projections the prefill
   hands it, beside SDPA on the same views, and with Mistral's sliding
   window at (1, 32, 4096, 128), window 1024, and (1, 32, 2048, 128),
   window 4096, beside SDPA with the band as its mask; K6 also with the paged step's
   bf16 query, at the lengths where its 256-token key splits meet, twice
   each, with its host enqueue and CUDA-graph replay times; K4 with its host
   enqueue and CUDA-graph replay times, also at one slot of 1191 tokens, and
   with lengths past the table's width followed by normal calls; K5's
   CUDA-graph replay time. K4 and K6 also over 8 slots that share their
   first 16 full pages (a cached prefix), and K5 writing three garbage steps,
   then over a slot rewound by 3 rows (a frozen grammar row), followed by
   K4 over it. The build's
   ``ptxas`` registers and spills are echoed, one line per kernel.
1a. The tower's encode-throughput path (``encoder_phase``): ViT-L/14 at
   full width and depth (23 layers run, seeded random bf16 weights) encodes
   32 videos x 8 frames through ``vision_encode`` in bf16 and then int8
   (K1 and K2 must launch 23 times per encode); the (b, n, t, d) temporal
   branch (K9), K10 in K2's place and K11 in K1's run the same encode and
   are held against the live tower's features; the split-layout core (K8)
   runs 23 times.
1b. Gradients (``gradient_phase``): a 2-layer tower at full width computes
   ``sum(features^2).backward()`` on the card (the forward launches K1 and
   K2, the backward no kernel) and on a host copy in f32 (the plain route);
   the gradients of the pixels and of two weights must agree. A forward-only
   kernel wrapper given an input that wants a gradient must raise.
2. Offline video QA: answers four requests with VideoLLaMB-7B at full width
   and depth (``ModelConfig()`` defaults, seeded random bf16 weights)
   through ``videollamb_torch.models.engine.generate``: B=1 with 16, 32 and
   64 frames at 224x224, then B=2 with ragged prompts, greedy, 32 new
   tokens. K1-K3's launch counters are zeroed before the requests and must
   be non-zero after them.
3. Paged continuous batching, on the same model: a ``PagedServingEngine``
   with int8 pages and 8 slots serves 12 requests (16-frame videos, mixed
   prompt lengths, greedy, 32 new tokens, 8 decode steps per host sync),
   then one with bf16 pages serves 4. K4 and K5 must launch in the first
   run and K6 in the second.
3a. Streaming, on the same model: ``StreamingSession`` over a seeded 1-fps
   stream of 104 still-scene frames at 224x224 with three queries (tick
   latency p50 / p99 of plain, fold and response ticks; folds,
   compactions, prefetch hits; one state shape; K1 and K3 must launch),
   32 frames with the prefetch and at the live edge (no encode can be
   prefetched), in turns, then the same
   stream with K1-K3 patched to their plain versions on the card: the
   boundaries must be equal (the smallest depth margin and the bridge
   memory's error are printed). One ``LiveInfer`` pass (two scenes, one
   query, a sampled answer over all 16 frames: K1, K2, K3) and two
   ``KVChatSession``s (greedy, then prompt-lookup speculation; the first
   turn prefills, the second extends the cache).
3b. Request features (``features_phase``), on the same model: the paged
   engine with 8 slots, int8 then bf16 pages (eos 2, a vocabulary whose
   decodable ids are JSON pieces): 4 videos of 16 frames with 4 questions
   each through automatic prefix caching (hits and misses, admission of a
   video's first question against its later ones, refcounts back to zero
   after the drain and ``release_prefix``, and the first token where each
   cached answer parts from the same question as a full prompt, reported);
   then 8 text prompts unconstrained, with one choice set on 4 rows, all
   json_object (one grammar table), two choice sets with json_object rows
   (the combined table) at k = 8 and through host masks at k = 1, sampling
   controls with logprob rows, and 6 rows over two seeded adapters (ranks 8
   and 16) and the base: aggregate tok/s, peak pages, K4 / K5 / K6
   launches. Every choice answer is a choice, every json_object answer
   parses, min_tokens holds, logprobs are finite, <= 0 and sorted.
3c. The eval harness (``eval_phase``), after the serving surfaces, on the
   same model with a seeded full-width LanguageBind image tower (ViT-L/14 at
   224, no temporal layers) as ``model.image_tower``, over a synthetic set
   written with cv2 and numpy under ``build/eval_smoke/``: 8 MC questions of
   5 options (MVBench and EgoSchema formats, 8 frames, 16 new tokens)
   through ``videoqa_mc.run_inference``, ``run_inference_batched`` with 4
   slots and with ``constrained`` (every answer an option letter; batched
   answers equal to sequential ones reported, not asserted: bf16), ``acc``
   over the merged shards; ``rank_options_by_likelihood`` on 2 questions x 5
   options; the open-ended, consistency and both MovieChat scripts on 2
   samples each; NIAVH (64-frame haystack, 8-frame needle, lengths 32 and
   64, depths 0, 0.5, 1, 4 new tokens) in full then streaming mode; one
   mixed video + image + audio row; an image question and a two-image row
   through the image tower, and the question again through the video
   tower. Seconds per
   item are printed; K1-K3 must launch. K3 is then held against its plain
   version at the likelihood forward's own shape (its key lengths come from
   this run).
3d. The model's breadth (``breadth_phase``), after the eval harness, on
   the same model and tower: each projector kind of the factory at
   VideoLLaMB-7B widths (a seeded bf16 projector, tower 1024 -> LM 4096:
   linear, mlp2x_gelu, transformer, mlp_transformer, rmt_transformer,
   rmt_r_transformer, qformer2_32, retention) answers one 8-frame request of
   8 tokens through ``generate`` (spliced and visual token counts, K1-K3
   launches); llama3 RoPE scaling (Llama-3.1's config) answers one; an
   mlp2x_gelu stage-1 train step (finite loss, only the projector moves).
   Depth cuts (2 layers at full width, 1024-token prompt, 4 greedy steps)
   of the llama3-scaled LM and of Mistral-7B with a window of 256 (the band
   bites; K3 computes it on the card) against the host in f32. Then
   Mistral-7B (window 4096) at full depth under the tower and the RMT-R
   bridge, built beside the resident Llama: the four offline requests
   (16 tokens) through ``generate``, a paged run on int8 pages (K4, K5) and one on bf16 pages
   (K6), 40 pages of 64 a slot (inside the window); tok/s and the peak
   allocated memory.
3e. Anyres images (``images_phase``), after the breadth, on the same LM:
   a seeded ViT-L/14 image tower (224, no temporal layers), a seeded
   mlp2x_gelu projector and ``image_newline``, LLaVA-NeXT's pinpoints at
   224; a 640 x 480 and a 300 x 900 PNG (written under
   ``build/images_smoke/``) answer 16 tokens through ``generate`` under
   'spatial_unpad' and 'flat' (TTFT, tok/s, visual tokens; K1 23 launches
   a patch stack, K3 32 a prefill); a depth cut (2 tower and 2 LM layers)
   against the host in f32 (logits rel_l2, the last greedy token); K3 held
   against its plain version at the anyres prefill's lengths; stage-1
   mlp2x_gelu steps on 2 'pad' image rows and on 5 rows packed into one
   2048-token row (loss, ms a step, peak allocated); the paged engine (int8
   pages, 8 slots) admits 8 single-image requests with ``prompt_len`` (the
   RMT-R host formula) and 8 video requests at once, with convoy admission
   and again one request at a time: equal tokens, host readbacks per
   admitting call, admission ms.
3f. The research towers (``towers_phase``): each kind ``resolve_tower``
   gives at its published width and depth, seeded bf16 (ViT-B/16, MAE,
   ViViT 16x2 over 32 frames, VideoMAE over 16, the RMT tower over 8 frames
   (K1 184 launches an encode), DeformCLIP at ViT-L/14, Deformable-DETR
   with ResNet-50 and 6 layers of 256, EgoVLP over 4 frames), under a
   seeded mlp2x_gelu projector of its width: encode ms, visual tokens, 8
   tokens through ``generate`` on the resident LM in a buffer that fits
   them; a 2-layer depth cut of each, card bf16 against host f32 (feature
   rel_l2).
4. Speculative decoding at full depth in bf16: ``Chat.generate_speculative``
   with prompt lookup and with an int8 copy of the LM as the draft, beside
   plain greedy (accepted lengths, rounds, rates, and where the chains part,
   if they do: reported, not asserted, in bf16), and a dense
   ``ServingEngine(speculative="lookup")`` serving three requests.
4a. Training (``train_phase``), before the quantised phase, which
   quantises the bf16 LM and the tower in place: the stage-1 recipe (a new
   f32 projector over the frozen bf16 7B and tower) and the stage-2 QLoRA
   recipe (LoRA r=128, alpha 256, on every projection of the int8 LM, and a
   projector) through ``create_optimizer`` / ``trainable_mask`` /
   ``make_train_step``: B=1, 16 frames and 64 ids spliced into 2048 tokens,
   remat, the chunked attention, one warm-up and 8 timed steps on one batch
   (the loss must fall), one profiled step (kernel ms by kind); the Trainer
   over three in-memory clips, with a checkpoint and a resume that must
   restore the projector, the update count and the generator; the chunked
   attention timed alone; K1 and K2 must launch. Then a depth-cut (2 tower,
   2 LM layers) LoRA + projector step on the card in bf16 against the host
   in f32, both segmented at the host's SceneTilling cuts: loss and
   gradients within the stated tolerances.
5. Quantised weights at full width and depth: the int8 LM
   (``quantize_llama_params``, the ``load_8bit`` route) answers offline
   requests; then the bf16 LM is quantised in place by
   ``quantize_llama_params_int4`` and answers them through ``generate``
   (K1-K3 and K7: 225 launches of K7 per decode step, 7 projections x 32
   layers + lm_head, and none during the 2048-token prefill) and through a
   short run of the paged engine with int8 pages (K4, K5 and K7 in one
   step); then the int8 tower encodes one clip, held against the bf16 tower.
6. Holds the kernel paths against the plain paths on a small input: a
   depth-cut model at full width runs on the card (kernels, bf16) and on
   the host (plain versions, f32) from the same weights, through the
   prefill and through two paged decode steps of each pool type. On the
   host copy (f32, where greedy-exactness is exact) lookup and int8
   self-draft speculation must give plain greedy's tokens, one for one.

7. The multi-GPU training paths (``parallel_phase``) on a one-rank NCCL
   group, on train_reference's depth cut of VideoLLaMB-7B at full width
   (3 tower layers, 2 LM layers; bf16 base, f32 projector): the stage-1 step
   through ``shard_params`` on a (1, 1) mesh and the sharded step, through
   the sequence-parallel factory at one shard and through the pipeline at
   one stage, each against the plain step's loss (rel 2e-3) and projector
   gradients; step ms, peak memory, K1 / K2 launches. The cross-rank
   collectives are checked on the CPU with gloo only. The kernel phase holds
   K1 and K2 at the tensor-parallel widths too: (16, 257, 512) and
   (16, 257, 256), (2, 8, 257, 1536) and (2, 8, 257, 768).
8. EgoVLP's text side (``egovlp_text_phase``): roberta-base (12 x 768, 6
   fusion layers) and the ViT-B/16 fusion tower over 4 frames, seeded bf16,
   gates at 0.5: text and video embeddings, their similarity matrix and an
   ITM fusion forward (timed); a depth cut (4 layers, 2 fused) against the
   host in f32. Then one line for the video reader's backend (native libav
   where it builds, else cv2) and one for a weight-tool round trip
   (``export_hf_checkpoint`` read back through ``load_pretrained_model``).

Prints the card's name and power limit, one JSON line with the kernels'
numbers, and as its last line ``{"ok": true, "device": {...}}``. Exits
non-zero, with no result line, if there is no CUDA device or a check fails.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch

# Tolerances of kernel vs plain version on the card. K1-K3 round their
# outputs to bf16 (relative step 2^-8) and sum in other orders; the flash
# kernel also rounds its probabilities against a running max.
KERNEL_ATOL = 1e-2
KERNEL_RTOL = 2e-2
# K4 and K6 return f32 (m, l) statistics, equal up to summation order; K4's
# output may move by one int8 step of its probability requantisation, which
# a 1-ulp difference in exp can flip; K6 sums bf16 K/V in f32.
STATS_TOL = 1e-5
K4_OUT_TOL = 2e-3  # of max |out|
K6_OUT_TOL = 1e-4  # of max |out|
# With a bf16 query both round K6's output to bf16 once: they part where the
# two f32 sums straddle a rounding edge, by one bf16 step of the value.
K6_BF16_Q_RTOL = 2 ** -7
# K7 and its plain version both sum in f32 and round once to bf16: they part
# only where the two f32 sums straddle a rounding edge, by one bf16 step.
K7_ATOL = 1e-3
K7_RTOL = 2 ** -7
# Main-path shapes of K7 (M, K, N): up_proj in an 8-slot decode step, q_proj
# at B=1, down_proj in a 64-row verify step, lm_head in an 8-slot step.
K7_SHAPES = [(8, 4096, 11008), (1, 4096, 4096), (64, 11008, 4096), (8, 4096, 32000)]
# int8 tower (int8 weights and per-row int8 activations) vs the bf16 tower:
# relative L2 of the select-layer features.
INT8_TOWER_REL_L2 = 0.1
# Kernel path (bf16, card) vs plain path (f32, host) on the depth-cut model:
# relative L2 error of the tower features and of the logits.
PATH_REL_L2 = 5e-2
# The encode path: 32 videos x 8 frames through the full-depth tower. Its
# ablation stacks (the (b, n, t, d) temporal branch through K9, K10 for K2,
# K11 for K1) against the live tower's features, all bf16 on the card:
# relative L2 over 23 layers of bf16 rounding at other places.
ENC_VIDEOS, ENC_T = 32, 8
ENC_FRAMES = ENC_VIDEOS * ENC_T
ENC_LAYERS = 23
ENCODER_REL_L2 = 5e-2
# Gradients of sum(features^2) through a 2-layer full-width tower, kernels in
# bf16 on the card against the plain route in f32 on the host: relative L2 of
# each gradient (bf16 activations and weight gradients).
GRAD_REL_L2 = 5e-2

# H100 SXM peaks (NVIDIA data sheet, dense): device memory and the
# operation rates of the inputs' types.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12}

# Main-path shapes of the paged decode step at 7B, 8 slots (serve/paged.py
# defaults): page 64, 40 pages per slot, 321 pages, 512-token K4 blocks.
PAGE, PPS, POOL_PAGES = 64, 40, 321
PAGED_LENGTHS = [0, 300, 517, 1024, 1500, 2047, 2500, 1777]
# Prefix caching: 8 slots share their first 16 full pages (one cached
# 1024-token prefix) and hold private tail pages, at the lengths of
# questions about one 16-frame video (the features phase's).
SHARED_PAGES = 16
SHARED_LENGTHS = [1166, 1180, 1171, 1190, 1168, 1201, 1176, 1185]
# A frozen grammar row rewound over this many garbage steps.
REWIND = 3
# The LanguageBind audio tower's tokens: a 112 x 1036 mel image in 14-pixel
# patches (8 x 74) and CLS.
AUDIO_TOKENS = 8 * 74 + 1
# The images phase's anyres stack (a 2 x 2 grid of 224-pixel patches and the
# base image) and the RMT tower's sequence (128 read memories + CLS + 256).
ANYRES_PATCHES = 5
RMT_TOKENS = 128 + 257


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters: int = 50) -> float:
    """Host time to enqueue one call (no wait for the card inside the loop): where
    it is close to ``cuda_ms`` of the same call, the host, not the kernel, sets the time."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return ms


def graph_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Device time of one call: ``iters`` calls captured into a CUDA graph and
    replayed, so that the host's enqueue time is out of the measurement."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    return cuda_ms(graph.replay, iters=replays, warmup=1) / iters


def bound(nbytes: float, ops: float, kind: str):
    """(least ms the card could take, what bounds it)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[kind]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def compare(name: str, got: torch.Tensor, want: torch.Tensor, atol: float = KERNEL_ATOL,
            rtol: float = KERNEL_RTOL) -> float:
    got, want = got.float(), want.float()
    finite = torch.isfinite(want)
    if got.shape != want.shape or not torch.equal(torch.isfinite(got), finite):
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)} "
                             "or non-finite entries differ")
    got = torch.where(finite, got, 0.0)
    want = torch.where(finite, want, 0.0)
    err = (got - want).abs()
    max_abs = float(err.max())
    ok = bool((err <= atol + rtol * want.abs()).all())
    print(f"[kernel] {name}: max_abs_err={max_abs:.3e} tol=atol {atol:.3e} + rtol {rtol} "
          f"-> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return max_abs


def _paged_table(lengths, seed: int, shared: int = 0):
    """A table of random pages per slot; with ``shared`` every row maps the
    same first ``shared`` pages (a cached prefix)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    perm = torch.randperm(POOL_PAGES - 1, generator=g) + 1
    table = torch.zeros((len(lengths), PPS), dtype=torch.int32)
    table[:, :shared] = perm[:shared]
    nxt = shared
    for i, n in enumerate(lengths):
        used = -(-n // PAGE)
        table[i, shared:used] = perm[nxt:nxt + used - shared]
        nxt += max(used - shared, 0)
    return table.cuda(), torch.tensor(lengths, dtype=torch.int32, device="cuda")


def kernel_phase(g: torch.Generator, system_len: int) -> dict:
    """Every kernel against its plain version at the main paths' shapes, with
    its time, the plain version's, the library call's and the bound.
    ``system_len``: the stream's system prompt in tokens, the length of every
    prefill ``StreamingSession`` makes."""
    import torch.nn.functional as F

    from videollamb_torch.ops.attention import multihead_attention
    from videollamb_torch.ops.flash_attention import (
        block_attention,
        block_attention_reference,
        flash_attention,
        flash_attention_reference,
    )
    from videollamb_torch.ops.gathered_paged_attention import (
        _pick_ppb,
        gathered_paged_attention_int8,
        gathered_paged_attention_int8_reference,
    )
    from videollamb_torch.ops.int4_matmul import (
        dequantize_int4,
        int4_matmul,
        int4_matmul_reference,
        quantize_int4,
    )
    from videollamb_torch.ops.paged_attention_stats import (
        attend_paged_with_stats_xla,
        paged_attention_with_stats,
    )
    from videollamb_torch.ops.paged_fresh_write import paged_fresh_write, paged_fresh_write_xla
    from videollamb_torch.ops.spatial_attention import (
        fused_spatial_core, fused_spatial_core_packed, spatial_core_packed_reference,
        spatial_core_reference)
    from videollamb_torch.ops.temporal_attention import (
        fused_temporal_core, fused_temporal_core_fm, fused_temporal_core_fm3,
        temporal_core_fm3_reference, temporal_core_fm_reference, temporal_core_reference)

    dev, bf = "cuda", torch.bfloat16
    results = {}

    def randn(*shape, scale=1.0, gen=None):
        return (torch.randn(shape, generator=gen or g, device=dev) * scale).to(bf)

    # The binding tower's shapes draw from a generator of their own, so every
    # later draw of ``g`` (and each later phase's data) is the same as before
    # they were added.
    g_bind = torch.Generator(device=dev).manual_seed(int(g.initial_seed()) + 70)
    g_image = torch.Generator(device=dev).manual_seed(int(g.initial_seed()) + 71)

    def heads(x, h):  # (B, N, h * e) -> (B, h, N, e), contiguous
        b, n, d = x.shape
        return x.reshape(b, n, h, d // h).transpose(1, 2).contiguous()

    # K1: 64 frames x 257 tokens x 16 heads of 64 (the 64-frame request).
    q, k, v = randn(64, 257, 1024, scale=0.125), randn(64, 257, 1024), randn(64, 257, 1024)
    err = compare("spatial (64, 257, 1024)", fused_spatial_core_packed(q, k, v, heads=16),
                  spatial_core_packed_reference(q, k, v, 16))
    q4, k4, v4 = (heads(x, 16) for x in (q, k, v))
    results["spatial_attention"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: fused_spatial_core_packed(q, k, v, heads=16)),
        plain_ms=cuda_ms(lambda: spatial_core_packed_reference(q, k, v, 16)),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=1.0)),
        bound=bound(4 * q.numel() * 2, 4 * 64 * 16 * 257 * 257 * 64, "bf16"))

    # K2: 8 windows x 8 frames x 257 positions, packed [q*s | k | v] of 3 x 1024.
    qkv = torch.cat([randn(8, 8, 257, 1024, scale=0.125), randn(8, 8, 257, 2048)], dim=-1)
    err = compare("temporal (8, 8, 257, 3072)", fused_temporal_core_fm3(qkv, num_heads=16),
                  temporal_core_fm3_reference(qkv, 16))
    # SDPA over frames: (b * n, heads, t, e).
    tq, tk, tv = (qkv[..., i * 1024:(i + 1) * 1024].permute(0, 2, 1, 3).reshape(8 * 257, 8, 1024)
                  for i in range(3))
    tq, tk, tv = (heads(x, 16) for x in (tq, tk, tv))
    results["temporal_attention"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: fused_temporal_core_fm3(qkv, num_heads=16)),
        plain_ms=cuda_ms(lambda: temporal_core_fm3_reference(qkv, 16)),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(tq, tk, tv, scale=1.0)),
        bound=bound(qkv.numel() * 2 + qkv.numel() // 3 * 2, 4 * 8 * 257 * 16 * 8 * 8 * 64,
                    "bf16"))

    # K1 and K2 at the encode path's 256 frames (32 videos x 8), and K8-K11 at
    # that path's shapes: (256, 16, 257, 64) split heads for K8 and K11,
    # (32, 257, 8, 1024) for K9, three (32, 8, 257, 1024) operands for K10.
    f, n, d, h, e = ENC_FRAMES, 257, 1024, 16, 64
    tower_ops = 4 * f * h * n * n * e  # the two products of every (frame, head)
    q, k, v = randn(f, n, d, scale=0.125), randn(f, n, d), randn(f, n, d)
    err = compare(f"spatial ({f}, {n}, {d})", fused_spatial_core_packed(q, k, v, heads=h),
                  spatial_core_packed_reference(q, k, v, h))
    q4, k4, v4 = (heads(x, h) for x in (q, k, v))
    results["spatial_attention"]["shapes"] = [dict(
        shape=[f, n, d], max_abs_err=err,
        ms=cuda_ms(lambda: fused_spatial_core_packed(q, k, v, heads=h)),
        plain_ms=cuda_ms(lambda: spatial_core_packed_reference(q, k, v, h), iters=5),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=1.0)),
        bound=bound(4 * q.numel() * 2, tower_ops, "bf16"))]
    del q, k, v
    err = compare(f"split-layout spatial {tuple(q4.shape)}", fused_spatial_core(q4, k4, v4),
                  spatial_core_reference(q4, k4, v4))
    results["spatial_core"] = dict(
        max_abs_err=err, ms=cuda_ms(lambda: fused_spatial_core(q4, k4, v4)),
        plain_ms=cuda_ms(lambda: spatial_core_reference(q4, k4, v4), iters=5),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=1.0)),
        bound=bound(4 * q4.numel() * 2, tower_ops, "bf16"))
    # K11, non-causal on the same operands with the scale on the scores, then
    # causal at (4, 32, 512, 128) (pairs counted from position 0).
    k11 = []
    qs = (q4.float() * 8).to(bf)  # undo the 1/8 pre-scale: the kernel scales the scores
    for args, causal in (((qs, k4, v4), False),
                         (tuple(randn(4, 32, 512, 128) for _ in range(3)), True)):
        b_, h_, sq, dh = args[0].shape
        err = compare(f"block attention {tuple(args[0].shape)} causal={causal}",
                      block_attention(*args, causal=causal),
                      block_attention_reference(*args, causal=causal))
        pairs = sum(min(i + 1, sq) for i in range(sq)) if causal else sq * sq
        k11.append(dict(
            shape=[b_, h_, sq, dh], causal=causal, max_abs_err=err,
            ms=cuda_ms(lambda: block_attention(*args, causal=causal)),
            plain_ms=cuda_ms(lambda: block_attention_reference(*args, causal=causal), iters=5),
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(*args, is_causal=causal)),
            bound=bound(4 * args[0].numel() * 2, 4 * b_ * h_ * dh * pairs, "bf16")))
    results["block_attention"] = dict(k11[0], max_abs_err=max(r["max_abs_err"] for r in k11),
                                      shapes=k11)
    del q4, k4, v4, qs
    # K1 at the stream's per-tick encodes (``serve/incremental.py``): one frame
    # a tick (also the binding image tower's one image), and a catch-up window
    # of 4 frames; at the 16-frame clips of the LiveInfer, KV-chat and HTTP
    # phases; then at the binding video tower's 8 frames and the binding audio
    # tower's one 112 x 1036 mel image (8 x 74 patches and CLS: N = 593); then
    # at the eval phase's two-image row through the LLM's image tower.
    # Last, at the images phase's anyres patch stack (the base image and a
    # 2 x 2 grid: 5 frames) and at the RMT tower's frame step (128 memories
    # before 257 tokens: N = 385).
    g_res = torch.Generator(device=dev).manual_seed(int(g.initial_seed()) + 72)
    for frames, tokens, gen in ((1, n, g), (4, n, g), (16, n, g), (8, n, g_bind),
                                (1, AUDIO_TOKENS, g_bind), (2, n, g_image),
                                (ANYRES_PATCHES, n, g_res), (1, RMT_TOKENS, g_res)):
        q, k, v = (randn(frames, tokens, d, scale=0.125, gen=gen),
                   randn(frames, tokens, d, gen=gen), randn(frames, tokens, d, gen=gen))
        err = compare(f"spatial ({frames}, {tokens}, {d})",
                      fused_spatial_core_packed(q, k, v, heads=h),
                      spatial_core_packed_reference(q, k, v, h))
        q4, k4, v4 = (heads(x, h) for x in (q, k, v))
        results["spatial_attention"]["shapes"].append(dict(
            shape=[frames, tokens, d], max_abs_err=err,
            ms=cuda_ms(lambda: fused_spatial_core_packed(q, k, v, heads=h)),
            plain_ms=cuda_ms(lambda: spatial_core_packed_reference(q, k, v, h)),
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=1.0)),
            bound=bound(4 * q.numel() * 2, 4 * frames * h * tokens * tokens * e, "bf16")))
    del q, k, v, q4, k4, v4

    # K2 at the encode path's 32 windows, at the 2 windows of the 16-frame
    # LiveInfer, KV-chat and HTTP clips, and at the binding video tower's one.
    t = 8
    results["temporal_attention"]["shapes"] = []
    for b, gen in ((ENC_FRAMES // 8, g), (2, g), (1, g_bind)):
        qkv = torch.cat([randn(b, t, n, d, scale=0.125, gen=gen), randn(b, t, n, 2 * d, gen=gen)],
                        dim=-1)
        err = compare(f"temporal {tuple(qkv.shape)}", fused_temporal_core_fm3(qkv, num_heads=h),
                      temporal_core_fm3_reference(qkv, h))
        tq, tk, tv = (heads(qkv[..., i * d:(i + 1) * d].permute(0, 2, 1, 3)
                            .reshape(b * n, t, d), h) for i in range(3))
        results["temporal_attention"]["shapes"].append(dict(
            shape=list(qkv.shape), max_abs_err=err,
            ms=cuda_ms(lambda: fused_temporal_core_fm3(qkv, num_heads=h)),
            plain_ms=cuda_ms(lambda: temporal_core_fm3_reference(qkv, h), iters=5),
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(tq, tk, tv, scale=1.0)),
            bound=bound(qkv.numel() * 2 + qkv.numel() // 3 * 2, 4 * b * n * h * t * t * e,
                        "bf16")))
    del qkv, tq, tk, tv
    # K1 and K2 at the tensor-parallel widths: under tp 2 and 4 a rank's tower
    # holds 16 / tp heads, so the 16-frame train clip (``parallel_phase``'s
    # batch) gives K1 (16, 257, 1024 / tp) and K2 (2, 8, 257, 3 * 1024 / tp).
    g_tp = torch.Generator(device=dev).manual_seed(int(g.initial_seed()) + 73)
    for tp in (2, 4):
        d_tp, h_tp = d // tp, h // tp
        q, k, v = (randn(16, n, d_tp, scale=0.125, gen=g_tp), randn(16, n, d_tp, gen=g_tp),
                   randn(16, n, d_tp, gen=g_tp))
        err = compare(f"spatial (16, {n}, {d_tp}) tp {tp}",
                      fused_spatial_core_packed(q, k, v, heads=h_tp),
                      spatial_core_packed_reference(q, k, v, h_tp))
        q4, k4, v4 = (heads(x, h_tp) for x in (q, k, v))
        results["spatial_attention"]["shapes"].append(dict(
            shape=[16, n, d_tp], tp=tp, max_abs_err=err,
            ms=cuda_ms(lambda: fused_spatial_core_packed(q, k, v, heads=h_tp)),
            plain_ms=cuda_ms(lambda: spatial_core_packed_reference(q, k, v, h_tp)),
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=1.0)),
            bound=bound(4 * q.numel() * 2, 4 * 16 * h_tp * n * n * e, "bf16")))
        qkv = torch.cat([randn(2, t, n, d_tp, scale=0.125, gen=g_tp),
                         randn(2, t, n, 2 * d_tp, gen=g_tp)], dim=-1)
        err = compare(f"temporal {tuple(qkv.shape)} tp {tp}",
                      fused_temporal_core_fm3(qkv, num_heads=h_tp),
                      temporal_core_fm3_reference(qkv, h_tp))
        tq, tk, tv = (heads(qkv[..., i * d_tp:(i + 1) * d_tp].permute(0, 2, 1, 3)
                            .reshape(2 * n, t, d_tp), h_tp) for i in range(3))
        results["temporal_attention"]["shapes"].append(dict(
            shape=list(qkv.shape), tp=tp, max_abs_err=err,
            ms=cuda_ms(lambda: fused_temporal_core_fm3(qkv, num_heads=h_tp)),
            plain_ms=cuda_ms(lambda: temporal_core_fm3_reference(qkv, h_tp), iters=5),
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(tq, tk, tv, scale=1.0)),
            bound=bound(qkv.numel() * 2 + qkv.numel() // 3 * 2, 4 * 2 * n * h_tp * t * t * e,
                        "bf16")))
    del q, k, v, q4, k4, v4, qkv, tq, tk, tv
    b = ENC_FRAMES // 8
    temporal_ops = 4 * b * n * h * t * t * e
    # K9 on (b, n, t, d) and K10 on three frame-major operands; SDPA over the
    # frames of each (b * n, head) is the library call for both.
    for name, shape, kernel, plain in (
            ("temporal_core", (b, n, t, d), fused_temporal_core, temporal_core_reference),
            ("temporal_core_fm", (b, t, n, d), fused_temporal_core_fm,
             temporal_core_fm_reference)):
        q, k, v = randn(*shape, scale=0.125), randn(*shape), randn(*shape)
        err = compare(f"{name} {shape}", kernel(q, k, v, num_heads=h), plain(q, k, v, h))
        by_pos = (lambda x: x) if kernel is fused_temporal_core else (
            lambda x: x.transpose(1, 2))
        sq_, sk_, sv_ = (heads(by_pos(x).reshape(b * n, t, d), h) for x in (q, k, v))
        results[name] = dict(
            max_abs_err=err, ms=cuda_ms(lambda: kernel(q, k, v, num_heads=h)),
            plain_ms=cuda_ms(lambda: plain(q, k, v, h), iters=5),
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(sq_, sk_, sv_,
                                                                       scale=1.0)),
            bound=bound(4 * q.numel() * 2, temporal_ops, "bf16"))
        del q, k, v, sq_, sk_, sv_
    torch.cuda.empty_cache()

    # K3: LM prefill (B, 32, 2048, 128), causal, padded key tails.
    errs = []
    for b, valid in ((1, [1400]), (2, [1400, 1873])):
        q, k, v = (randn(b, 32, 2048, 128) for _ in range(3))
        mask = torch.arange(2048, device=dev)[None] < torch.tensor(valid, device=dev)[:, None]
        errs.append(compare(f"flash ({b}, 32, 2048, 128) causal, valid keys {valid}",
                            flash_attention(q, k, v, mask, causal=True),
                            flash_attention_reference(q, k, v, mask, causal=True)))
        if b == 1:
            causal = torch.ones((2048, 2048), dtype=torch.bool, device=dev).tril()
            sdpa_mask = (causal & mask[:, None, :])[:, None]  # (1, 1, 2048, 2048)
            pairs = sum(min(i + 1, valid[0]) for i in range(2048))
            results["flash_attention"] = dict(
                ms=cuda_ms(lambda: flash_attention(q, k, v, mask, causal=True)),
                plain_ms=cuda_ms(lambda: flash_attention_reference(q, k, v, mask, causal=True)),
                library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=sdpa_mask)),
                bound=bound(4 * q.numel() * 2 + 2048, 4 * 32 * 128 * pairs, "bf16"))
    # The same call as the prefill makes it: multihead_attention on the
    # (B, S, H, Dh) projections, whose transposed views K3 takes without a
    # copy; SDPA on the same views with the bool mask beside it.
    q, k, v = (randn(1, 2048, 32, 128) for _ in range(3))
    mask = torch.arange(2048, device=dev)[None] < 1400
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa_mask = (causal & mask[:, None, :])[:, None]
    got = multihead_attention(q, k, v, causal=True, k_mask=mask)
    errs.append(compare("flash through multihead_attention (1, 2048, 32, 128), valid keys "
                        "[1400]", got, flash_attention_reference(qt, kt, vt, mask, causal=True)
                        .transpose(1, 2)))
    if not got.is_contiguous():
        raise AssertionError("multihead_attention: the kernel's output is not (B, S, H, Dh)")
    results["flash_attention"]["shapes"] = [dict(
        shape=[1, 2048, 32, 128], layout="(B, S, H, Dh) projections through "
        "multihead_attention", max_abs_err=errs[-1],
        ms=cuda_ms(lambda: multihead_attention(q, k, v, causal=True, k_mask=mask)),
        plain_ms=cuda_ms(lambda: flash_attention_reference(qt, kt, vt, mask, causal=True)),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                  attn_mask=sdpa_mask)),
        bound=results["flash_attention"]["bound"])]
    # The stream's system prefill: Sq = Skv = system_len (under one tile),
    # causal, every key valid, as ``llama_prefill`` calls it.
    s_ = system_len
    q, k, v = (randn(1, s_, 32, 128) for _ in range(3))
    mask = torch.ones((1, s_), dtype=torch.bool, device=dev)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    errs.append(compare(f"flash through multihead_attention (1, {s_}, 32, 128), all keys valid",
                        multihead_attention(q, k, v, causal=True, k_mask=mask),
                        flash_attention_reference(qt, kt, vt, mask, causal=True)
                        .transpose(1, 2)))
    results["flash_attention"]["shapes"].append(dict(
        shape=[1, s_, 32, 128], layout="(B, S, H, Dh) projections through "
        "multihead_attention; the stream's system prefill", max_abs_err=errs[-1],
        ms=cuda_ms(lambda: multihead_attention(q, k, v, causal=True, k_mask=mask)),
        plain_ms=cuda_ms(lambda: flash_attention_reference(qt, kt, vt, mask, causal=True)),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)),
        bound=bound(4 * q.numel() * 2 + s_, 4 * 32 * 128 * s_ * (s_ + 1) // 2, "bf16")))
    del q, k, v, qt, kt, vt
    # Mistral's sliding window through multihead_attention on the (1, S, 32,
    # 128) projections, every key valid: a band of 1024 at 4096 tokens, and a
    # window of 4096 at 2048 tokens, which does not bite (today's kernel).
    # SDPA with the band as a bool mask beside it; the bound counts the
    # band's own pairs.
    for s_, window in ((4096, 1024), (2048, 4096)):
        q, k, v = (randn(1, s_, 32, 128) for _ in range(3))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        pos = torch.arange(s_, device=dev)
        band = (pos[:, None] >= pos[None]) & (pos[:, None] - pos[None] < window)
        errs.append(compare(f"flash through multihead_attention (1, {s_}, 32, 128), window "
                            f"{window}", multihead_attention(q, k, v, causal=True, window=window),
                            flash_attention_reference(qt, kt, vt, causal=True, window=window)
                            .transpose(1, 2)))
        pairs = sum(min(i + 1, window) for i in range(s_))
        results["flash_attention"]["shapes"].append(dict(
            shape=[1, s_, 32, 128], window=window, layout="(B, S, H, Dh) projections through "
            "multihead_attention; Mistral's sliding window, all keys valid",
            max_abs_err=errs[-1],
            ms=cuda_ms(lambda: multihead_attention(q, k, v, causal=True, window=window)),
            plain_ms=cuda_ms(lambda: flash_attention_reference(qt, kt, vt, causal=True,
                                                               window=window), iters=5),
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                      attn_mask=band)),
            bound=bound(4 * q.numel() * 2, 4 * 32 * 128 * pairs, "bf16")))
        del q, k, v, qt, kt, vt, band
    torch.cuda.empty_cache()
    results["flash_attention"]["max_abs_err"] = max(errs)

    # K4-K6: one decode step's attention and install at 7B, 8 slots, ragged
    # lengths with a zero-length slot; the int8 pools hold all 32 layers.
    n_slots, layers, h, dh = len(PAGED_LENGTHS), 32, 32, 128
    kd, tokens = h * dh, sum(PAGED_LENGTHS)
    table, lens = _paged_table(PAGED_LENGTHS, seed=5)
    pools = [torch.randint(-128, 128, (layers, POOL_PAGES, PAGE, kd), generator=g, device=dev,
                           dtype=torch.int8) for _ in range(2)]
    scales = [torch.rand((POOL_PAGES, PAGE, h), generator=g, device=dev) * 0.1 + 1e-3
              for _ in range(2)]
    q = torch.randn((n_slots, h, dh), generator=g, device=dev) * dh ** -0.5
    ppb, layer = _pick_ppb(PPS, PAGE), 7
    args = (q, pools[0][layer], pools[1][layer], table, lens, *scales)
    got = gathered_paged_attention_int8(*args, pages_per_block=ppb)
    want = gathered_paged_attention_int8_reference(*args, pages_per_block=ppb)
    errs = [compare("gathered int8 m", got[1], want[1], STATS_TOL, STATS_TOL),
            compare("gathered int8 l", got[2], want[2], STATS_TOL, STATS_TOL),
            compare("gathered int8 out (8, 32, 128), ragged to 2500 tokens", got[0], want[0],
                    K4_OUT_TOL * float(want[0].abs().max()), 0.0)]
    k4_bytes = lambda n_tok, n_slots: (n_tok * (2 * kd + 2 * h * 4) + 2 * n_slots * h * dh * 4
                                       + 2 * n_slots * h * 4 + n_slots * PPS * 4)
    results["gathered_paged_attention"] = dict(
        max_abs_err=max(errs),
        ms=cuda_ms(lambda: gathered_paged_attention_int8(*args, pages_per_block=ppb)),
        plain_ms=cuda_ms(lambda: gathered_paged_attention_int8_reference(
            *args, pages_per_block=ppb)),
        library_ms=None,
        bound=bound(k4_bytes(tokens, n_slots), 4 * tokens * h * dh, "int8"),
        # The enqueue alone, and the device time of calls replayed from a CUDA
        # graph (each captured call zeroes merge counters of its own).
        host_ms=host_ms(lambda: gathered_paged_attention_int8(*args, pages_per_block=ppb)),
        device_ms=graph_ms(lambda: gathered_paged_attention_int8(*args, pages_per_block=ppb)))
    # One slot of 1191 tokens (a 16-frame request after admission): three
    # live blocks a kv head, 96 in all.
    t1, l1 = _paged_table([1191], seed=6)
    a1 = (q[:1], pools[0][layer], pools[1][layer], t1, l1, *scales)
    got = gathered_paged_attention_int8(*a1, pages_per_block=ppb)
    want = gathered_paged_attention_int8_reference(*a1, pages_per_block=ppb)
    errs = [compare("gathered int8 m, one slot of 1191", got[1], want[1], STATS_TOL, STATS_TOL),
            compare("gathered int8 l, one slot of 1191", got[2], want[2], STATS_TOL, STATS_TOL),
            compare("gathered int8 out (1, 32, 128), 1191 tokens", got[0], want[0],
                    K4_OUT_TOL * float(want[0].abs().max()), 0.0)]
    results["gathered_paged_attention"]["shapes"] = [dict(
        shape=[1, h, dh], lengths=[1191], max_abs_err=max(errs),
        ms=cuda_ms(lambda: gathered_paged_attention_int8(*a1, pages_per_block=ppb)),
        plain_ms=cuda_ms(lambda: gathered_paged_attention_int8_reference(
            *a1, pages_per_block=ppb)),
        library_ms=None, bound=bound(k4_bytes(1191, 1), 4 * 1191 * h * dh, "int8"),
        host_ms=host_ms(lambda: gathered_paged_attention_int8(*a1, pages_per_block=ppb)),
        device_ms=graph_ms(lambda: gathered_paged_attention_int8(*a1, pages_per_block=ppb)))]
    # Lengths past the table's width (40 x 64 = 2560 tokens) count as the
    # width; the merge counters come back to 0, so normal calls after them
    # stay right, twice each.
    over = lens.clone()
    over[1], over[6] = PPS * PAGE + 77, 10 ** 6
    for label, lengths in (("past the table's width", over), ("normal", lens),
                           ("normal, again", lens)):
        la = (q, pools[0][layer], pools[1][layer], table, lengths, *scales)
        got = gathered_paged_attention_int8(*la, pages_per_block=ppb)
        want = gathered_paged_attention_int8_reference(*la, pages_per_block=ppb)
        errs.append(compare(f"gathered int8 m, lengths {label}", got[1], want[1], STATS_TOL,
                            STATS_TOL))
        errs.append(compare(f"gathered int8 l, lengths {label}", got[2], want[2], STATS_TOL,
                            STATS_TOL))
        errs.append(compare(f"gathered int8 out, lengths {label}", got[0], want[0],
                            K4_OUT_TOL * float(want[0].abs().max()), 0.0))
    results["gathered_paged_attention"]["max_abs_err"] = max(
        results["gathered_paged_attention"]["max_abs_err"], *errs)
    for r in (results["gathered_paged_attention"],
              *results["gathered_paged_attention"]["shapes"]):
        print(f"[kernel] gathered_paged_attention lengths {r.get('lengths', PAGED_LENGTHS)}: "
              f"kernel {r['ms']:.4f} ms (host enqueue {r['host_ms']:.4f} ms; replayed from a "
              f"CUDA graph {r['device_ms']:.4f} ms), bound {r['bound'][0]:.4f} ms "
              f"({r['bound'][1]})")

    # K5: install 8 slots' rows of all 32 layers; two slots on the trash page.
    fresh = [torch.randint(-128, 128, (layers, n_slots, kd), generator=g, device=dev,
                           dtype=torch.int8) for _ in range(2)]
    write_page = table[torch.arange(n_slots, device=dev), (lens.long() // PAGE).clamp(max=PPS - 1)]
    write_off = lens % PAGE
    want = paged_fresh_write_xla(*(p.clone() for p in pools), *fresh, write_page, write_off)
    got = paged_fresh_write(*pools, *fresh, write_page, write_off)
    torch.cuda.synchronize()
    for name, a, w in (("K", got[0], want[0]), ("V", got[1], want[1])):
        if not torch.equal(a[:, 1:], w[:, 1:]):
            raise AssertionError(f"fresh write: {name} pool differs outside page 0")
    print("[kernel] fresh write (32, 321, 64, 4096) x 8 slots: equal outside page 0 -> ok")
    del want
    flat = [p.view(layers, POOL_PAGES * PAGE, kd) for p in pools]
    rows = (torch.arange(layers, device=dev)[:, None], (write_page * PAGE + write_off)[None].long())

    def library_write():
        for pool, rows_in in zip(flat, fresh):
            pool.index_put_(rows, rows_in)

    results["paged_fresh_write"] = dict(
        max_abs_err=0.0,
        ms=cuda_ms(lambda: paged_fresh_write(*pools, *fresh, write_page, write_off)),
        plain_ms=cuda_ms(lambda: paged_fresh_write_xla(*pools, *fresh, write_page, write_off)),
        library_ms=cuda_ms(library_write),
        bound=bound(4 * layers * n_slots * kd + 2 * n_slots * 4, 0, "int8"),
        host_ms=host_ms(lambda: paged_fresh_write(*pools, *fresh, write_page, write_off)),
        device_ms=graph_ms(lambda: paged_fresh_write(*pools, *fresh, write_page, write_off)))
    r = results["paged_fresh_write"]
    print(f"[kernel] paged_fresh_write: kernel {r['ms']:.4f} ms (host enqueue "
          f"{r['host_ms']:.4f} ms; replayed from a CUDA graph {r['device_ms']:.4f} ms), bound "
          f"{r['bound'][0]:.4f} ms ({r['bound'][1]})")

    # Prefix caching: K4 over 8 slots that share their first 16 full pages.
    # The bound reads the shared pages once.
    stab, slens = _paged_table(SHARED_LENGTHS, seed=7, shared=SHARED_PAGES)
    sa = (q, pools[0][layer], pools[1][layer], stab, slens, *scales)
    got = gathered_paged_attention_int8(*sa, pages_per_block=ppb)
    want = gathered_paged_attention_int8_reference(*sa, pages_per_block=ppb)
    label = f"{SHARED_PAGES} shared pages, lengths {SHARED_LENGTHS}"
    errs = [compare(f"gathered int8 m, {label}", got[1], want[1], STATS_TOL, STATS_TOL),
            compare(f"gathered int8 l, {label}", got[2], want[2], STATS_TOL, STATS_TOL),
            compare(f"gathered int8 out, {label}", got[0], want[0],
                    K4_OUT_TOL * float(want[0].abs().max()), 0.0)]
    s_tokens = sum(SHARED_LENGTHS)
    s_unique = s_tokens - (n_slots - 1) * SHARED_PAGES * PAGE
    shared_row = dict(
        shape=[n_slots, h, dh], lengths=SHARED_LENGTHS, shared_pages=SHARED_PAGES,
        max_abs_err=max(errs),
        ms=cuda_ms(lambda: gathered_paged_attention_int8(*sa, pages_per_block=ppb)),
        plain_ms=cuda_ms(lambda: gathered_paged_attention_int8_reference(
            *sa, pages_per_block=ppb)),
        library_ms=None, bound=bound(k4_bytes(s_unique, n_slots), 4 * s_tokens * h * dh, "int8"),
        host_ms=host_ms(lambda: gathered_paged_attention_int8(*sa, pages_per_block=ppb)),
        device_ms=graph_ms(lambda: gathered_paged_attention_int8(*sa, pages_per_block=ppb)))
    results["gathered_paged_attention"]["shapes"].append(shared_row)

    # K5 over rewound rows: every slot writes three garbage steps past its
    # length, slot 3 is rewound by 3 (a frozen grammar row), the others move
    # on; the next write lands on slot 3's first garbage row; then K4 reads
    # lengths + 1. Held against the plain write and the plain attention.
    rtab, _ = _paged_table([n + REWIND + 1 for n in SHARED_LENGTHS], seed=8,
                           shared=SHARED_PAGES)
    rlens = torch.tensor(SHARED_LENGTHS, dtype=torch.int32, device=dev)
    rows = torch.arange(n_slots, device=dev)
    plain_pools = [p.clone() for p in pools]

    def rows_at(pos):
        pos = pos.long()
        return rtab[rows, pos // PAGE], (pos % PAGE).int()

    steps = [torch.randint(-128, 128, (REWIND + 1, layers, n_slots, kd), generator=g,
                           device=dev, dtype=torch.int8) for _ in range(2)]
    for step in range(REWIND):
        for kernel, target in ((paged_fresh_write, pools), (paged_fresh_write_xla, plain_pools)):
            kernel(*target, steps[0][step], steps[1][step], *rows_at(rlens + step))
    rewound = rlens + REWIND
    rewound[3] -= REWIND
    wp, wo = rows_at(rewound)
    paged_fresh_write(*pools, steps[0][REWIND], steps[1][REWIND], wp, wo)
    paged_fresh_write_xla(*plain_pools, steps[0][REWIND], steps[1][REWIND], wp, wo)
    torch.cuda.synchronize()
    for name, a, w in (("K", pools[0], plain_pools[0]), ("V", pools[1], plain_pools[1])):
        if not torch.equal(a[:, 1:], w[:, 1:]):
            raise AssertionError(f"fresh write over rewound rows: {name} pool differs")
    del plain_pools
    ra = (q, pools[0][layer], pools[1][layer], rtab, rewound + 1, *scales)
    got = gathered_paged_attention_int8(*ra, pages_per_block=ppb)
    want = gathered_paged_attention_int8_reference(*ra, pages_per_block=ppb)
    label = f"after a write over slot 3 rewound by {REWIND}"
    errs = [compare(f"gathered int8 m, {label}", got[1], want[1], STATS_TOL, STATS_TOL),
            compare(f"gathered int8 l, {label}", got[2], want[2], STATS_TOL, STATS_TOL),
            compare(f"gathered int8 out, {label}", got[0], want[0],
                    K4_OUT_TOL * float(want[0].abs().max()), 0.0)]
    r_tokens = int((rewound + 1).sum())
    results["gathered_paged_attention"]["shapes"].append(dict(
        shape=[n_slots, h, dh], lengths=(rewound + 1).tolist(), shared_pages=SHARED_PAGES,
        rewound_slot=3, max_abs_err=max(errs),
        ms=cuda_ms(lambda: gathered_paged_attention_int8(*ra, pages_per_block=ppb)),
        plain_ms=cuda_ms(lambda: gathered_paged_attention_int8_reference(
            *ra, pages_per_block=ppb)),
        library_ms=None,
        bound=bound(k4_bytes(r_tokens - (n_slots - 1) * SHARED_PAGES * PAGE, n_slots),
                    4 * r_tokens * h * dh, "int8"),
        host_ms=host_ms(lambda: gathered_paged_attention_int8(*ra, pages_per_block=ppb)),
        device_ms=graph_ms(lambda: gathered_paged_attention_int8(*ra, pages_per_block=ppb))))
    print(f"[kernel] fresh write of 3 garbage steps, slot 3 rewound by {REWIND}, one more "
          "write: equal to the plain writes outside page 0 -> ok")
    rflat = (torch.arange(layers, device=dev)[:, None], (wp * PAGE + wo)[None].long())
    rk, rv = steps[0][REWIND], steps[1][REWIND]

    def library_rewound():
        for pool, rows_in in zip(flat, (rk, rv)):
            pool.index_put_(rflat, rows_in)

    results["paged_fresh_write"]["shapes"] = [dict(
        shape=[layers, POOL_PAGES, PAGE, kd], slots=n_slots, rewound_slot=3, rewind=REWIND,
        max_abs_err=0.0,
        ms=cuda_ms(lambda: paged_fresh_write(*pools, rk, rv, wp, wo)),
        plain_ms=cuda_ms(lambda: paged_fresh_write_xla(*pools, rk, rv, wp, wo)),
        library_ms=cuda_ms(library_rewound),
        bound=bound(4 * layers * n_slots * kd + 2 * n_slots * 4, 0, "int8"),
        host_ms=host_ms(lambda: paged_fresh_write(*pools, rk, rv, wp, wo)),
        device_ms=graph_ms(lambda: paged_fresh_write(*pools, rk, rv, wp, wo)))]
    del pools, flat, fresh, steps

    # K6: one layer of the bf16 head-major pool.
    k6 = [torch.randn((h, POOL_PAGES, PAGE, dh), generator=g, device=dev).to(bf)
          for _ in range(2)]
    got = paged_attention_with_stats(q, *k6, lens, table)
    want = attend_paged_with_stats_xla(q, *k6, table, lens)
    errs = [compare("paged bf16 m", got[1], want[1], STATS_TOL, STATS_TOL),
            compare("paged bf16 l", got[2], want[2], STATS_TOL, STATS_TOL),
            compare("paged bf16 out (8, 32, 128), ragged to 2500 tokens", got[0], want[0],
                    K6_OUT_TOL * float(want[0].abs().max()), 0.0)]
    results["paged_attention_stats"] = dict(
        max_abs_err=max(errs),
        ms=cuda_ms(lambda: paged_attention_with_stats(q, *k6, lens, table)),
        plain_ms=cuda_ms(lambda: attend_paged_with_stats_xla(q, *k6, table, lens)),
        library_ms=None,
        bound=bound(tokens * h * dh * 2 * 2 + 2 * q.numel() * 4 + 2 * n_slots * h * 4
                    + table.numel() * 4, 4 * tokens * h * dh, "bf16"))
    # Its event time can be the host's enqueue time: also the enqueue alone,
    # and the device time of calls replayed from a CUDA graph (each captured
    # call zeroes merge counters of its own: a memset node beside the kernel).
    results["paged_attention_stats"].update(
        host_ms=host_ms(lambda: paged_attention_with_stats(q, *k6, lens, table)),
        device_ms=graph_ms(lambda: paged_attention_with_stats(q, *k6, lens, table)))
    # The paged step's own call: a bf16 query, int32 lengths.
    qb = q.to(bf)
    got_b = paged_attention_with_stats(qb, *k6, lens, table)[0]
    want_b = attend_paged_with_stats_xla(qb, *k6, table, lens)[0]
    results["paged_attention_stats"]["shapes"] = [dict(
        shape=[n_slots, h, dh], q_dtype="bfloat16", max_abs_err=compare(
            "paged bf16 out, bf16 q", got_b, want_b,
            K6_OUT_TOL * float(want_b.abs().max()), K6_BF16_Q_RTOL),
        ms=cuda_ms(lambda: paged_attention_with_stats(qb, *k6, lens, table)),
        host_ms=host_ms(lambda: paged_attention_with_stats(qb, *k6, lens, table)),
        device_ms=graph_ms(lambda: paged_attention_with_stats(qb, *k6, lens, table)),
        plain_ms=cuda_ms(lambda: attend_paged_with_stats_xla(qb, *k6, table, lens)),
        library_ms=None, bound=results["paged_attention_stats"]["bound"])]
    for r in (results["paged_attention_stats"], *results["paged_attention_stats"]["shapes"]):
        print(f"[kernel] paged_attention_stats q {'bf16' if 'q_dtype' in r else 'f32'}: kernel "
              f"{r['ms']:.4f} ms (host enqueue {r['host_ms']:.4f} ms; replayed from a CUDA "
              f"graph {r['device_ms']:.4f} ms), bound {r['bound'][0]:.4f} ms ({r['bound'][1]})")
    # Prefix caching: K6 over the same shared-page table, with an f32 query
    # (the tolerances of K6's first row) and with the paged step's bf16 query
    # (those of its bf16-q row). The bound reads the shared pages once.
    got = paged_attention_with_stats(q, *k6, slens, stab)
    want = attend_paged_with_stats_xla(q, *k6, stab, slens)
    got_sb = paged_attention_with_stats(qb, *k6, slens, stab)[0]
    want_sb = attend_paged_with_stats_xla(qb, *k6, stab, slens)[0]
    label = f"{SHARED_PAGES} shared pages, lengths {SHARED_LENGTHS}"
    errs = [compare(f"paged bf16 m, {label}", got[1], want[1], STATS_TOL, STATS_TOL),
            compare(f"paged bf16 l, {label}", got[2], want[2], STATS_TOL, STATS_TOL),
            compare(f"paged bf16 out, {label}", got[0], want[0],
                    K6_OUT_TOL * float(want[0].abs().max()), 0.0),
            compare(f"paged bf16 out, bf16 q, {label}", got_sb, want_sb,
                    K6_OUT_TOL * float(want_sb.abs().max()), K6_BF16_Q_RTOL)]
    # Where a bf16 q's error comes from: K6 fed the same q values in f32,
    # against its plain version (a kernel check), and how much of the bf16-q
    # output is that f32 output rounded once to bf16.
    for name, tb, ln, got_q in (("", table, lens, got_b), (f", {label}", stab, slens, got_sb)):
        out_f = paged_attention_with_stats(qb.float(), *k6, ln, tb)[0]
        want_f = attend_paged_with_stats_xla(qb.float(), *k6, tb, ln)[0]
        errs.append(compare(f"paged bf16 out, f32 q of bf16 values{name}", out_f, want_f,
                            K6_OUT_TOL * float(want_f.abs().max()), 0.0))
        same = float((got_q == out_f.to(bf)).float().mean())
        print(f"[kernel] paged bf16 out, bf16 q{name}: {same:.6f} of the entries equal the "
              "f32-q output of the same values rounded once to bf16")
    results["paged_attention_stats"]["shapes"].append(dict(
        shape=[n_slots, h, dh], q_dtype="bfloat16", lengths=SHARED_LENGTHS,
        shared_pages=SHARED_PAGES, max_abs_err=max(errs),
        ms=cuda_ms(lambda: paged_attention_with_stats(qb, *k6, slens, stab)),
        host_ms=host_ms(lambda: paged_attention_with_stats(qb, *k6, slens, stab)),
        device_ms=graph_ms(lambda: paged_attention_with_stats(qb, *k6, slens, stab)),
        plain_ms=cuda_ms(lambda: attend_paged_with_stats_xla(qb, *k6, stab, slens)),
        library_ms=None,
        bound=bound(s_unique * h * dh * 2 * 2 + 2 * qb.numel() * 4 + 2 * n_slots * h * 4
                    + stab.numel() * 4, 4 * s_tokens * h * dh, "bf16")))
    for r in (shared_row, results["gathered_paged_attention"]["shapes"][-1],
              results["paged_fresh_write"]["shapes"][0],
              results["paged_attention_stats"]["shapes"][-1]):
        print(f"[kernel] {r.get('lengths', r['shape'])}"
              f"{' rewound slot 3' if 'rewound_slot' in r else ''}: kernel {r['ms']:.4f} ms "
              f"(host enqueue {r['host_ms']:.4f} ms; replayed from a CUDA graph "
              f"{r['device_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound'][0]:.4f} ms ({r['bound'][1]})")
    del k6
    # K6 where its splits meet (256 tokens): lengths on, just under and just
    # over a boundary, one token, none, a table not a multiple of the split,
    # G = 8 on pages of 16; lengths past the table's 576 tokens, which count
    # as 576; twice each, the merge counters reset in between.
    for hh, hkv, pg, pps, lengths in ((32, 32, 64, 9, [700, 576, 5000, 300]),
                                      (32, 32, 64, 9, [256, 255, 257, 512, 513, 1, 0, 576]),
                                      (32, 4, 16, 40, [640, 1, 0, 257, 639, 300])):
        bt, pt = len(lengths), 1 + len(lengths) * pps
        kv = [torch.randn((hkv, pt, pg, dh), generator=g, device=dev).to(bf)
              for _ in range(2)]
        qq = torch.randn((bt, hh, dh), generator=g, device=dev) * dh ** -0.5
        gen = torch.Generator(device="cpu").manual_seed(pps)
        perm = torch.randperm(pt - 1, generator=gen) + 1
        tb = torch.zeros((bt, pps), dtype=torch.int32)
        for i, n in enumerate(lengths):
            used = min(-(-n // pg), pps)
            tb[i, :used] = perm[i * pps:i * pps + used]
        tb, ln = tb.to(dev), torch.tensor(lengths, dtype=torch.int32, device=dev)
        want = attend_paged_with_stats_xla(qq, *kv, tb, ln)
        for rep in range(2):
            got = paged_attention_with_stats(qq, *kv, ln, tb)
            label = f"paged bf16 G={hh // hkv} page {pg} lengths {lengths} (call {rep + 1})"
            errs.append(compare(f"{label} m", got[1], want[1], STATS_TOL, STATS_TOL))
            errs.append(compare(f"{label} l", got[2], want[2], STATS_TOL, STATS_TOL))
            errs.append(compare(f"{label} out", got[0], want[0],
                                K6_OUT_TOL * float(want[0].abs().max()), 0.0))
            zero = ln == 0
            if got[0][zero].any() or not torch.isneginf(got[1][zero]).all() or got[2][zero].any():
                raise AssertionError("paged bf16: a zero-length slot is not (0, -inf, 0)")
    results["paged_attention_stats"]["max_abs_err"] = max(errs)

    # K3-K6 at the tensor-parallel widths: under tp 2 and 4 a rank of the
    # sharded 7B LM holds 32 / tp query and kv heads, so the prefill gives K3
    # (1, 2048, 32 / tp, 128) and a paged decode step of 8 slots gives K4 and
    # K6 a (8, 32 / tp, 128) query over pools of 32 / tp heads, and K5 rows
    # of 4096 / tp bytes. Operands from a generator of their own.
    g_tp = torch.Generator(device=dev).manual_seed(int(g.initial_seed()) + 74)
    for tp in (2, 4):
        h_tp = h // tp
        kd_tp = h_tp * dh
        # K3 through multihead_attention on the (B, S, H, Dh) projections.
        q3, k3, v3 = (randn(1, 2048, h_tp, 128, gen=g_tp) for _ in range(3))
        mask = torch.arange(2048, device=dev)[None] < 1400
        qt, kt, vt = (x.transpose(1, 2) for x in (q3, k3, v3))
        sdpa_mask = (causal & mask[:, None, :])[:, None]
        err = compare(f"flash through multihead_attention (1, 2048, {h_tp}, 128) tp {tp}, "
                      "valid keys [1400]",
                      multihead_attention(q3, k3, v3, causal=True, k_mask=mask),
                      flash_attention_reference(qt, kt, vt, mask, causal=True).transpose(1, 2))
        pairs = sum(min(i + 1, 1400) for i in range(2048))
        results["flash_attention"]["shapes"].append(dict(
            shape=[1, 2048, h_tp, 128], tp=tp, layout="(B, S, H, Dh) projections through "
            "multihead_attention", max_abs_err=err,
            ms=cuda_ms(lambda: multihead_attention(q3, k3, v3, causal=True, k_mask=mask)),
            plain_ms=cuda_ms(lambda: flash_attention_reference(qt, kt, vt, mask, causal=True)),
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                      attn_mask=sdpa_mask)),
            bound=bound(4 * q3.numel() * 2 + 2048, 4 * h_tp * 128 * pairs, "bf16")))
        results["flash_attention"]["max_abs_err"] = max(
            results["flash_attention"]["max_abs_err"], err)
        del q3, k3, v3, qt, kt, vt
        # K4 over one layer of int8 pools of h_tp heads, K5 over all 32 layers.
        pools = [torch.randint(-128, 128, (layers, POOL_PAGES, PAGE, kd_tp), generator=g_tp,
                               device=dev, dtype=torch.int8) for _ in range(2)]
        sc = [torch.rand((POOL_PAGES, PAGE, h_tp), generator=g_tp, device=dev) * 0.1 + 1e-3
              for _ in range(2)]
        qf = torch.randn((n_slots, h_tp, dh), generator=g_tp, device=dev) * dh ** -0.5
        a4 = (qf, pools[0][layer], pools[1][layer], table, lens, *sc)
        got = gathered_paged_attention_int8(*a4, pages_per_block=ppb)
        want = gathered_paged_attention_int8_reference(*a4, pages_per_block=ppb)
        err = max(compare(f"gathered int8 m tp {tp}", got[1], want[1], STATS_TOL, STATS_TOL),
                  compare(f"gathered int8 l tp {tp}", got[2], want[2], STATS_TOL, STATS_TOL),
                  compare(f"gathered int8 out ({n_slots}, {h_tp}, {dh}) tp {tp}", got[0],
                          want[0], K4_OUT_TOL * float(want[0].abs().max()), 0.0))
        k4_tp_bytes = (tokens * (2 * kd_tp + 2 * h_tp * 4) + 2 * qf.numel() * 4
                       + 2 * n_slots * h_tp * 4 + table.numel() * 4)
        results["gathered_paged_attention"]["shapes"].append(dict(
            shape=[n_slots, h_tp, dh], tp=tp, lengths=PAGED_LENGTHS, max_abs_err=err,
            ms=cuda_ms(lambda: gathered_paged_attention_int8(*a4, pages_per_block=ppb)),
            plain_ms=cuda_ms(lambda: gathered_paged_attention_int8_reference(
                *a4, pages_per_block=ppb)),
            library_ms=None, bound=bound(k4_tp_bytes, 4 * tokens * h_tp * dh, "int8"),
            host_ms=host_ms(lambda: gathered_paged_attention_int8(*a4, pages_per_block=ppb)),
            device_ms=graph_ms(lambda: gathered_paged_attention_int8(*a4, pages_per_block=ppb))))
        results["gathered_paged_attention"]["max_abs_err"] = max(
            results["gathered_paged_attention"]["max_abs_err"], err)
        fresh = [torch.randint(-128, 128, (layers, n_slots, kd_tp), generator=g_tp, device=dev,
                               dtype=torch.int8) for _ in range(2)]
        want = paged_fresh_write_xla(*(p.clone() for p in pools), *fresh, write_page, write_off)
        got = paged_fresh_write(*pools, *fresh, write_page, write_off)
        torch.cuda.synchronize()
        for name, a, w in (("K", got[0], want[0]), ("V", got[1], want[1])):
            if not torch.equal(a[:, 1:], w[:, 1:]):
                raise AssertionError(f"fresh write tp {tp}: {name} pool differs outside page 0")
        del want, got
        tp_flat = [p.view(layers, POOL_PAGES * PAGE, kd_tp) for p in pools]
        tp_rows = (torch.arange(layers, device=dev)[:, None],
                   (write_page * PAGE + write_off)[None].long())

        def library_write_tp():
            for pool, rows_in in zip(tp_flat, fresh):
                pool.index_put_(tp_rows, rows_in)

        results["paged_fresh_write"]["shapes"].append(dict(
            shape=[layers, POOL_PAGES, PAGE, kd_tp], tp=tp, slots=n_slots, max_abs_err=0.0,
            ms=cuda_ms(lambda: paged_fresh_write(*pools, *fresh, write_page, write_off)),
            plain_ms=cuda_ms(lambda: paged_fresh_write_xla(*pools, *fresh, write_page,
                                                           write_off)),
            library_ms=cuda_ms(library_write_tp),
            bound=bound(4 * layers * n_slots * kd_tp + 2 * n_slots * 4, 0, "int8"),
            host_ms=host_ms(lambda: paged_fresh_write(*pools, *fresh, write_page, write_off)),
            device_ms=graph_ms(lambda: paged_fresh_write(*pools, *fresh, write_page,
                                                         write_off))))
        del pools, tp_flat, fresh
        # K6 over one layer of the bf16 head-major pool of h_tp heads, with the
        # paged step's bf16 query.
        k6_tp = [torch.randn((h_tp, POOL_PAGES, PAGE, dh), generator=g_tp, device=dev).to(bf)
                 for _ in range(2)]
        qb_tp = qf.to(bf)
        got = paged_attention_with_stats(qb_tp, *k6_tp, lens, table)
        want = attend_paged_with_stats_xla(qb_tp, *k6_tp, table, lens)
        err = max(compare(f"paged bf16 m tp {tp}", got[1], want[1], STATS_TOL, STATS_TOL),
                  compare(f"paged bf16 l tp {tp}", got[2], want[2], STATS_TOL, STATS_TOL),
                  compare(f"paged bf16 out ({n_slots}, {h_tp}, {dh}), bf16 q, tp {tp}", got[0],
                          want[0], K6_OUT_TOL * float(want[0].abs().max()), K6_BF16_Q_RTOL))
        results["paged_attention_stats"]["shapes"].append(dict(
            shape=[n_slots, h_tp, dh], tp=tp, q_dtype="bfloat16", max_abs_err=err,
            ms=cuda_ms(lambda: paged_attention_with_stats(qb_tp, *k6_tp, lens, table)),
            host_ms=host_ms(lambda: paged_attention_with_stats(qb_tp, *k6_tp, lens, table)),
            device_ms=graph_ms(lambda: paged_attention_with_stats(qb_tp, *k6_tp, lens, table)),
            plain_ms=cuda_ms(lambda: attend_paged_with_stats_xla(qb_tp, *k6_tp, table, lens)),
            library_ms=None,
            bound=bound(tokens * h_tp * dh * 2 * 2 + 2 * qb_tp.numel() * 2
                        + 2 * n_slots * h_tp * 4 + table.numel() * 4, 4 * tokens * h_tp * dh,
                        "bf16")))
        results["paged_attention_stats"]["max_abs_err"] = max(
            results["paged_attention_stats"]["max_abs_err"], err)
        del k6_tp, qf, qb_tp
    for name in ("flash_attention", "gathered_paged_attention", "paged_fresh_write",
                 "paged_attention_stats"):
        for r in results[name]["shapes"]:
            if "tp" in r:
                graph = (f"; replayed from a CUDA graph {r['device_ms']:.4f} ms"
                         if "device_ms" in r else "")
                lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
                print(f"[kernel] {name} {r['shape']} tp {r['tp']}: kernel {r['ms']:.4f} ms"
                      f"{graph}, plain {r['plain_ms']:.4f} ms, library {lib}, bound "
                      f"{r['bound'][0]:.4f} ms ({r['bound'][1]})")
    torch.cuda.empty_cache()

    # K7: bf16 activations by int4 weights (groups of 128) at the LM's shapes.
    # library_ms is the bf16 torch.matmul of x with the dequantised weight:
    # the product that int4 replaces (four times the weight bytes), not the
    # same function.
    k7_rows = []
    for m, k, n in K7_SHAPES:
        qk = quantize_int4(torch.randn((k, n), generator=g, device=dev) * 0.02, 128)
        x = randn(m, k)
        q4, scale = qk["q4"], qk["scale"]
        err = compare(f"int4 matmul ({m}, {k}) x ({k}, {n})", int4_matmul(x, q4, scale),
                      int4_matmul_reference(x, q4, scale), K7_ATOL, K7_RTOL)
        if not torch.equal(int4_matmul(x, q4, scale), int4_matmul(x, q4, scale)):
            raise AssertionError("int4 matmul: two launches on the same inputs differ")
        dense = dequantize_int4(qk, bf)
        nbytes = q4.numel() + 2 * scale.numel() + 2 * x.numel() + 2 * m * n
        k7_rows.append(dict(
            shape=[m, k, n], max_abs_err=err,
            ms=cuda_ms(lambda: int4_matmul(x, q4, scale), iters=50),
            host_ms=host_ms(lambda: int4_matmul(x, q4, scale)),
            device_ms=graph_ms(lambda: int4_matmul(x, q4, scale)),
            library_device_ms=graph_ms(lambda: torch.matmul(x, dense)),
            plain_ms=cuda_ms(lambda: int4_matmul_reference(x, q4, scale), iters=5, warmup=1),
            library_ms=cuda_ms(lambda: torch.matmul(x, dense)),
            bound=bound(nbytes, 2 * m * k * n, "bf16")))
        del qk, q4, scale, dense
    results["int4_matmul"] = dict(k7_rows[0], max_abs_err=max(r["max_abs_err"] for r in k7_rows),
                                  shapes=k7_rows)
    for r in k7_rows:
        print(f"[kernel] int4_matmul {tuple(r['shape'])}: kernel {r['ms']:.4f} ms (host enqueue "
              f"{r['host_ms']:.4f} ms; replayed from a CUDA graph {r['device_ms']:.4f} ms, the "
              f"bf16 matmul {r['library_device_ms']:.4f} ms), plain "
              f"{r['plain_ms']:.4f} ms, bf16 matmul of the dequantised weight "
              f"{r['library_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms ({r['bound'][1]})")
    torch.cuda.empty_cache()
    for name, r in results.items():
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        print(f"[kernel] {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"library {lib}, bound {r['bound'][0]:.4f} ms ({r['bound'][1]})")
    return results


def build_model(cfg, seed: int, device, dtype):
    from videollamb_torch.models.assembly import VideoLLaMB
    from videollamb_torch.models.bridge.rmt_r import init_rmt_r_params
    from videollamb_torch.models.lm.llama import init_llama_params
    from videollamb_torch.models.vision.clip_vit import init_vision_params

    kw = dict(dtype=dtype, device=device)
    return VideoLLaMB(init_vision_params(cfg.vision, seed=seed, **kw),
                      init_rmt_r_params(cfg.bridge, cfg.lm.hidden_size, seed=seed + 1, **kw),
                      init_llama_params(cfg.lm, seed=seed + 2, **kw))


def lm_variant(model, choice: str):
    """The model with its LM in "bf16" (as built), as an "int8" copy
    (``quantize_llama_params``, the ``load_8bit`` route), or quantised to "int4"
    in place (``quantize_llama_params_int4`` consumes the bf16 LM, so int4
    comes last)."""
    from videollamb_torch.models.assembly import VideoLLaMB
    from videollamb_torch.models.lm.quant import (
        is_int4,
        quantize_llama_params,
        quantize_llama_params_int4,
    )

    if choice == "int8":
        return VideoLLaMB(model.video_tower, model.mm_projector,
                          quantize_llama_params(copy.deepcopy(model.lm)))
    if choice == "int4" and not is_int4(model.lm.lm_head):
        quantize_llama_params_int4(model.lm)
    return model


def make_batch(cfg, g: torch.Generator, prompt_lens, frames: int):
    from videollamb_torch.constants import VIDEO_TOKEN_INDEX
    from videollamb_torch.models.assembly import MultimodalBatch

    b, t = len(prompt_lens), max(prompt_lens)
    ids = torch.randint(4, cfg.lm.vocab_size, (b, t), generator=g, device="cuda")
    ids[:, 2] = VIDEO_TOKEN_INDEX
    mask = torch.arange(t, device="cuda")[None] < torch.tensor(prompt_lens, device="cuda")[:, None]
    img = cfg.vision.image_size
    videos = torch.randn((b, frames, 3, img, img), generator=g, device="cuda").to(torch.bfloat16)
    return MultimodalBatch(input_ids=ids, attention_mask=mask.long(), videos=videos)


def counters():
    from videollamb_torch.ops.flash_attention import block_attention, flash_attention
    from videollamb_torch.ops.gathered_paged_attention import gathered_paged_attention_int8
    from videollamb_torch.ops.int4_matmul import int4_matmul
    from videollamb_torch.ops.paged_attention_stats import paged_attention_with_stats
    from videollamb_torch.ops.paged_fresh_write import paged_fresh_write
    from videollamb_torch.ops.spatial_attention import fused_spatial_core, fused_spatial_core_packed
    from videollamb_torch.ops.temporal_attention import (
        fused_temporal_core, fused_temporal_core_fm, fused_temporal_core_fm3)

    return {"spatial_attention": fused_spatial_core_packed,
            "temporal_attention": fused_temporal_core_fm3,
            "flash_attention": flash_attention,
            "gathered_paged_attention": gathered_paged_attention_int8,
            "paged_fresh_write": paged_fresh_write,
            "paged_attention_stats": paged_attention_with_stats,
            "int4_matmul": int4_matmul,
            "spatial_core": fused_spatial_core,
            "temporal_core": fused_temporal_core,
            "temporal_core_fm": fused_temporal_core_fm,
            "block_attention": block_attention}


def zero_counters() -> None:
    for fn in counters().values():
        fn.launches = 0


def read_counters() -> dict:
    return {name: fn.launches for name, fn in counters().items()}


OFFLINE_REQUESTS = [([40], 16), ([41], 32), ([39], 64), ([40, 27], 32)]
K7_PER_STEP = 7 * 32 + 1  # projections x layers + lm_head


def slice_phase(model, cfg, g: torch.Generator, *, requests=OFFLINE_REQUESTS, new: int = 32,
                label: str = "bf16", int4: bool = False) -> dict:
    """Offline requests through ``generate``; K1-K3 must launch, and with int4
    weights K7 exactly 225 times per decode step and never during the prefill."""
    from videollamb_torch.models.engine import generate

    batches = [make_batch(cfg, g, lens, frames) for lens, frames in requests]
    kw = dict(max_new_tokens=new, do_sample=False, max_seq_len=cfg.max_length + 64,
              eos_token_id=-1)
    generate(model, cfg, batches[0], **dict(kw, max_new_tokens=2))  # warm-up
    torch.cuda.synchronize()

    zero_counters()
    stats = []
    for (lens, frames), batch in zip(requests, batches):
        k7_before = read_counters()["int4_matmul"]
        t0 = time.perf_counter()
        first = generate(model, cfg, batch, **dict(kw, max_new_tokens=1))
        torch.cuda.synchronize()
        ttft = time.perf_counter() - t0
        k7_prefill = read_counters()["int4_matmul"] - k7_before
        t0 = time.perf_counter()
        res = generate(model, cfg, batch, **kw)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        k7_decode = read_counters()["int4_matmul"] - k7_before - k7_prefill
        b = len(lens)
        toks = res.tokens
        if (toks.shape != (b, new) or int(toks.min()) < 0
                or int(toks.max()) >= cfg.lm.vocab_size
                or not torch.equal(toks[:, 0], first.tokens[:, 0])):
            raise AssertionError(f"{label} request {lens}x{frames}: bad tokens {toks.tolist()}")
        want_k7 = K7_PER_STEP * (new - 1) if int4 else 0
        if k7_prefill != 0 or k7_decode != want_k7:
            raise AssertionError(
                f"{label} request {lens}x{frames}: int4_matmul launched {k7_prefill} times in "
                f"the prefill (want 0) and {k7_decode} in {new - 1} decode steps (want {want_k7})")
        decoded = int(res.lengths.sum()) - b
        rate = decoded / max(total - ttft, 1e-9)
        stats.append(dict(path=f"generate {label}", batch=b, frames=frames, prompt_lens=lens,
                          ttft_s=ttft, decode_tok_s=rate, total_s=total))
        print(f"[slice] {label} B={b} frames={frames} prompt={lens}: TTFT {ttft * 1e3:.1f} ms, "
              f"decode {rate:.1f} tok/s, total {total:.2f} s, first tokens "
              f"{toks[:, :8].tolist()}")
    launches = read_counters()
    print(f"[slice] {label} launches during the requests: {launches}")
    for name in ("spatial_attention", "temporal_attention", "flash_attention"):
        if launches[name] == 0:
            raise AssertionError(f"kernel {name} of the offline path was never launched")
    return dict(stats=stats, launches=launches)


def serve_run(model, cfg, g, *, quantize_kv: bool, prompt_lens, frames: int, new: int,
              k: int, label: str) -> dict:
    from videollamb_torch.serve.paged import PagedServingEngine
    from videollamb_torch.serve.server import Request

    engine = PagedServingEngine(model, cfg, num_slots=8, quantize_kv=quantize_kv,
                                eos_token_id=-1)
    first_token = {}
    reqs = [Request(uid=i, batch=make_batch(cfg, g, [n], frames), max_new_tokens=new,
                    on_token=lambda r, tok: first_token.setdefault(r.uid, time.perf_counter()))
            for i, n in enumerate(prompt_lens)]
    torch.cuda.synchronize()
    zero_counters()
    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r)
    done = engine.run_until_drained(k=k)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
    ttft = [first_token[r.uid] - t0 for r in reqs]
    n_tokens = sum(len(r.tokens) for r in reqs)
    for r in reqs:
        if (len(r.tokens) != new or r.error or min(r.tokens) < 0
                or max(r.tokens) >= cfg.lm.vocab_size):
            raise AssertionError(f"{label} request {r.uid}: bad result {r.error} {r.tokens}")
    if len(done) != len(reqs) or engine.allocator.free_pages != engine.total_pages - 1:
        raise AssertionError(f"{label}: requests or pages not returned")
    print(f"[serve] {label}: {len(reqs)} requests, {n_tokens} tokens in {wall:.2f} s, "
          f"{n_tokens / wall:.1f} tok/s aggregate, TTFT ms "
          f"{[round(t * 1e3, 1) for t in ttft]}, launches {launches}")
    for r in reqs[:4]:
        print(f"[serve] {label} request {r.uid} first tokens {r.tokens[:8]}")
    del engine
    torch.cuda.empty_cache()
    return dict(path=f"paged {label}", requests=len(reqs), frames=frames,
                prompt_lens=list(prompt_lens), new_tokens=new, sync_every=k, wall_s=wall,
                tok_s=n_tokens / wall, ttft_s=ttft, launches=launches)


def serving_phase(model, cfg, g: torch.Generator) -> dict:
    # Warm-up: the first paged step of each pool type (allocator, kernels).
    for quantize_kv in (True, False):
        serve_run(model, cfg, g, quantize_kv=quantize_kv, prompt_lens=[30], frames=16,
                  new=2, k=2, label="warm-up")
    int8 = serve_run(model, cfg, g, quantize_kv=True, frames=16, new=32, k=8,
                     prompt_lens=[24, 90, 40, 61, 33, 77, 52, 45, 28, 86, 70, 36],
                     label="int8 pages, 8 slots")
    bf16 = serve_run(model, cfg, g, quantize_kv=False, frames=16, new=32, k=8,
                     prompt_lens=[40, 75, 29, 58], label="bf16 pages, 8 slots")
    for name in ("gathered_paged_attention", "paged_fresh_write"):
        if int8["launches"][name] == 0:
            raise AssertionError(f"kernel {name} was never launched by the int8 paged run")
    if bf16["launches"]["paged_attention_stats"] == 0:
        raise AssertionError("kernel paged_attention_stats was never launched by the bf16 run")
    if int8["launches"]["paged_attention_stats"] or bf16["launches"]["gathered_paged_attention"]:
        raise AssertionError("a paged run took the other pool type's kernel")
    return dict(stats=[int8, bf16],
                launches={**int8["launches"],
                          "paged_attention_stats": bf16["launches"]["paged_attention_stats"]})


# The features phase's decodable vocabulary: the JSON pieces of
# tests/test_grammar.py at their ids, every other id of the 32000 undecodable
# (grammar tables then expand over these pieces only).
JSON_PIECES = {
    3: "{", 4: "}", 5: "[", 6: "]", 7: '"', 8: ":", 9: ",", 10: " ",
    11: "0", 12: "1", 13: "7", 14: "-", 15: ".", 16: "e", 17: "+",
    18: "true", 19: "false", 20: "null", 21: "t", 22: "r", 23: "u",
    24: "a", 25: "l", 26: "s", 27: "n", 28: "f",
    29: '"name"', 30: '": ', 31: ', "', 32: "abc", 33: "xyz",
    34: '{"', 35: '"}', 36: "\\", 37: "\\n", 38: "A", 39: "B",
    40: "12", 41: "3",
}
FEATURE_EOS = 2
FEATURE_NEW = 24
# Two choice sets (token ids), the first shared by the choice rows.
CHOICE_SETS = [[[38], [39], [24, 32]], [[18], [19], [20, 9]]]


def text_batch(cfg, g: torch.Generator, n: int):
    """A text-only B=1 batch of ``n`` random ids."""
    from videollamb_torch.models.assembly import MultimodalBatch

    ids = torch.randint(4, cfg.lm.vocab_size, (1, n), generator=g, device="cuda")
    return MultimodalBatch(input_ids=ids, attention_mask=torch.ones_like(ids))


def seeded_adapters(cfg, ranks, seed: int):
    """Adapters of the given ranks for every projection, numpy f32:
    A ~ N(0, 1 / d_in), B ~ N(0, 0.02^2)."""
    import numpy as np

    lm = cfg.lm
    d, inter, kv = lm.hidden_size, lm.intermediate_size, lm.num_key_value_heads * lm.head_dim
    dims = {"q_proj": (d, d), "k_proj": (d, kv), "v_proj": (d, kv), "o_proj": (d, d),
            "gate_proj": (d, inter), "up_proj": (d, inter), "down_proj": (inter, d)}
    rng = np.random.default_rng(seed)
    out = {}
    for name, r in ranks.items():
        ad = {}
        for proj, (d_in, d_out) in dims.items():
            layers = lm.num_hidden_layers
            ad[f"{proj}_lora_a"] = (rng.standard_normal((layers, d_in, r), np.float32)
                                    * d_in ** -0.5)
            ad[f"{proj}_lora_b"] = rng.standard_normal((layers, r, d_out), np.float32) * 0.02
        out[name] = ad
    return out


def features_phase(model, cfg, g: torch.Generator) -> dict:
    """The paged engine's request features at 7B, 8 slots, int8 then bf16
    pages: prefix caching (4 videos x 4 questions, automatic), choice rows
    on one device table, json_object rows, a mixed batch of choice sets and
    json rows through the combined table and through host masks at k = 1,
    sampling controls with logprob rows, and 6 rows over two adapters and
    the base. Hard checks: choices, JSON, min_tokens, logprobs, refcounts."""
    import json as _json

    from videollamb_torch.constants import VIDEO_TOKEN_INDEX
    from videollamb_torch.models.assembly import MultimodalBatch
    from videollamb_torch.models.lm.mlora import add_multi_lora_params, drop_multi_lora_params
    from videollamb_torch.serve import grammar as grammar_mod
    from videollamb_torch.serve.grammar import json_constraint
    from videollamb_torch.serve.paged import PagedServingEngine
    from videollamb_torch.serve.server import Request

    strs = [None] * cfg.lm.vocab_size
    for i, piece in JSON_PIECES.items():
        strs[i] = piece

    class Tok:
        eos_token_id = FEATURE_EOS

    def decode(tokens):
        return "".join(strs[t] for t in tokens if t != FEATURE_EOS)

    # 4 videos of 16 frames (system + video prefix of 40 ids), 4 questions each.
    prefixes = [make_batch(cfg, g, [40], 16) for _ in range(4)]
    questions = [[torch.randint(4, cfg.lm.vocab_size, (1, 16), generator=g, device="cuda")
                  for _ in range(4)] for _ in range(4)]
    prompts = [text_batch(cfg, g, 40) for _ in range(8)]
    adapters = seeded_adapters(cfg, {"a8": 8, "b16": 16}, seed=11)
    results = {}

    def check(r, kind):
        if r.error:
            raise AssertionError(f"features {kind} request {r.uid}: {r.error}")
        if not r.tokens or min(r.tokens) < 0 or max(r.tokens) >= cfg.lm.vocab_size:
            raise AssertionError(f"features {kind} request {r.uid}: bad tokens {r.tokens}")
        if r.choices and not (r.tokens in r.choices or (
                r.tokens[-1] == FEATURE_EOS and r.tokens[:-1] in r.choices)):
            raise AssertionError(f"choice answer {r.tokens} is none of {r.choices}")
        if r.grammar is not None:
            text = decode(r.tokens)
            if not isinstance(_json.loads(text), dict):
                raise AssertionError(f"json_object answer {text!r} is not an object")
        if len(r.tokens) < min(r.min_tokens, r.max_new_tokens):
            raise AssertionError(f"min_tokens {r.min_tokens} row gave {len(r.tokens)} tokens")
        if r.logprobs:
            if not (len(r.token_logprobs) == len(r.top_tokens) == len(r.tokens)):
                raise AssertionError("logprobs and tokens differ in length")
            plain = r.temperature == 0 and r._constraint is None and not r.logit_bias
            for tok, lp, top in zip(r.tokens, r.token_logprobs, r.top_tokens):
                vals = [v for _, v in top]
                if not (math.isfinite(lp) and lp <= 0 and len(top) == r.top_logprobs
                        and all(math.isfinite(v) and v <= 0 for v in vals)
                        and vals == sorted(vals, reverse=True)):
                    raise AssertionError(f"bad logprobs {lp} {top}")
                ids = [t for t, _ in top]
                if tok in ids and abs(vals[ids.index(tok)] - lp) > 1e-5:
                    raise AssertionError("the chosen token's top entry differs from its logprob")
                # A greedy row's token has the top logprob (bf16 ties may list
                # another id first); any token above the list's last must be in it.
                if (plain and abs(vals[0] - lp) > 1e-5) or (lp > vals[-1] + 1e-5
                                                             and tok not in ids):
                    raise AssertionError(f"chosen token {tok} ({lp}) missing from {top}")

    for quantize_kv in (True, False):
        pages = "int8" if quantize_kv else "bf16"
        grammar_mod._CONTENT_TABLE_CACHE.clear()  # the first json run meets a cold table

        def engine(**kw):
            return PagedServingEngine(model, cfg, num_slots=8, quantize_kv=quantize_kv,
                                      eos_token_id=FEATURE_EOS, **kw)

        def run(label, reqs, k=8, eng=None):
            eng = eng or engine()
            torch.cuda.synchronize()
            zero_counters()
            t0 = time.perf_counter()
            for r in reqs:
                eng.submit(r)
            done = eng.run_until_drained(k=k)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_counters()
            if len(done) != len(reqs):
                raise AssertionError(f"features {label}: {len(done)} of {len(reqs)} returned")
            n = sum(len(r.tokens) for r in reqs)
            attn = "gathered_paged_attention" if quantize_kv else "paged_attention_stats"
            steps = launches[attn] // cfg.lm.num_hidden_layers
            row = dict(requests=len(reqs), tokens=n, wall_s=wall, tok_s=n / wall, k=k,
                       decode_steps=steps, ms_per_step=wall * 1e3 / max(steps, 1),
                       decodable_ids=len(JSON_PIECES),
                       launches={x: launches[x] for x in ("gathered_paged_attention",
                                                          "paged_fresh_write",
                                                          "paged_attention_stats")},
                       peak_pages_in_use=eng.peak_pages_in_use)
            want = (("gathered_paged_attention", "paged_fresh_write") if quantize_kv
                    else ("paged_attention_stats",))
            if any(row["launches"][x] == 0 for x in want):
                raise AssertionError(f"features {label}: a paged kernel was never launched "
                                     f"{row['launches']}")
            print(f"[features] {pages} pages, {label}: {len(reqs)} requests, {n} tokens in "
                  f"{wall:.2f} s, {n / wall:.1f} tok/s aggregate (reduced vocabulary: "
                  f"{len(JSON_PIECES)} decodable ids), {steps} decode steps "
                  f"({row['ms_per_step']:.1f} ms of wall each, admission included), k={k}, "
                  f"peak pages {eng.peak_pages_in_use}, launches {row['launches']}")
            return row, eng

        res = {}
        # Prefix caching: the suffix prefills timed against a video's first
        # question (its prefix registration and its suffix prefill).
        eng = engine()
        admit_ms = {"register": [], "suffix": []}
        for name, key in (("register_prefix", "register"), ("_admit_prefix", "suffix")):
            def timed(*a, _fn=getattr(eng, name), _key=key):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _fn(*a)
                torch.cuda.synchronize()
                admit_ms[_key].append((time.perf_counter() - t0) * 1e3)
                return out
            setattr(eng, name, timed)
        cached = [Request(uid=(v, q), batch=MultimodalBatch(
                      input_ids=questions[v][q], attention_mask=torch.ones_like(questions[v][q])),
                      prefix_batch=prefixes[v], max_new_tokens=16)
                  for v in range(4) for q in range(4)]
        res["prefix_cached"], eng = run("prefix-cached questions", cached, eng=eng)
        if (eng.prefix_misses, eng.prefix_hits) != (4, 12):
            raise AssertionError(f"prefix hits {eng.prefix_hits}, misses {eng.prefix_misses}")
        if any(eng._prefix_refs.values()):
            raise AssertionError(f"prefix refs after the drain: {eng._prefix_refs}")
        for pid in list(eng._prefixes):
            eng.release_prefix(pid)
        if eng.allocator._rc or eng.allocator.free_pages != eng.total_pages - 1:
            raise AssertionError("page refcounts not zero after the drain and release_prefix")
        full = [Request(uid=r.uid, batch=MultimodalBatch(
                    input_ids=torch.cat([prefixes[r.uid[0]].input_ids,
                                         questions[r.uid[0]][r.uid[1]]], 1),
                    attention_mask=torch.ones((1, 56), dtype=torch.long, device="cuda"),
                    videos=prefixes[r.uid[0]].videos), max_new_tokens=16) for r in cached]
        res["full_prompts"], _ = run("the same questions as full prompts", full)
        for r in cached:
            check(r, "prefix")
        first = [admit_ms["register"][i] + admit_ms["suffix"][i * 4] for i in range(4)]
        later = [admit_ms["suffix"][i] for i in range(16) if i % 4]
        res["prefix"] = dict(
            hits=eng.prefix_hits, misses=eng.prefix_misses, first_question_admit_ms=first,
            later_question_admit_ms=later, parts_from_uncached_at=[
                _first_split(a.tokens, b.tokens) for a, b in zip(cached, full)])
        print(f"[features] {pages} pages, prefix cache: hits {eng.prefix_hits}, misses "
              f"{eng.prefix_misses}; admission of a video's first question "
              f"{[round(x, 1) for x in first]} ms (registration + suffix), later questions "
              f"{[round(x, 1) for x in later]} ms; first token where a cached answer parts "
              f"from the uncached one (None: never): {res['prefix']['parts_from_uncached_at']}")
        del eng

        def rows(spec):
            reqs = []
            for i, kind in enumerate(spec):
                kw = {}
                if kind == "json":
                    kw["grammar"] = json_constraint(Tok(), token_strs=strs)
                elif kind.startswith("choice"):
                    kw["choices"] = CHOICE_SETS[int(kind[-1])]
                elif kind == "controls":
                    kw.update(temperature=0.8, top_k=40, logit_bias={41: 3.0, 11: -5.0},
                              presence_penalty=0.4, frequency_penalty=0.3, min_tokens=12)
                elif kind == "logprobs":
                    kw.update(logprobs=True, top_logprobs=5)
                elif kind in adapters:
                    kw["adapter"] = kind
                reqs.append(Request(uid=i, batch=prompts[i % len(prompts)],
                                    max_new_tokens=FEATURE_NEW, **kw))
            return reqs

        mixed = ["choice0", "choice0", "choice1", "choice1"] + ["json"] * 4
        runs = [("unconstrained", ["free"] * 8, 8),
                ("one choice set (device table)", ["choice0"] * 4 + ["free"] * 4, 8),
                ("json_object, one table, cold", ["json"] * 8, 8),
                ("json_object, one table, warm", ["json"] * 8, 8),
                ("mixed choice sets + json_object (combined table)", mixed, 8),
                ("the mixed batch through host masks", mixed, 1),
                ("sampling controls + logprobs", ["controls"] * 4 + ["logprobs"] * 4, 8)]
        for label, spec, k in runs:
            reqs = rows(spec)
            res[label], _ = run(label, reqs, k=k)
            for r in reqs:
                check(r, label)
        add_multi_lora_params(model.lm, adapters, dtype=torch.bfloat16)
        try:
            reqs = rows(["a8", "free", "b16", "a8", "b16", "free"])
            res["adapters"], eng = run("two adapters (ranks 8, 16) and the base", reqs,
                                       eng=engine(adapter_registry={"a8": 0, "b16": 1}))
            for r in reqs:
                check(r, "adapter")
            if eng._live_adapter_idx() is not None:
                raise AssertionError("adapter indices left after the drain")
            res["adapters"]["first_tokens"] = {f"{r.uid} {r.adapter}": r.tokens[:6]
                                               for r in reqs}
        finally:
            drop_multi_lora_params(model.lm)
        results[pages] = res
        torch.cuda.empty_cache()
    return results


class SmokeTokenizer:
    """A stand-in tokenizer for ``Chat`` (the smoke run has no tokenizer files):
    whitespace words hashed into the vocabulary; ``decode`` writes each id as
    its number, which encodes back to the id (so an answer re-tokenizes to the
    ids that produced it, as ``KVChatSession``'s cache diff wants)."""

    bos_token_id, eos_token_id, pad_token_id = 1, 2, 0

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size

    def __call__(self, text: str):
        import types
        import zlib

        ids = [self.bos_token_id]
        for word in text.replace("</s>", " </s> ").split():
            if word == "</s>":
                ids.append(self.eos_token_id)
            elif word.isdigit() and int(word) < self.vocab_size:
                ids.append(int(word))
            else:
                ids.append(4 + zlib.crc32(word.encode()) % (self.vocab_size - 4))
        return types.SimpleNamespace(input_ids=ids)

    def decode(self, tokens, skip_special_tokens: bool = True) -> str:
        return " ".join(str(int(t)) for t in tokens if not (skip_special_tokens and int(t) < 3))


def stream_system_len(cfg) -> int:
    """Tokens of the system prompt that ``StreamingSession`` prefills, with the
    smoke's tokenizer."""
    from videollamb_torch.serve.chat import Chat
    from videollamb_torch.serve.incremental import system_prompt_ids

    return len(system_prompt_ids(Chat(SmokeTokenizer(cfg.lm.vocab_size), None, cfg, {})))


# A question whose phrases repeat, so that prompt lookup has n-grams to hit.
SPEC_QUESTION = " ".join(["what does the person in the red coat do next"] * 4)


def _answer_tokens(text: str):
    return [int(t) for t in text.split()]


def _first_split(a, b):
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


def speculative_chat_runs(chat, frames, draft_lm, new: int, label: str, k: int = 8) -> dict:
    """Plain greedy, prompt lookup and int8 self-draft through ``Chat`` on one
    prompt: (tokens, seconds, stats) of each."""
    from videollamb_torch.constants import DEFAULT_X_TOKEN

    chat.reset()
    chat.conv.append_message(chat.conv.roles[0], DEFAULT_X_TOKEN["VIDEO"] + "\n" + SPEC_QUESTION)
    chat.conv.append_message(chat.conv.roles[1], None)
    prompt = chat.conv.get_prompt()
    on_card = chat.device.type == "cuda"

    def timed(fn):
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if on_card:
            torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    out = {}
    text, secs = timed(lambda: chat.generate_text(prompt, videos=frames, max_new_tokens=new,
                                                  do_sample=False))
    out["greedy"] = (_answer_tokens(text), secs, None)
    (text, stats), secs = timed(lambda: chat.generate_speculative(
        prompt, videos=frames, max_new_tokens=new, k=k))
    out["lookup"] = (_answer_tokens(text), secs, stats)
    (text, stats), secs = timed(lambda: chat.generate_speculative(
        prompt, videos=frames, max_new_tokens=new, k=k, draft_params=draft_lm))
    out["draft"] = (_answer_tokens(text), secs, stats)
    for mode, (toks, secs, stats) in out.items():
        extra = "" if stats is None else (
            f", rounds {stats['steps']}, mean accepted length {stats['tokens_per_step']:.2f}, "
            f"proposed {stats['proposed']}, accepted {stats['accepted']}, chain parts from "
            f"greedy at {_first_split(toks, out['greedy'][0])}")
        print(f"[spec] {label} {mode}: {len(toks)} tokens in {secs:.2f} s "
              f"({len(toks) / secs:.1f} tok/s, tower and prefill included){extra}")
    return out


def speculative_phase(model, cfg, int8_lm, g: torch.Generator) -> dict:
    """Full depth, bf16, on the card: the chains are reported, not asserted
    (a verify step and a decode step may break an argmax tie differently)."""
    from videollamb_torch.serve.chat import Chat
    from videollamb_torch.serve.server import Request, ServingEngine

    chat = Chat(SmokeTokenizer(cfg.lm.vocab_size), model, cfg, {})
    img = cfg.vision.image_size
    frames = torch.randn((16, 3, img, img), generator=g, device="cuda").cpu().numpy()
    speculative_chat_runs(chat, frames, int8_lm, 8, "warm-up")
    runs = speculative_chat_runs(chat, frames, int8_lm, 48, "7B bf16")
    for mode, (toks, _, _) in runs.items():
        if not toks or min(toks) < 0 or max(toks) >= cfg.lm.vocab_size:
            raise AssertionError(f"speculative {mode}: bad tokens {toks}")

    # A dense engine that speculates by prompt lookup serves three requests.
    engine = ServingEngine(model, cfg, num_slots=2, eos_token_id=-1, speculative="lookup")
    reqs = []
    for i, n in enumerate([40, 33, 52]):
        batch = make_batch(cfg, g, [n], 16)
        batch.input_ids[0, 8:n] = batch.input_ids[0, 3:8].repeat(n)[:n - 8]  # repeated phrase
        reqs.append(Request(uid=i, batch=batch, max_new_tokens=24))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r)
    done = engine.run_until_drained(k=4)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for r in reqs:
        if (len(r.tokens) != 24 or r.error or min(r.tokens) < 0
                or max(r.tokens) >= cfg.lm.vocab_size):
            raise AssertionError(f"speculating engine, request {r.uid}: {r.error} {r.tokens}")
    if len(done) != 3 or engine.spec_rounds == 0 or engine.spec_committed != 72:
        raise AssertionError("speculating engine: requests lost or no speculation round ran")
    print(f"[spec] dense engine, lookup, 2 slots: 3 requests x 24 tokens in {wall:.2f} s, "
          f"{engine.spec_rounds} rounds, {engine.spec_committed / engine.spec_rounds:.2f} "
          f"tokens per round over the active slots")
    del engine
    torch.cuda.empty_cache()
    return dict(path="speculative 7B bf16",
                runs={m: dict(tokens=len(t), seconds=s, stats=st)
                      for m, (t, s, st) in runs.items()},
                engine=dict(wall_s=wall))


@contextlib.contextmanager
def plain_kernels():
    """K1, K2 and K3 replaced by their plain PyTorch versions where the tower
    and the prefill call them, on the card (read the launch counters outside)."""
    from videollamb_torch.ops import attention
    from videollamb_torch.ops import spatial_attention as sa
    from videollamb_torch.ops import temporal_attention as ta
    from videollamb_torch.ops.flash_attention import flash_attention_reference

    saved = sa.fused_spatial_core_packed, ta.fused_temporal_core_fm3, attention.flash_attention
    sa.fused_spatial_core_packed = (
        lambda q, k, v, *, heads: sa.spatial_core_packed_reference(q, k, v, heads))
    ta.fused_temporal_core_fm3 = (
        lambda qkv, *, num_heads: ta.temporal_core_fm3_reference(qkv, num_heads))
    attention.flash_attention = flash_attention_reference
    try:
        yield
    finally:
        sa.fused_spatial_core_packed, ta.fused_temporal_core_fm3, attention.flash_attention = saved


def scene_clip(g: torch.Generator, img: int, scenes, noise: float):
    """Processed (T, 3, img, img) pixels: one seeded image a scene, repeated for
    its frames with seeded noise of std ``noise`` (0: identical frames)."""
    frames = []
    for length in scenes:
        base = torch.randn((1, 3, img, img), generator=g, device=g.device)
        frames.append(base + noise * torch.randn((length, 3, img, img), generator=g,
                                                 device=g.device))
    return torch.cat(frames).cpu().numpy()


def _pct(xs, q: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))] if xs else float("nan")


def depth_margins(cls: torch.Tensor, alpha: float):
    """The detector's rule over every prefix of the stream's CLS embeddings
    (each fits its window): (the smallest |depth - threshold| over the
    prefixes whose depths are not all equal (equal depths fire nothing,
    exactly), the largest depth, the depths of each prefix)."""
    from videollamb_torch.ops.scene_tilling import _frame_sims, _threshold_stats, depth_scores

    sims = _frame_sims(cls.float())
    margin, depths = float("inf"), []
    for m in range(2, sims.shape[0] + 1):  # m similarities: m + 1 >= 3 frames
        d = depth_scores(sims[:m])
        mean, std, _ = _threshold_stats(d)
        if float(std) > 0:
            margin = min(margin, float((d - (mean + alpha * std)).abs().min()))
        depths.append(d)
    return margin, float(depths[-1].max()), depths


# 104 frames at 1 fps, each scene one still image. Still frames give equal
# similarities, so a depth is 0 inside a scene and large at a cut: every
# depth lies far from the threshold. Past the second cut the response rule
# fires every other frame (boundaries [cuts..., current frame]), so the later
# scenes are short.
STREAM_SCENES = [44, 44, 8, 8]
STREAM_QUERIES = {20: "what is the person doing", 60: "what changed in the scene",
                  90: "describe the last scene"}
STREAM_NEW = 24


def drive_stream(chat, frames, queries, new: int, label: str, live_edge: bool = False):
    """A ``StreamingSession`` over ``frames`` at 1 fps; per tick (seconds,
    kind, prefetch hit). A tick's time runs from its first call to the end
    of the device work it queued (the next tick's prefetched encode, the
    tail of a fold's extend), so each tick is charged for its own work; no
    pacing between ticks. ``live_edge``: the session sees only the frames up
    to the current one, as from a camera, so no encode can be prefetched."""
    from videollamb_torch.serve.incremental import StreamingSession

    sess = StreamingSession(chat, max_seq_len=chat.cfg.max_length, max_new_tokens=new)
    sess.video_tensor, sess.num_video_frames = frames, frames.shape[0]
    ticks, responses, bounds, shapes, max_open = [], [], [], set(), 0
    for i in range(frames.shape[0]):
        if i in queries:
            sess.input_query_stream(queries[i], video_time=float(i))
        if live_edge:
            sess.num_video_frames = i + 1
        folded, hits = sess.closed_upto, sess.prefetch_hits
        t0 = time.perf_counter()
        sess.input_video_stream(float(i))
        q, r = sess()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        kind = "response" if r is not None else (
            "fold" if sess.closed_upto != folded else "plain")
        ticks.append((dt, kind, sess.prefetch_hits > hits))
        if r is not None:
            responses.append((q, r))
        bounds.append(list(sess._segment_boundaries()))
        max_open = max(max_open, sess.hbm_resident_frames)
        shapes.add((tuple(sess.kv.k.shape), tuple(sess.bridge_state.cache.shape),
                    sess._detector.state_shapes))
        if sess.context_length + sess.max_new_tokens > sess.max_seq_len:
            raise AssertionError(f"{label} tick {i}: context {sess.context_length} + "
                                 f"{sess.max_new_tokens} past the cap {sess.max_seq_len}")
    return dict(sess=sess, ticks=ticks, responses=responses, bounds=bounds, shapes=shapes,
                max_open=max_open)


def _tick_stats(ticks, select) -> dict:
    ms = [dt * 1e3 for dt, kind, hit in ticks if select(kind, hit)]
    return dict(n=len(ms), p50_ms=_pct(ms, 0.5), p99_ms=_pct(ms, 0.99))


def _answer(response: str):
    return _answer_tokens(response.split("Assistant:", 1)[1])


def stream_phase(model, cfg, g: torch.Generator) -> dict:
    """The carried-state streaming engine at full width: a seeded 104-frame
    scene stream at 224^2, three queries, 24 new tokens an answer, with the
    kernels (K1 per tick, K3 in every system prefill) and then again with
    their plain versions on the card: equal boundaries, the bridge memory's
    error, where the answers' tokens part. Between the two, 32-frame streams
    with the prefetch and at the live edge, in turns, time plain ticks with
    and without a prefetched encode."""
    from videollamb_torch.serve.chat import Chat

    chat = Chat(SmokeTokenizer(cfg.lm.vocab_size), model, cfg, {})
    frames = scene_clip(g, cfg.vision.image_size, STREAM_SCENES, noise=0.0)
    drive_stream(chat, frames[:12], {4: "warm up"}, 4, "warm-up")  # first launches, allocator
    torch.cuda.synchronize()
    zero_counters()
    run = drive_stream(chat, frames, STREAM_QUERIES, STREAM_NEW, "kernels")
    torch.cuda.synchronize()
    launches = read_counters()
    sess = run["sess"]
    ticks = run["ticks"]
    for q, r in run["responses"]:
        toks = _answer(r)
        if any(t < 0 or t >= cfg.lm.vocab_size for t in toks):
            raise AssertionError(f"stream: bad answer {r}")
    if launches["spatial_attention"] == 0 or launches["flash_attention"] == 0:
        raise AssertionError(f"stream: K1 or K3 was never launched: {launches}")
    if sess._system_len != stream_system_len(cfg):
        raise AssertionError(f"stream: system prompt of {sess._system_len} tokens, K3 was "
                             f"checked at {stream_system_len(cfg)}")
    if len(run["shapes"]) != 1:
        raise AssertionError(f"stream: state shapes changed: {run['shapes']}")
    answered = [q for q, _ in run["responses"] if "User: None" not in q]
    if len(answered) != len(STREAM_QUERIES) or run["max_open"] > sess.max_open_frames:
        raise AssertionError(f"stream: queries answered {answered}, open frames "
                             f"{run['max_open']}")

    # Prefetch against the live edge (every encode a miss) on the first 32
    # frames (plain ticks only), in turns: the host's speed drifts between
    # calls, so the two compare only inside one call.
    turns = {"prefetch": [], "live_edge": []}
    for name in ("prefetch", "live_edge", "live_edge", "prefetch"):
        short = drive_stream(chat, frames[:32], {}, STREAM_NEW, name,
                             live_edge=name == "live_edge")
        turns[name].append(_tick_stats(short["ticks"], lambda k, h: k == "plain")["p50_ms"])

    zero_counters()
    with plain_kernels():
        plain = drive_stream(chat, frames, STREAM_QUERIES, STREAM_NEW, "plain")
    torch.cuda.synchronize()
    if any(v for k, v in read_counters().items()
           if k in ("spatial_attention", "temporal_attention", "flash_attention")):
        raise AssertionError("the plain run launched a kernel")
    det, plain_det = sess._detector, plain["sess"]._detector
    margin, max_depth, depths = depth_margins(det.cls_buf[: det.n], det.alpha)
    plain_margin, _, plain_depths = depth_margins(plain_det.cls_buf[: plain_det.n],
                                                  plain_det.alpha)
    depth_err = max(float((a - b).abs().max()) for a, b in zip(depths, plain_depths))
    mem_err = float((sess.bridge_state.memory.float()
                     - plain["sess"].bridge_state.memory.float()).abs().max())
    splits = [_first_split(_answer(a), _answer(b))
              for (_, a), (_, b) in zip(run["responses"], plain["responses"])]
    same_bounds = run["bounds"] == plain["bounds"]
    stats = {name: _tick_stats(ticks, sel) for name, sel in (
        ("all", lambda k, h: True), ("plain", lambda k, h: k == "plain"),
        ("fold", lambda k, h: k == "fold"), ("response", lambda k, h: k == "response"),
        ("plain_prefetch_hit", lambda k, h: k == "plain" and h),
        ("plain_prefetch_miss", lambda k, h: k == "plain" and not h))}
    out = dict(
        frames=len(ticks), responses=len(run["responses"]), queries=len(answered),
        segments_folded=int(sess.bridge_state.count), compactions=sess._compactions,
        compaction_drops=sess._compaction_drops, prefetch_hits=sess.prefetch_hits,
        prefetch_misses=sess.prefetch_misses, max_open_frames=run["max_open"],
        context_length=sess.context_length, max_seq_len=sess.max_seq_len,
        state_shapes=len(run["shapes"]), ticks=stats, plain_tick_p50_in_turns=turns,
        launches=launches,
        plain=dict(boundaries_equal=same_bounds, min_depth_margin=margin, max_depth=max_depth,
                   plain_min_depth_margin=plain_margin, max_depth_err=depth_err,
                   bridge_memory_max_err=mem_err, answer_first_split=splits,
                   responses=len(plain["responses"])))
    for name, st in stats.items():
        print(f"[stream] ticks {name}: n={st['n']} p50 {st['p50_ms']:.2f} ms, "
              f"p99 {st['p99_ms']:.2f} ms")
    print(f"[stream] plain tick p50 over 32 frames in turns (ms): prefetch "
          f"{[round(x, 2) for x in turns['prefetch']]}, live edge "
          f"{[round(x, 2) for x in turns['live_edge']]}")
    print(f"[stream] {out['frames']} frames, {out['responses']} responses ({out['queries']} "
          f"queries), {out['segments_folded']} segments folded, {out['compactions']} "
          f"compactions, {out['compaction_drops']} drops; prefetch {out['prefetch_hits']} hits, "
          f"{out['prefetch_misses']} misses; open frames at most {out['max_open_frames']}; "
          f"context {out['context_length']} of {out['max_seq_len']}; "
          f"{out['state_shapes']} state shape(s); launches K1 {launches['spatial_attention']}, "
          f"K3 {launches['flash_attention']}")
    print(f"[stream] kernels vs plain on the card: boundaries equal {same_bounds}, smallest "
          f"|depth - threshold| {margin:.4e} (plain {plain_margin:.4e}; largest depth "
          f"{max_depth:.4e}), depth max err "
          f"{depth_err:.3e}, bridge memory max err {mem_err:.3e}, answers part at {splits}")
    if not same_bounds:
        raise AssertionError("stream: kernel and plain runs found other boundaries")
    del run, plain, short, sess
    torch.cuda.empty_cache()
    return out


def liveinfer_phase(model, cfg, g: torch.Generator) -> dict:
    """One short ``LiveInfer`` pass: two scenes of 8 identical frames and a
    query. Equal frames give equal similarities and zero depths, so only the
    cut fires and no boundary response comes: the query's answer is the one
    response (a full sampled generate of up to 512 tokens over all 16 frames:
    K1, K2, K3)."""
    from videollamb_torch.serve.chat import Chat
    from videollamb_torch.serve.streaming import LiveInfer

    chat = Chat(SmokeTokenizer(cfg.lm.vocab_size), model, cfg, {})
    live = LiveInfer(chat)
    live.video_tensor = scene_clip(g, cfg.vision.image_size, [8, 8], noise=0.0)
    live.num_video_frames = live.video_tensor.shape[0]
    live.input_query_stream("what happens in the video", video_time=2.0)
    torch.cuda.synchronize()
    zero_counters()
    responses, ticks = [], []
    for i in range(live.num_video_frames):
        t0 = time.perf_counter()
        live.input_video_stream(float(i))
        q, r = live()
        ticks.append(time.perf_counter() - t0)
        if r is not None:
            responses.append((q, r))
    torch.cuda.synchronize()
    launches = read_counters()
    toks = [_answer(r) for _, r in responses]
    if (len(responses) != 1 or "User: what happens" not in responses[0][0]
            or any(t < 0 or t >= cfg.lm.vocab_size for a in toks for t in a)):
        raise AssertionError(f"LiveInfer: responses {responses}")
    for name in ("spatial_attention", "temporal_attention", "flash_attention"):
        if launches[name] == 0:
            raise AssertionError(f"LiveInfer: kernel {name} was never launched")
    print(f"[live] LiveInfer, {len(ticks)} frames: {len(responses)} response, "
          f"{len(toks[0])} tokens, response tick {max(ticks):.2f} s, other ticks p50 "
          f"{_pct(sorted(ticks)[:-1], 0.5) * 1e3:.1f} ms; boundaries {live.boundaries}; "
          f"launches {launches}")
    return dict(frames=len(ticks), responses=len(responses), tokens=len(toks[0]),
                response_tick_s=max(ticks), launches=launches)


def kv_chat_phase(model, cfg, g: torch.Generator) -> dict:
    """``KVChatSession`` on a 16-frame clip: two greedy turns (the first
    prefills through K1, K2 and K3, the second extends the cache), then the
    same two turns with prompt-lookup speculation over the session cache
    (parts from greedy reported, not asserted, in bf16)."""
    from videollamb_torch.serve.chat import Chat, KVChatSession

    frames = scene_clip(g, cfg.vision.image_size, [8, 8], noise=0.05)
    questions = [SPEC_QUESTION, "and what happens after that"]
    torch.cuda.synchronize()
    zero_counters()
    out = {}
    for spec in (False, True):
        session = KVChatSession(Chat(SmokeTokenizer(cfg.lm.vocab_size), model, cfg, {}),
                                max_new_tokens=24)
        answers, secs = [], []
        for i, q in enumerate(questions):
            t0 = time.perf_counter()
            answers.append(_answer_tokens(session.ask(q, frames if i == 0 else None,
                                                      speculative=spec)))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        if not all(answers) or any(t < 0 or t >= cfg.lm.vocab_size for a in answers
                                   for t in a):
            raise AssertionError(f"KVChatSession speculative={spec}: answers {answers}")
        out["lookup" if spec else "greedy"] = dict(
            answers=answers, seconds=secs, full_prefills=session.full_prefills,
            extends=session.extends)
    launches = read_counters()
    for name in ("spatial_attention", "temporal_attention", "flash_attention"):
        if launches[name] == 0:
            raise AssertionError(f"KVChatSession: kernel {name} was never launched")
    splits = [_first_split(a, b) for a, b in zip(out["greedy"]["answers"],
                                                out["lookup"]["answers"])]
    for mode, r in out.items():
        print(f"[kvchat] {mode}: turns {[len(a) for a in r['answers']]} tokens in "
              f"{[round(s, 3) for s in r['seconds']]} s, full prefills {r['full_prefills']}, "
              f"extends {r['extends']}")
    print(f"[kvchat] lookup parts from greedy at {splits}; launches {launches}")
    return dict(greedy={k: v for k, v in out["greedy"].items() if k != "answers"},
                lookup={k: v for k, v in out["lookup"].items() if k != "answers"},
                lookup_first_split=splits, launches=launches)


# ---------------------------------------------------------------------------
# Serving surfaces: the HTTP server over the 7B model, and LanguageBind
# ---------------------------------------------------------------------------

HTTP_NEW = 16  # new tokens of each HTTP request
# The depth-cut binding model (full width, 2 tower and 2 text layers): the
# kernels in bf16 on the card against the plain versions in f32 on the host,
# cosine of each embedding.
EMBED_COS = 0.999
CLIP_EOT = 49407  # the highest id of the CLIP vocabulary


class ClipSmokeTokenizer:
    """A stand-in for the CLIP tokenizer: words hashed below EOT, then EOT
    (the highest id, where the text tower pools)."""

    def __call__(self, text: str):
        import types
        import zlib

        ids = [1 + zlib.crc32(w.encode()) % (CLIP_EOT - 1) for w in text.split()]
        return types.SimpleNamespace(input_ids=ids + [CLIP_EOT])


def write_media(root: str, seed: int) -> dict:
    """Seeded media files: a 16 s clip at 2 fps (the reader samples 16 frames
    at 1 fps) and an 8 s one (8 frames), both 320 x 240 mp4v, a PNG and a 3 s
    16 kHz WAV. Drawn from their own generator: the phases after this one
    keep the shared generator's draws."""
    import wave

    import cv2
    import numpy as np

    rng = np.random.default_rng(seed + 60)
    out = {}
    for name, seconds in (("video", 16), ("chunk", 8)):
        path = os.path.join(root, f"{name}.mp4")
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 2, (320, 240))
        if not writer.isOpened():
            raise RuntimeError(f"cv2 cannot write {path} (mp4v)")
        base = rng.integers(0, 255, (240, 320, 3), dtype=np.uint8)
        for i in range(2 * seconds):
            writer.write(np.roll(base, 9 * i, axis=1))
        writer.release()
        out[name] = path
    out["image"] = os.path.join(root, "image.png")
    cv2.imwrite(out["image"], rng.integers(0, 255, (300, 400, 3), dtype=np.uint8))
    out["audio"] = os.path.join(root, "audio.wav")
    with wave.open(out["audio"], "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((rng.uniform(-0.3, 0.3, 48000) * 32767).astype(np.int16).tobytes())
    return out


def http_call(url: str, path: str, body=None, method=None, timeout: float = 600.0):
    """(status, JSON body, seconds) of one request to the local server."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url + path, data=data,
                                 method=method or ("GET" if body is None else "POST"),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), time.perf_counter() - t0
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), time.perf_counter() - t0


def http_ok(url: str, path: str, body=None, method=None):
    status, out, secs = http_call(url, path, body, method)
    if status != 200:
        raise AssertionError(f"HTTP {path}: {status} {out}")
    return out, secs


def http_sse(url: str, path: str, body) -> tuple:
    """(events, seconds to the first event, seconds in all) of a streamed request."""
    import urllib.request

    req = urllib.request.Request(url + path, data=json.dumps(body).encode(), method="POST",
                                 headers={"Content-Type": "application/json"})
    events, first = [], None
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        for line in r:
            line = line.decode().strip()
            if line.startswith("data: "):
                first = first or time.perf_counter() - t0
                data = line[len("data: "):]
                events.append(data if data == "[DONE]" else json.loads(data))
    return events, first, time.perf_counter() - t0


def metrics_of(url: str) -> dict:
    import urllib.request

    with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
        body = r.read().decode()
    return {name: float(val) for name, val in
            (line.rsplit(" ", 1) for line in body.splitlines() if line and line[0] != "#")}


def binding_service(seed: int) -> tuple:
    """The LanguageBind model at full width (ViT-L/14 towers: video with 8
    frames and temporal layers, image, audio on the 112 x 1036 mel grid; the
    12 x 768 text encoder with 77 positions; projection 768), seeded, bf16 on
    the card, behind an ``EmbeddingService`` (video frames through
    ``DeviceVideoProcessor``). Before it, the depth-cut check against the
    plain f32 host version. Returns (service, report)."""
    import numpy as np

    from videollamb_torch.config import VisionConfig
    from videollamb_torch.data.device_preprocess import DeviceVideoProcessor
    from videollamb_torch.data.processing import ImageProcessor
    from videollamb_torch.models.binding import (
        TextConfig,
        init_binding_params,
        language_bind_forward,
    )
    from videollamb_torch.models.vision.modalities import AudioProcessor, audio_tower_config
    from videollamb_torch.serve.embeddings import EmbeddingService

    vcfgs = {"video": VisionConfig(), "image": VisionConfig(add_time_attn=False),
             "audio": audio_tower_config()}
    text = TextConfig()
    # Depth-cut check: the same seeded weights, kernels (bf16, card) vs plain (f32, host).
    cut = {k: dataclasses.replace(v, num_hidden_layers=2) for k, v in vcfgs.items()}
    cut_text = dataclasses.replace(text, num_hidden_layers=2)
    host = init_binding_params(cut, cut_text, 768, seed=seed + 40, device="cpu")
    card = copy.deepcopy(host).to("cuda", torch.bfloat16)
    tok = ClipSmokeTokenizer()
    ids = [tok(s).input_ids for s in ("a person walks a dog in the park", "an empty room")]
    ids = np.asarray([row + [0] * (text.max_position_embeddings - len(row)) for row in ids])
    rng = np.random.default_rng(seed + 41)
    inputs = {"language": torch.from_numpy(ids),
              "video": torch.from_numpy(rng.normal(size=(1, 8, 3, 224, 224)).astype(np.float32)),
              "image": torch.from_numpy(rng.normal(size=(1, 1, 3, 224, 224)).astype(np.float32)),
              "audio": torch.from_numpy(rng.normal(size=(1, 1, 3, 112, 1036)).astype(np.float32))}
    zero_counters()
    got = language_bind_forward(card, {k: v.to("cuda") if k == "language" else
                                       v.to("cuda", torch.bfloat16) for k, v in inputs.items()},
                                cut, cut_text, use_temp=False)
    cut_launches = read_counters()
    want = language_bind_forward(host, inputs, cut, cut_text, use_temp=False)
    cosines = {k: float(torch.nn.functional.cosine_similarity(
        got[k].float().cpu(), want[k], dim=-1).min()) for k in want}
    print(f"[embed] depth-cut binding (2 tower / 2 text layers, full width), card bf16 vs host "
          f"f32: min cosine {cosines} (tolerance >= {EMBED_COS}); K1 {cut_launches['spatial_attention']}"
          f" / K2 {cut_launches['temporal_attention']} launches")
    if min(cosines.values()) < EMBED_COS or not cut_launches["spatial_attention"]:
        raise AssertionError(f"binding: kernel path vs plain path cosines {cosines}")
    del card, host

    t0 = time.perf_counter()
    model = init_binding_params(vcfgs, text, 768, seed=seed + 42, dtype=torch.bfloat16,
                                device="cuda")
    torch.cuda.synchronize()
    print(f"[embed] LanguageBind (3 ViT-L/14 towers, 12 x 768 text, projection 768) built in "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} G parameters")
    service = EmbeddingService(
        model, vcfgs, tok, {"video": DeviceVideoProcessor(size=224, device="cuda"),
                            "image": ImageProcessor(size=224), "audio": AudioProcessor()},
        text_cfg=text, num_frames=8, device="cuda")
    return service, dict(depth_cut_min_cosine=cosines, tolerance=EMBED_COS)


def surfaces_phase(model, cfg, seed: int) -> dict:
    """The port's HTTP server (``serve/http_server.py``) over VideoLLaMB-7B in
    bf16: the paged engine with int8 pools (K3, K4, K5; K1 and K2 for the
    videos, which go through ``DeviceVideoProcessor``), then the dense engine
    for ``n = 2`` and an adapter hot-load; ``/v1/embeddings`` over the
    full-width LanguageBind model (K1, K2). Every request goes over HTTP to
    127.0.0.1; the greedy text of one request equals the same row submitted
    directly to the same engine."""
    import threading

    from videollamb_torch.data.device_preprocess import DeviceVideoProcessor
    from videollamb_torch.data.processing import ImageProcessor
    from videollamb_torch.data.video_reader import load_video
    from videollamb_torch.serve.batch_cli import build_requests
    from videollamb_torch.serve.chat import Chat
    from videollamb_torch.serve.http_server import make_server
    from videollamb_torch.serve.paged import PagedServingEngine
    from videollamb_torch.serve.server import ServingEngine

    root = os.path.join("build", "surfaces_smoke")
    os.makedirs(root, exist_ok=True)
    media = write_media(root, seed)
    img = cfg.vision.image_size
    procs = {"VIDEO": DeviceVideoProcessor(size=img, device="cuda"),
             "IMAGE": ImageProcessor(size=img)}
    frames = procs["VIDEO"](load_video(media["video"], fps=1.0, max_frames=512))
    if frames.device.type != "cuda" or tuple(frames.shape) != (16, 3, img, img):
        raise AssertionError(f"device preprocessing gave {frames.device} {tuple(frames.shape)}")
    print(f"[http] video route: request path -> load_video (cv2 decode, 16 of 32 frames) -> "
          f"DeviceVideoProcessor on {frames.device} -> {tuple(frames.shape)}")
    embedder, bind_report = binding_service(seed)
    tok = SmokeTokenizer(cfg.lm.vocab_size)
    endpoints, http_launches = {}, {}

    def add_launches():
        for k, v in read_counters().items():
            http_launches[k] = http_launches.get(k, 0) + v

    def serve(engine, label):
        httpd, srv = make_server(Chat(tok, model, cfg, procs), engine, port=0, k=8,
                                 timeout_s=600, model_name="videollamb-7b", embedder=embedder)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        print(f"[http] {label} server on 127.0.0.1:{httpd.server_address[1]}")
        return httpd, srv, f"http://127.0.0.1:{httpd.server_address[1]}"

    def record(name, secs, tokens, **extra):
        endpoints[name] = dict(seconds=secs, tokens=tokens, tok_s=tokens / secs, **extra)
        print(f"[http] {name}: {tokens} tokens in {secs * 1e3:.1f} ms, {tokens / secs:.1f} tok/s"
              + "".join(f", {k} {v}" for k, v in extra.items()))

    video_row = {"prompt": "what happens in this video", "video": media["video"],
                 "max_new_tokens": HTTP_NEW}
    # Paged engine, int8 pools.
    engine = PagedServingEngine(model, cfg, num_slots=4, quantize_kv=True, eos_token_id=2)
    httpd, srv, url = serve(engine, "paged int8")
    try:
        http_ok(url, "/v1/generate", {**video_row, "max_new_tokens": 2})  # warm-up
        torch.cuda.synchronize()
        zero_counters()
        plain, secs = http_ok(url, "/v1/generate", video_row)
        record("generate (paged int8, 16-frame video)", secs, plain["tokens"])
        direct = build_requests([video_row], Chat(tok, model, cfg, procs))[0]
        engine.submit(direct)
        deadline = time.monotonic() + 600
        while not direct.done and time.monotonic() < deadline:
            time.sleep(0.005)
        direct_text = tok.decode(direct.tokens, skip_special_tokens=True).strip()
        if direct.error or direct_text != plain["text"] or not plain["tokens"]:
            raise AssertionError(f"HTTP text {plain['text']!r} vs the engine's {direct_text!r}")
        print(f"[http] token check: the HTTP answer equals the same row submitted directly to "
              f"the engine ({len(direct.tokens)} tokens): ok")
        events, first, secs = http_sse(url, "/v1/generate", {**video_row, "stream": True})
        if not events[-1].get("done") or events[-1]["text"] != plain["text"]:
            raise AssertionError(f"streamed /v1/generate: {events[-1]}")
        record("generate stream", secs, events[-1]["tokens"], first_event_ms=round(first * 1e3, 1))
        chat_body = {"messages": [{"role": "user", "content": [
            {"type": "video_url", "video_url": {"url": media["video"]}},
            {"type": "text", "text": "what happens in this video"}]}], "max_tokens": HTTP_NEW}
        out, secs = http_ok(url, "/v1/chat/completions", chat_body)
        record("chat/completions video", secs, out["usage"]["completion_tokens"])
        out, secs = http_ok(url, "/v1/completions", {"prompt": "once upon a time there was",
                                                     "max_tokens": HTTP_NEW, "logprobs": 2})
        lps = out["choices"][0]["logprobs"]["token_logprobs"]
        if len(lps) != out["usage"]["completion_tokens"] or not all(
                math.isfinite(x) and x <= 1e-3 for x in lps):
            raise AssertionError(f"/v1/completions logprobs {lps}")
        record("completions logprobs", secs, len(lps))
        # The streams API: a session over the 8 s chunk, a query, a tick a
        # frame, a second chunk appended, ticks on.
        sess, secs = http_ok(url, "/v1/streams", {"video": media["chunk"], "fps": 1.0,
                                                  "query": "what is happening",
                                                  "query_time": 0.0, "max_new_tokens": 8})
        sid, ticks, events_seen = sess["id"], [], []
        for _ in range(sess["frames"]):
            out, secs = http_ok(url, f"/v1/streams/{sid}/tick", {})
            ticks.append(secs)
            if out.get("event"):
                events_seen.append(out["event"])
        appended, _ = http_ok(url, f"/v1/streams/{sid}/video", {"video": media["chunk"]})
        http_ok(url, f"/v1/streams/{sid}/query", {"text": "and now"})
        for _ in range(4):
            out, secs = http_ok(url, f"/v1/streams/{sid}/tick", {})
            ticks.append(secs)
            if out.get("event"):
                events_seen.append(out["event"])
        status, _ = http_ok(url, f"/v1/streams/{sid}")
        deleted, _ = http_ok(url, f"/v1/streams/{sid}", method="DELETE")
        if (appended["frames"] != 8 or appended["total_frames"] != 16 or not deleted["deleted"]
                or status["frames_ingested"] != 12
                or not any(e.get("response") for e in events_seen)):
            raise AssertionError(f"streams API: appended {appended}, status {status}, "
                                 f"events {events_seen}")
        endpoints["streams"] = dict(ticks=len(ticks), tick_ms_p50=_pct(ticks, 0.5) * 1e3,
                                    tick_ms_max=max(ticks) * 1e3, events=len(events_seen),
                                    context_length=status["context_length"])
        print(f"[http] streams: {len(ticks)} ticks, p50 {_pct(ticks, 0.5) * 1e3:.1f} ms, max "
              f"{max(ticks) * 1e3:.1f} ms, {len(events_seen)} events, append_video +"
              f"{appended['frames']} frames on the card, context {status['context_length']}")
        torch.cuda.synchronize()
        add_launches()
        # Embeddings over HTTP, then each modality's rate through the service.
        zero_counters()
        body = {"input": ["a person walks a dog", "an empty room",
                          {"type": "video_url", "video_url": {"url": media["video"]}},
                          {"type": "image_url", "image_url": {"url": media["image"]}},
                          {"type": "audio_url", "audio_url": {"url": media["audio"]}}]}
        http_ok(url, "/v1/embeddings", body)  # warm-up
        out, secs = http_ok(url, "/v1/embeddings", body)
        vecs = [torch.tensor(d["embedding"]) for d in out["data"]]
        if len(vecs) != 5 or not all(v.shape == (768,) and torch.isfinite(v).all()
                                     and abs(float(v.norm()) - 1) < 1e-2 for v in vecs):
            raise AssertionError("/v1/embeddings: bad vectors")
        rates = {}
        for modality, fn in (("text", lambda: embedder.embed_texts(["a person walks a dog"] * 8)),
                             ("video", lambda: embedder.embed_medium("video", media["video"])),
                             ("image", lambda: embedder.embed_medium("image", media["image"])),
                             ("audio", lambda: embedder.embed_medium("audio", media["audio"]))):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            rates[modality] = 3 * (8 if modality == "text" else 1) / (time.perf_counter() - t0)
        torch.cuda.synchronize()
        embed_launches = read_counters()
        print(f"[embed] /v1/embeddings (2 texts, a 16 s video at 8 frames, an image, 3 s of "
              f"audio): {secs * 1e3:.1f} ms; embeddings/s through the service (file decode "
              f"and preprocessing included): "
              + ", ".join(f"{k} {v:.2f}" for k, v in rates.items()))
        print(f"[embed] launches K1 {embed_launches['spatial_attention']}, K2 "
              f"{embed_launches['temporal_attention']}")
        if not (embed_launches["spatial_attention"] and embed_launches["temporal_attention"]):
            raise AssertionError(f"embeddings: K1 / K2 never launched: {embed_launches}")
        zero_counters()
        metrics = metrics_of(url)
    finally:
        httpd.shutdown()
        srv.shutdown()
    del engine
    torch.cuda.empty_cache()

    # Dense engine: n = 2 over shared prefill, then an adapter hot-load.
    adapter_dir = os.path.join(root, "adapter")
    write_peft_adapter(adapter_dir, cfg, seed)
    engine = ServingEngine(model, cfg, num_slots=4, eos_token_id=2)
    httpd, srv, url = serve(engine, "dense")
    try:
        http_ok(url, "/v1/generate", {"prompt": "describe the scene", "max_new_tokens": 2})
        torch.cuda.synchronize()
        zero_counters()
        out, secs = http_ok(url, "/v1/chat/completions", {**chat_body, "n": 2})
        texts = [c["message"]["content"] for c in out["choices"]]
        if len(texts) != 2 or texts[0] != texts[1]:
            raise AssertionError(f"n = 2 greedy choices differ: {texts}")
        record("chat/completions video n=2 (dense)", secs, out["usage"]["completion_tokens"])
        text_row = {"prompt": "describe the scene in detail", "max_new_tokens": HTTP_NEW}
        base, _ = http_ok(url, "/v1/generate", text_row)
        loaded, secs = http_ok(url, "/v1/adapters", {"name": "smoke", "path": adapter_dir})
        print(f"[http] adapter hot-load: {loaded} in {secs * 1e3:.1f} ms")
        adapted, secs = http_ok(url, "/v1/generate", {**text_row, "adapter": "smoke"})
        record("generate with adapter (dense)", secs, adapted["tokens"])
        unloaded, _ = http_ok(url, "/v1/adapters", {"name": "smoke", "unload": True})
        again, _ = http_ok(url, "/v1/generate", text_row)
        if (loaded["adapters"] != ["smoke"] or unloaded["adapters"] != []
                or again["text"] != base["text"]
                or getattr(model.lm, "mlora_rows", None) is not None):
            raise AssertionError(f"adapter hot-load: base {base['text']!r}, after unload "
                                 f"{again['text']!r}")
        print(f"[http] adapter answer parts from the base one: {adapted['text'] != base['text']}; "
              "after unload the base answer again: ok")
        torch.cuda.synchronize()
        add_launches()
        dense_metrics = metrics_of(url)
    finally:
        httpd.shutdown()
        srv.shutdown()
    del engine
    torch.cuda.empty_cache()

    ttft = metrics["videollamb_ttft_seconds_sum"] / max(metrics["videollamb_ttft_seconds_count"], 1)
    e2e = metrics["videollamb_e2e_seconds_sum"] / max(metrics["videollamb_e2e_seconds_count"], 1)
    print(f"[http] /metrics (paged server): {int(metrics['videollamb_requests_total'])} requests, "
          f"{int(metrics['videollamb_tokens_generated_total'])} tokens, TTFT mean "
          f"{ttft * 1e3:.1f} ms, end-to-end mean {e2e * 1e3:.1f} ms; dense server: "
          f"{int(dense_metrics['videollamb_requests_total'])} requests")
    print(f"[http] launches K1-K5 over the HTTP requests: " + ", ".join(
        f"{k} {http_launches[k]}" for k in ("spatial_attention", "temporal_attention",
                                            "flash_attention", "gathered_paged_attention",
                                            "paged_fresh_write")))
    for name in ("spatial_attention", "temporal_attention", "flash_attention",
                 "gathered_paged_attention", "paged_fresh_write"):
        if not http_launches[name]:
            raise AssertionError(f"HTTP phase: kernel {name} was never launched")
    return dict(endpoints=endpoints, ttft_ms_mean=ttft * 1e3, e2e_ms_mean=e2e * 1e3,
                embeddings_per_s=rates, binding=bind_report,
                launches={"http": http_launches, "embed": embed_launches})


# ---------------------------------------------------------------------------
# The eval harness over the 7B model, with an image tower
# ---------------------------------------------------------------------------

EVAL_NEW = 16  # new tokens of every generated eval answer
EVAL_SLOTS = 4  # the batched MC engine's slots
MC_OPTIONS = ["runs", "sits down", "picks up a cup", "opens the door", "waves"]
NIAVH_LENGTHS, NIAVH_DEPTHS = "32,64", "0.0,0.5,1.0"
# NIAVH's answers are a word; the stream also answers, with an empty query, at
# every boundary its detector cuts (about one in four frames), so its new
# tokens set most of the phase's time.
NIAVH_NEW = 4


class EvalTokenizer(SmokeTokenizer):
    """``SmokeTokenizer`` whose ``decode`` writes back the words it hashed (so
    a constrained answer reads as its option letter), with the legacy
    round-length rule the training templates' masking expects."""

    legacy = True

    def __init__(self, vocab_size: int):
        super().__init__(vocab_size)
        self.words: dict = {}

    def __call__(self, text: str):
        out = super().__call__(text)
        for word, i in zip(text.replace("</s>", " </s> ").split(), out.input_ids[1:]):
            self.words.setdefault(i, word)
        return out

    def decode(self, tokens, skip_special_tokens: bool = True) -> str:
        return " ".join(self.words.get(int(t), str(int(t))) for t in tokens
                        if not (skip_special_tokens and int(t) < 3))


def write_eval_set(root: str, seed: int) -> dict:
    """The synthetic eval set in ``root``: four 16-frame 320 x 240 mp4v clips,
    a 64-frame haystack of four still scenes, an 8-frame needle clip, a PNG
    and a WAV, and the
    ground-truth JSON of each eval script (MC questions in the MVBench format,
    names with their extension and a type, and in the EgoSchema format, names
    without). Drawn from their own generator."""
    import wave

    import cv2
    import numpy as np

    rng = np.random.default_rng(seed + 80)

    def clip(path, frames, value=None, scene=None):
        """A clip whose frames scroll, or are constant ``value``, or hold a
        new still scene every ``scene`` frames."""
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 8, (320, 240))
        if not writer.isOpened():
            raise RuntimeError(f"cv2 cannot write {path} (mp4v)")
        base = rng.integers(0, 255, (240, 320, 3), dtype=np.uint8)
        for i in range(frames):
            if scene and i % scene == 0:
                base = rng.integers(0, 255, (240, 320, 3), dtype=np.uint8)
            writer.write(np.full_like(base, value) if value is not None
                         else base if scene else np.roll(base, 7 * i, axis=0))
        writer.release()
        return path

    vids = os.path.join(root, "videos")
    os.makedirs(vids, exist_ok=True)
    names = [f"clip{i}" for i in range(4)]
    for name in names:
        clip(os.path.join(vids, f"{name}.mp4"), 16)
    cv2.imwrite(os.path.join(vids, "still.png"), rng.integers(0, 255, (300, 400, 3),
                                                              dtype=np.uint8))
    with wave.open(os.path.join(vids, "tone.wav"), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((rng.uniform(-0.3, 0.3, 32000) * 32767).astype(np.int16).tobytes())
    files = {"video_dir": vids,
             # Four still scenes: the stream's boundary detector cuts (and
             # answers, with an empty query) at scene changes.
             "haystack": clip(os.path.join(root, "haystack.mp4"), 64, scene=16),
             "needle": clip(os.path.join(root, "needle.mp4"), 8, value=250)}
    questions = ["what does the person do", "what happens next", "which action is shown",
                 "what does the person do first"]
    gt = {}
    for fmt, ext in (("mvbench", ".mp4"), ("egoschema", "")):
        gt[f"{fmt}_q"] = [{"question_id": f"{fmt}{i}", "video_name": names[i] + ext,
                           "question": q, "option": {str(j): o for j, o in enumerate(MC_OPTIONS)}}
                          for i, q in enumerate(questions)]
        gt[f"{fmt}_a"] = [dict(answer=i % 5, **({"type": f"t{i % 2}"} if ext else {}))
                          for i in range(4)]
    gt["oe_q"] = [{"question_id": i, "video_name": names[i], "question": q}
                  for i, q in enumerate(questions[:2])]
    gt["oe_a"] = [{"answer": "runs"}, {"answer": "sits down"}]
    gt["consistency"] = [{"question_id": i, "video_name": names[i], "Q1": questions[i],
                          "Q2": questions[i + 2], "A": MC_OPTIONS[i]} for i in range(2)]
    gt["moviechat_ws"] = [{"video_name": names[i],
                           "global": [{"video_name": names[i], "question": questions[0]}],
                           "breakpoint": [{"video_name": names[i], "question": questions[1],
                                           "time": 4}]} for i in range(2)]
    gt["mixed_q"] = [{"question_id": 0, "question": "compare the scenes", "video_name": names[0],
                      "image_name": "still.png", "audio_name": "tone.wav"}]
    gt["mixed_a"] = [{"answer": "the same"}]
    gt["needles"] = [{"needle": files["needle"], "question": "what was the secret word shown",
                      "answer": "banana"}]
    for name, rows in gt.items():
        files[name] = os.path.join(root, f"{name}.json")
        with open(files[name], "w") as f:
            json.dump(rows, f)
    return files


def k3_likelihood_row(lengths, s: int, g: torch.Generator) -> dict:
    """K3 at the likelihood forward's own shape: (n, 32, S, 128) through
    ``multihead_attention`` on (n, S, 32, 128) projections, causal, each row's
    spliced length its key mask; held against the plain version, with ms,
    plain ms, SDPA ms and the bound."""
    import torch.nn.functional as F

    from videollamb_torch.ops.attention import multihead_attention
    from videollamb_torch.ops.flash_attention import flash_attention_reference

    n = len(lengths)
    q, k, v = (torch.randn((n, s, 32, 128), generator=g, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    mask = torch.arange(s, device="cuda")[None] < torch.tensor(lengths, device="cuda")[:, None]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    err = compare(f"flash through multihead_attention ({n}, {s}, 32, 128), valid keys "
                  f"{list(lengths)} (the likelihood forward)",
                  multihead_attention(q, k, v, causal=True, k_mask=mask),
                  flash_attention_reference(qt, kt, vt, mask, causal=True).transpose(1, 2))
    causal = torch.ones((s, s), dtype=torch.bool, device="cuda").tril()
    sdpa_mask = (causal[None] & mask[:, None, :])[:, None]
    pairs = sum(sum(min(i + 1, int(length)) for i in range(s)) for length in lengths)
    return dict(
        shape=[n, s, 32, 128], layout="(B, S, H, Dh) projections through multihead_attention; "
        "the likelihood forward's option rows", lengths=[int(x) for x in lengths],
        max_abs_err=err,
        ms=cuda_ms(lambda: multihead_attention(q, k, v, causal=True, k_mask=mask)),
        plain_ms=cuda_ms(lambda: flash_attention_reference(qt, kt, vt, mask, causal=True)),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                  attn_mask=sdpa_mask)),
        # q read and out written at every row; K and V read only up to each
        # row's length (the causal key mask ends there and masked tiles are
        # skipped).
        bound=bound(2 * q.numel() * 2 + 2 * sum(int(x) for x in lengths) * 32 * 128 * 2
                    + mask.numel(), 4 * 32 * 128 * pairs, "bf16"))


def eval_phase(model, cfg, g: torch.Generator, seed: int) -> dict:
    """The eval harness (``videollamb_torch.eval``) over VideoLLaMB-7B in bf16
    with a seeded full-width LanguageBind image tower (ViT-L/14 at 224, no
    temporal layers) as ``model.image_tower``, on the synthetic set of
    ``write_eval_set``: multiple choice sequentially, batched (4 slots) and
    constrained to the option letters, with ``acc`` over the merged shards;
    likelihood ranking (K3 at (5, 32, S, 128) with ragged key masks); the
    open-ended, consistency and both MovieChat scripts; NIAVH in full and
    streaming mode; one mixed video + image + audio row; an image question and
    a two-image row through the image tower, and the question again through
    the video tower at one frame. Random weights:
    this measures the protocol, not accuracy. K1-K3 must launch."""
    import argparse

    import cv2
    import numpy as np

    from videollamb_torch.config import VisionConfig
    from videollamb_torch.data.processing import ImageProcessor, VideoProcessor
    from videollamb_torch.eval import (
        acc,
        niavh,
        videoqa,
        videoqa_consistency,
        videoqa_likelihood,
        videoqa_mc,
        videoqa_mixed,
        videoqa_moviechat,
    )
    from videollamb_torch.data.video_reader import load_video
    from videollamb_torch.models.assembly import MultimodalBatch
    from videollamb_torch.models.engine import generate
    from videollamb_torch.models.vision.clip_vit import init_vision_params
    from videollamb_torch.models.vision.modalities import AudioProcessor
    from videollamb_torch.serve.chat import Chat

    root = os.path.join("build", "eval_smoke")
    os.makedirs(root, exist_ok=True)
    files = write_eval_set(root, seed)
    img = cfg.vision.image_size
    model.image_tower = init_vision_params(VisionConfig(add_time_attn=False), seed=seed + 90,
                                           dtype=torch.bfloat16, device="cuda")
    # Audio rides the image path: mel images on the tower's own 224 x 224 grid.
    chat = Chat(EvalTokenizer(cfg.lm.vocab_size), model, cfg, {
        "VIDEO": VideoProcessor(size=img), "IMAGE": ImageProcessor(size=img),
        "AUDIO": AudioProcessor(num_mel_bins=img, target_length=img)})
    out_dir = os.path.join(root, "out")

    def args(name, **kw):
        return argparse.Namespace(**{**dict(
            video_dir=files["video_dir"], output_dir=out_dir, output_name=name, num_chunks=1,
            chunk_idx=0, num_frames=8, max_new_tokens=EVAL_NEW, temperature=0.0,
            names_have_extension=False, image_dir=None, audio_dir=None), **kw})

    timings, report = {}, {}

    def timed(label, n, fn):
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        timings[label] = dict(seconds=secs, items=n, seconds_per_item=secs / n)
        print(f"[eval] {label}: {n} in {secs:.2f} s, {secs / n:.3f} s each")
        return res

    torch.cuda.synchronize()
    zero_counters()
    # Multiple choice: MVBench then EgoSchema format, in each mode.
    mc = {}
    for mode in ("sequential", "batched", "constrained"):
        def run_mode():
            out = []
            for fmt in ("mvbench", "egoschema"):
                a = args(f"{mode}_{fmt}", gt_file_question=files[f"{fmt}_q"],
                         gt_file_answers=files[f"{fmt}_a"],
                         names_have_extension=fmt == "mvbench",
                         constrained=mode == "constrained")
                out.append(videoqa_mc.run_inference(a, chat) if mode == "sequential" else
                           videoqa_mc.run_inference_batched(a, chat, num_slots=EVAL_SLOTS))
            return out

        results = timed(f"MC {mode}", 8, run_mode)
        mc[mode] = [json.loads(line) for r in results for line in open(r["output"])]
        if len(mc[mode]) != 8:
            raise AssertionError(f"MC {mode}: {len(mc[mode])} records of 8")
    same = sum(a["pred"] == b["pred"] for a, b in zip(mc["sequential"], mc["batched"]))
    bad = [r for r in mc["constrained"] if r["pred"] not in videoqa_mc.OPTIONS[:len(MC_OPTIONS)]]
    if bad:
        raise AssertionError(f"constrained MC answers outside the option letters: {bad}")
    merged = acc.merge_shards([os.path.join(out_dir, f"sequential_{f}.json")
                               for f in ("mvbench", "egoschema")],
                              os.path.join(out_dir, "merge.jsonl"))
    overall, per_type, total = acc.compute_accuracy(merged)
    if total != 8 or set(per_type) != {"t0", "t1"}:
        raise AssertionError(f"acc over the merged shards: {total} records, types {per_type}")
    print(f"[eval] batched answers equal to sequential: {same} of 8 (bf16: reported, not "
          f"asserted); constrained answers {[r['pred'] for r in mc['constrained']]}; acc over "
          f"the merged sequential shards {overall:.3f} of {total} (random weights)")
    report["mc"] = dict(batched_equal_sequential=same, constrained=[r["pred"] for r in
                                                                    mc["constrained"]],
                        accuracy=overall, n=total)

    # Likelihood ranking: 2 questions x 5 options; the forward's spliced
    # lengths and buffer give K3's shape.
    shapes = []
    forward = videoqa_likelihood.videollamb_forward

    def recording_forward(*a, **kw):
        logits, spliced = forward(*a, **kw)
        shapes.append((spliced.lengths.tolist(), int(spliced.embeds.shape[1])))
        return logits, spliced

    videoqa_likelihood.videollamb_forward = recording_forward
    try:
        frames = chat.processors["VIDEO"](load_video(
            os.path.join(files["video_dir"], "clip0.mp4"), num_frames=8))
        picks = timed("likelihood ranking (5 options)", 2, lambda: [
            videoqa_likelihood.rank_options_by_likelihood(chat, q, MC_OPTIONS, frames)
            for q in ("what does the person do", "what happens next")])
    finally:
        videoqa_likelihood.videollamb_forward = forward
    if not all(0 <= p < len(MC_OPTIONS) for p in picks):
        raise AssertionError(f"likelihood picks {picks}")
    print(f"[eval] likelihood picks {picks}; spliced lengths {[s[0] for s in shapes]} in a "
          f"{shapes[0][1]}-token buffer")
    report["likelihood"] = dict(picks=picks, spliced_lengths=[s[0] for s in shapes],
                                buffer=shapes[0][1])

    # Open-ended eval scripts, 2 samples each.
    oe = dict(gt_file_question=files["oe_q"], gt_file_answers=files["oe_a"])
    for label, n, fn in (
            ("open-ended", 2, lambda: videoqa.run_inference(args("oe", **oe), chat)),
            ("consistency", 4, lambda: videoqa_consistency.run_inference(
                args("consistency", gt_file=files["consistency"]), chat)),
            ("MovieChat flat", 2, lambda: videoqa_moviechat.run_inference(args("mc_flat", **oe),
                                                                           chat)),
            ("MovieChat global / breakpoint", 4,
             lambda: videoqa_moviechat.run_inference_global_breakpoint(
                 args("mc_ws", gt_file_question=files["moviechat_ws"]), chat))):
        res = timed(label, n, fn)
        rows = [json.loads(line) for line in open(res["output"])]
        if len(rows) != 2:
            raise AssertionError(f"{label}: {len(rows)} records")

    # NIAVH, full then streaming.
    grids = {}
    for mode in ("full", "streaming"):
        a = argparse.Namespace(
            haystack_video=files["haystack"], needle_json=files["needles"],
            lengths=NIAVH_LENGTHS, depths=NIAVH_DEPTHS, needle_frames=8, mode=mode,
            stream_open_frames=32, stream_seq_len=2048, output_dir=out_dir,
            output_name=f"niavh_{mode}", max_new_tokens=NIAVH_NEW, temperature=0.0)
        n_cases = len(NIAVH_LENGTHS.split(",")) * len(NIAVH_DEPTHS.split(","))
        summary = timed(f"NIAVH {mode}", n_cases, lambda: niavh.run_pressure_test(a, chat))
        if summary["n"] != n_cases:
            raise AssertionError(f"NIAVH {mode}: {summary['n']} cases of {n_cases}")
        grids[mode] = summary["grid"]
        print(f"[eval] NIAVH {mode} grid {summary['grid']} (random weights: protocol only)")
    report["niavh"] = grids

    # One mixed video + image + audio row; an image question through the
    # image tower, a two-image row through it, and the question again through
    # the video tower at one frame.
    res = timed("mixed video + image + audio row", 1, lambda: videoqa_mixed.run_inference(
        args("mixed", gt_file_question=files["mixed_q"], gt_file_answers=files["mixed_a"]),
        chat))
    row = json.loads(open(res["output"]).readline())
    if row["modalities"] != ["VIDEO", "IMAGE", "AUDIO"] or not row["pred"]:
        raise AssertionError(f"mixed row {row}")
    image = chat.processors["IMAGE"](cv2.cvtColor(
        cv2.imread(os.path.join(files["video_dir"], "still.png")), cv2.COLOR_BGR2RGB))
    image2 = chat.processors["IMAGE"](load_video(
        os.path.join(files["video_dir"], "clip1.mp4"), num_frames=1)[0])
    answers = {}
    chat.conv.append_message(chat.conv.roles[0], "<image>\ndescribe the image")
    chat.conv.append_message(chat.conv.roles[1], None)
    prompt = chat.conv.get_prompt()
    answers["image tower"] = timed("generate_text(images=) through the image tower", 1,
                                   lambda: chat.generate_text(prompt, images=image,
                                                              max_new_tokens=EVAL_NEW,
                                                              do_sample=False))
    chat.reset()
    chat.conv.append_message(chat.conv.roles[0], "<image>\n<image>\ncompare the images")
    chat.conv.append_message(chat.conv.roles[1], None)
    ids, mask, tags = chat._prepare_multi_ids(chat.conv.get_prompt())
    two = MultimodalBatch(
        input_ids=torch.from_numpy(ids).cuda(), attention_mask=torch.from_numpy(mask).cuda(),
        images=torch.from_numpy(np.stack([image, image2])[None]).to("cuda", torch.bfloat16))
    result = timed("a two-image row (1, 2, 3, 224, 224) through the image tower", 1,
                   lambda: generate(model, cfg, two, max_new_tokens=EVAL_NEW, do_sample=False,
                                    max_seq_len=cfg.max_length + 64))
    if tags != ["IMAGE", "IMAGE"] or int(result.lengths[0]) != EVAL_NEW:
        raise AssertionError(f"two-image row: tags {tags}, {int(result.lengths[0])} tokens")
    chat.reset()
    model.image_tower = None
    answers["video tower"] = timed("generate_text(images=) through the video tower", 1,
                                   lambda: chat.generate_text(prompt, images=image,
                                                              max_new_tokens=EVAL_NEW,
                                                              do_sample=False))
    print(f"[eval] one image question: {len(answers['image tower'].split())} tokens through "
          f"the image tower, {len(answers['video tower'].split())} through the video tower at "
          f"one frame; the answers differ: {answers['image tower'] != answers['video tower']}")
    launches = read_counters()
    print(f"[eval] launches K1 {launches['spatial_attention']}, K2 "
          f"{launches['temporal_attention']}, K3 {launches['flash_attention']}")
    for name in ("spatial_attention", "temporal_attention", "flash_attention"):
        if not launches[name]:
            raise AssertionError(f"eval phase: kernel {name} was never launched")
    # K3 held against its plain version at the likelihood forward's shape
    # (after the counters are read: these launches are not the path's).
    # Its operands come from a generator of their own, so that the later
    # phases' draws from ``g`` stay as they were.
    g_k3 = torch.Generator(device="cuda").manual_seed(int(g.initial_seed()) + 72)
    k3_row = k3_likelihood_row(shapes[0][0], shapes[0][1], g_k3)
    gc.collect()
    torch.cuda.empty_cache()
    return dict(timings=timings, **report, launches=launches, k3_likelihood=k3_row)


# The breadth phase: the projector kinds of the factory, RoPE scaling, a
# stage-1 mlp2x_gelu train step and Mistral-7B, on the resident tower.
BREADTH_PROJECTORS = ["linear", "mlp2x_gelu", "transformer1x", "mlp_transformer1x",
                      "rmt_transformer1x", "rmt_r_transformer1x", "qformer2_32",
                      "retention_transformer1x"]
BREADTH_NEW = 8
# Llama-3.1's rope_scaling (its config.json).
LLAMA3_SCALING = dict(rope_type="llama3", factor=8.0, low_freq_factor=1.0,
                      high_freq_factor=4.0, original_max_position_embeddings=8192)
# The depth-cut LM checks: 2 layers at full width and a 1024-token prompt, so
# that a window of 256 bites on three quarters of the rows; then greedy steps.
CUT_LAYERS, CUT_PROMPT, CUT_WINDOW, CUT_STEPS = 2, 1024, 256, 4
K123 = ("spatial_attention", "temporal_attention", "flash_attention")


def lm_reference(lm_cfg, label: str, seed: int) -> dict:
    """A depth-cut LM (``CUT_LAYERS`` layers of ``lm_cfg``) prefills a
    ``CUT_PROMPT``-token prompt and takes ``CUT_STEPS`` greedy decode steps on
    the card (kernels, bf16) and on the host (plain versions, f32) from the
    same weights, both fed the host's greedy tokens. Every logits row within
    ``PATH_REL_L2``; the card's greedy token must be the host's wherever the
    host's top two lie further apart than the card's largest logit error."""
    from videollamb_torch.models.lm.llama import (
        embed_tokens,
        init_kv_cache,
        init_llama_params,
        llama_decode_step,
        llama_prefill,
    )

    cfg = dataclasses.replace(lm_cfg, num_hidden_layers=CUT_LAYERS)
    gpu = init_llama_params(cfg, seed=seed, dtype=torch.bfloat16, device="cuda")
    cpu = copy.deepcopy(gpu).float().cpu()
    ids = torch.randint(4, cfg.vocab_size, (1, CUT_PROMPT),
                        generator=torch.Generator().manual_seed(seed))
    runs = {}
    zero_counters()
    for name, lm, dev, dtype in (("card", gpu, "cuda", torch.bfloat16),
                                 ("host", cpu, "cpu", torch.float32)):
        cache = init_kv_cache(cfg, 1, CUT_PROMPT + CUT_STEPS, dtype=dtype, device=dev)
        logits, cache = llama_prefill(lm, cfg, embed_tokens(lm, ids.to(dev)),
                                      torch.ones((1, CUT_PROMPT), dtype=torch.long, device=dev),
                                      cache)
        runs[name] = dict(lm=lm, dev=dev, cache=cache, logits=[logits[0].float().cpu()])
    k3 = read_counters()["flash_attention"]
    for _ in range(CUT_STEPS):
        tok = int(runs["host"]["logits"][-1].argmax())
        for r in runs.values():
            logits, r["cache"] = llama_decode_step(
                r["lm"], cfg, embed_tokens(r["lm"], torch.tensor([[tok]], device=r["dev"])),
                r["cache"])
            r["logits"].append(logits[0].float().cpu())
    errs, agree, ties = [], 0, 0
    for c, h in zip(runs["card"]["logits"], runs["host"]["logits"]):
        if not torch.isfinite(c).all():
            raise AssertionError(f"{label}: non-finite logits on the card")
        errs.append(float((c - h).norm() / h.norm()))
        top2 = h.topk(2).values
        if int(c.argmax()) == int(h.argmax()):
            agree += 1
        elif float(top2[0] - top2[1]) <= float((c - h).abs().max()):
            ties += 1
        else:
            raise AssertionError(f"{label}: the card's greedy token {int(c.argmax())} is not "
                                 f"the host's {int(h.argmax())}")
    ok = max(errs) <= PATH_REL_L2 and k3 == CUT_LAYERS
    print(f"[breadth] depth cut, {label}: prefill of {CUT_PROMPT} + {CUT_STEPS} greedy steps, "
          f"card bf16 (K3 x {k3}) vs host f32, logits rel_l2 "
          f"{[f'{e:.3e}' for e in errs]} tol {PATH_REL_L2}, greedy tokens equal "
          f"{agree}/{len(errs)} (ties within the error: {ties}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: kernel path disagrees with the plain path")
    del gpu, runs
    torch.cuda.empty_cache()
    return dict(rel_l2=errs, greedy_equal=agree, greedy_ties=ties, k3_launches=k3)


def breadth_answer(model, cfg, g: torch.Generator, label: str, frames: int = 8) -> dict:
    """One offline request (40 ids, ``frames`` frames) of ``BREADTH_NEW``
    greedy tokens through ``generate``; K1-K3 must launch."""
    from videollamb_torch.models.assembly import prepare_multimodal_embeds
    from videollamb_torch.models.bridge.builder import bridge_token_count
    from videollamb_torch.models.engine import generate

    batch = make_batch(cfg, g, [40], frames)
    spliced = int(prepare_multimodal_embeds(model, cfg, batch).attention_mask.sum())
    bridge = bridge_token_count(cfg.bridge, 1 + (cfg.vision.image_size // cfg.vision.patch_size)
                                ** 2, frames)
    torch.cuda.synchronize()
    zero_counters()
    t0 = time.perf_counter()
    res = generate(model, cfg, batch, max_new_tokens=BREADTH_NEW, do_sample=False,
                   max_seq_len=cfg.max_length + 64, eos_token_id=-1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in read_counters().items() if k in K123}
    toks = res.tokens
    if (toks.shape != (1, BREADTH_NEW) or int(toks.min()) < 0
            or int(toks.max()) >= cfg.lm.vocab_size):
        raise AssertionError(f"{label}: bad tokens {toks.tolist()}")
    if not all(launches.values()):
        raise AssertionError(f"{label}: a kernel of K1-K3 was never launched: {launches}")
    print(f"[breadth] {label}: {spliced} spliced tokens, {spliced - 39} of them visual (the "
          f"projector gives {bridge}), {BREADTH_NEW} tokens in {wall * 1e3:.1f} ms, launches "
          f"K1 {launches['spatial_attention']} K2 {launches['temporal_attention']} K3 "
          f"{launches['flash_attention']}, tokens {toks[0].tolist()}")
    return dict(spliced_tokens=spliced, visual_tokens=spliced - 39, projector_tokens=bridge,
                wall_s=wall, launches=launches)


def projector_train_step(model, cfg, seed: int) -> dict:
    """LLaVA's stage 1 through the train CLI's step: a new f32 mlp2x_gelu
    projector over the frozen bf16 7B and tower, two steps on one 8-frame
    batch (the first update runs at lr(0) = 0, the warm-up's start). The
    projector keeps every tower token, 8 x 257 = 2056, so the splice buffer
    is 2304 tokens (``--model_max_length 2304``): at 2048 the labelled
    answer would be cut off and the loss would be 0. The loss must be finite
    and positive, the projector must move and nothing else may."""
    from videollamb_torch.config import BridgeConfig, TrainConfig
    from videollamb_torch.models.assembly import VideoLLaMB
    from videollamb_torch.models.bridge.builder import init_bridge_params
    from videollamb_torch.train.step import (
        create_optimizer,
        create_train_state,
        make_train_step,
        trainable_mask,
    )

    bcfg = BridgeConfig.from_projector_type("mlp2x_gelu", hidden_size=cfg.bridge.hidden_size)
    kcfg = dataclasses.replace(cfg, bridge=bcfg, max_length=2304)
    m = VideoLLaMB(model.video_tower, init_bridge_params(
        bcfg, cfg.lm.hidden_size, seed=seed + 72, device="cuda"), model.lm)
    tcfg = TrainConfig(tune_mode="adapter", learning_rate=TRAIN_LR)

    def frozen_sums():
        return torch.stack([p.detach().float().sum() for n, p in m.named_parameters()
                            if not n.startswith("mm_projector.")])

    before = frozen_sums()
    projector_before = [p.detach().clone() for p in m.mm_projector.parameters()]
    losses, times = [], []
    with torch.enable_grad():
        tx = create_optimizer(tcfg, 1000, m)
        state = create_train_state(m, tx)
        step = make_train_step(kcfg, tx, remat=True, attn_impl="chunked",
                               mask=trainable_mask(tcfg, m))
        batch = train_batch(kcfg, TrainClips(kcfg, 1, seed + 73, frames=8))
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    moved = any(not torch.equal(a, b) for a, b in zip(projector_before,
                                                       m.mm_projector.parameters()))
    still = torch.equal(before, frozen_sums())
    trained = sum(p.numel() for p in tx.params)
    ok = all(math.isfinite(x) and x > 0 for x in losses) and moved and still
    print(f"[breadth] train mlp2x_gelu (stage 1, {trained / 1e6:.1f} M trained parameters): "
          f"losses {[round(x, 4) for x in losses]}, steps {[round(t, 1) for t in times]} ms, "
          f"projector moved {moved}, the rest unchanged {still} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the mlp2x_gelu train step failed its checks")
    del m, state, tx, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    return dict(losses=losses, step_ms=times, trained_params=trained)


def breadth_phase(model, cfg, g: torch.Generator, seed: int) -> dict:
    """The model's breadth on the resident VideoLLaMB-7B and its LanguageBind
    tower: each projector kind answers one request; llama3 RoPE scaling
    answers one and is held against the host in a depth cut; a stage-1
    mlp2x_gelu train step; then Mistral-7B's window in a depth cut (the band
    bites, K3 computes it), and Mistral-7B at full depth under the RMT-R
    bridge through ``generate`` and the paged engine (int8, then bf16
    pages), with the Llama LM still resident beside it."""
    from videollamb_torch.config import BridgeConfig, LlamaConfig, RopeScaling
    from videollamb_torch.models.assembly import VideoLLaMB
    from videollamb_torch.models.bridge.builder import init_bridge_params
    from videollamb_torch.models.lm.llama import init_llama_params

    t_phase = time.perf_counter()
    total = dict.fromkeys(counters(), 0)

    def add(launches):
        for k, v in launches.items():
            total[k] += v

    out = {"projectors": {}}
    for ptype in BREADTH_PROJECTORS:
        bcfg = BridgeConfig.from_projector_type(ptype, hidden_size=cfg.bridge.hidden_size)
        bridge = init_bridge_params(bcfg, cfg.lm.hidden_size, seed=seed + 70,
                                    dtype=torch.bfloat16, device="cuda")
        res = breadth_answer(VideoLLaMB(model.video_tower, bridge, model.lm),
                             dataclasses.replace(cfg, bridge=bcfg), g, f"projector {ptype}")
        out["projectors"][ptype] = res
        add(res["launches"])
        del bridge
    rcfg = dataclasses.replace(cfg, lm=dataclasses.replace(
        cfg.lm, rope_scaling=RopeScaling(**LLAMA3_SCALING)))
    out["rope_llama3"] = breadth_answer(model, rcfg, g, "llama3 rope_scaling")
    add(out["rope_llama3"]["launches"])
    out["rope_llama3_reference"] = lm_reference(rcfg.lm, "Llama-7B dims, llama3 rope_scaling",
                                                seed + 71)
    out["train_mlp2x_gelu"] = projector_train_step(model, cfg, seed)
    window = lm_reference(LlamaConfig.mistral_7b(sliding_window=CUT_WINDOW),
                          f"Mistral-7B dims, window {CUT_WINDOW}", seed + 74)
    out["mistral_window_reference"] = window
    add({"flash_attention": window["k3_launches"]
         + out["rope_llama3_reference"]["k3_launches"]})

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mcfg = dataclasses.replace(cfg, lm=LlamaConfig.mistral_7b())
    t0 = time.perf_counter()
    mistral = VideoLLaMB(model.video_tower, model.mm_projector,
                         init_llama_params(mcfg.lm, seed=seed + 75, dtype=torch.bfloat16,
                                           device="cuda"))
    torch.cuda.synchronize()
    print(f"[breadth] Mistral-7B bf16 (window {mcfg.lm.sliding_window}) built in "
          f"{time.perf_counter() - t0:.1f} s beside the resident Llama-7B, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    offline = slice_phase(mistral, mcfg, g, new=16, label="Mistral-7B bf16")
    add(offline["launches"])
    int8 = serve_run(mistral, mcfg, g, quantize_kv=True, prompt_lens=[24, 60, 40, 52], frames=16,
                     new=16, k=8, label="Mistral-7B, int8 pages")
    bf16 = serve_run(mistral, mcfg, g, quantize_kv=False, prompt_lens=[40, 30], frames=16,
                     new=16, k=8, label="Mistral-7B, bf16 pages")
    add(int8["launches"])
    add(bf16["launches"])
    for name in ("gathered_paged_attention", "paged_fresh_write"):
        if int8["launches"][name] == 0:
            raise AssertionError(f"kernel {name} was never launched by Mistral's int8 run")
    if bf16["launches"]["paged_attention_stats"] == 0:
        raise AssertionError("kernel paged_attention_stats was never launched by Mistral's "
                             "bf16 run")
    peak = torch.cuda.max_memory_allocated()
    del mistral
    gc.collect()
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    print(f"[breadth] Mistral-7B peak allocated {peak / 2**30:.2f} GiB; phase launches "
          f"{total}; {seconds:.1f} s")
    out.update(mistral_offline=offline["stats"], mistral_paged=[
        {k: v for k, v in r.items() if k != "launches"} for r in (int8, bf16)],
        mistral_peak_allocated_gib=peak / 2**30, seconds=seconds, launches=total,
        k3_windowed_launches=window["k3_launches"])
    return out


# The images phase: anyres rows through a LanguageBind ViT-L/14 image tower
# (224, no temporal layers) and an mlp2x_gelu projector, on LLaVA-NeXT's
# pinpoints at 224 (2 x 1, 1 x 2, 2 x 2, 3 x 1, 1 x 3 patches).
IMAGE_PINPOINTS = ((224, 448), (448, 224), (448, 448), (672, 224), (224, 672))
IMAGE_SIZES = ((640, 480), (300, 900))  # (w, h) of the two PNGs
IMAGE_NEW = 16
IMAGE_TEXT = 40  # prompt ids, the IMAGE sentinel at 2
IMAGE_SLOTS = 8  # the paged engine's slots in the convoy run
CONVOY_NEW = 8
IMAGE_TRAIN_ROWS = 5  # image conversations packed into one 2048-token row
# The towers phase: each research tower kind at its published width and
# depth, the frames it takes, and a name that resolves to it.
TOWERS = (("vit", "google/vit-base-patch16-224", 4),
          ("vitmae", "facebook/vit-mae-base", 4),
          ("vivit", "google/vivit-b-16x2-kinetics400", 32),
          ("videomae", "MCG-NJU/videomae-base", 16),
          ("rmt_languagebind_video", "LanguageBind/RMTLanguageBind_Video", 8),
          ("deform_clip", "deform_clip-vit-large", 4),
          ("deformable", "deformable-detr", 1),
          ("egovlp", "EgoVLP", 4))
TOWER_NEW = 8


def write_images(root: str, seed: int) -> list:
    """The phase's PNGs (seeded smooth gradients plus noise), as PIL images."""
    import cv2
    import numpy as np
    from PIL import Image

    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    images = []
    for i, (w, h) in enumerate(IMAGE_SIZES):
        yy, xx = np.mgrid[0:h, 0:w]
        arr = np.stack([xx * 255 // w, yy * 255 // h, (xx + yy) * 127 // (w + h)], -1)
        arr = np.clip(arr + rng.integers(-20, 20, arr.shape), 0, 255).astype(np.uint8)
        path = os.path.join(root, f"image_{i}.png")
        cv2.imwrite(path, arr[..., ::-1])
        images.append(Image.open(path).convert("RGB"))
    return images


def anyres_batch(cfg, g: torch.Generator, image, processor):
    """One anyres row: IMAGE_TEXT ids (the sentinel at 2), the image's patch
    stack and grid spec, on the card."""
    from videollamb_torch.constants import IMAGE_TOKEN_INDEX
    from videollamb_torch.mm_utils import process_anyres_image
    from videollamb_torch.models.anyres import anyres_spec
    from videollamb_torch.models.assembly import MultimodalBatch

    stack = torch.from_numpy(process_anyres_image(image, processor, list(cfg.image_grid_pinpoints)))
    spec = anyres_spec(image.size, cfg.image_grid_pinpoints, cfg.vision.image_size,
                       cfg.vision.num_patches_per_side)
    ids = torch.randint(4, cfg.lm.vocab_size, (1, IMAGE_TEXT), generator=g, device="cuda")
    ids[:, 2] = IMAGE_TOKEN_INDEX
    return MultimodalBatch(input_ids=ids, attention_mask=torch.ones_like(ids),
                           images=stack[None].to("cuda", torch.bfloat16),
                           image_specs=torch.from_numpy(spec)[None].to("cuda"))


def image_answer(m, cfg, batch, label: str) -> dict:
    """TTFT (a one-token ``generate``) and IMAGE_NEW greedy tokens; K1 must
    launch once per tower layer on the whole patch stack, K3 once per LM layer."""
    from videollamb_torch.models.assembly import prepare_multimodal_embeds
    from videollamb_torch.models.engine import generate

    spliced = int(prepare_multimodal_embeds(m, cfg, batch).attention_mask.sum())
    kw = dict(do_sample=False, max_seq_len=cfg.max_length + 64, eos_token_id=-1)
    generate(m, cfg, batch, max_new_tokens=1, **kw)  # warm
    torch.cuda.synchronize()
    zero_counters()
    t0 = time.perf_counter()
    generate(m, cfg, batch, max_new_tokens=1, **kw)
    torch.cuda.synchronize()
    ttft = time.perf_counter() - t0
    launches = {k: v for k, v in read_counters().items() if k in K123}
    t0 = time.perf_counter()
    res = generate(m, cfg, batch, max_new_tokens=IMAGE_NEW, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    toks = res.tokens
    layers = len(m.image_tower.vision_model.encoder.layers) + cfg.vision.select_layer + 1
    ok = (toks.shape == (1, IMAGE_NEW) and 0 <= int(toks.min())
          and int(toks.max()) < cfg.lm.vocab_size
          and launches["spatial_attention"] == layers
          and launches["flash_attention"] == cfg.lm.num_hidden_layers)
    p = batch.images.shape[1]
    print(f"[images] {label}: {p} patches of 224, {spliced} spliced tokens, "
          f"{spliced - IMAGE_TEXT + 1} visual; TTFT {ttft * 1e3:.1f} ms, "
          f"{(IMAGE_NEW - 1) / max(wall - ttft, 1e-9):.1f} tok/s after it; launches K1 "
          f"{launches['spatial_attention']} (at ({p}, 257, 1024)) K3 {launches['flash_attention']}"
          f"; tokens {toks[0].tolist()} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"images {label}: bad tokens or launches {launches}")
    return dict(patches=p, spliced_tokens=spliced, visual_tokens=spliced - IMAGE_TEXT + 1,
                ttft_ms=ttft * 1e3, tok_s=(IMAGE_NEW - 1) / max(wall - ttft, 1e-9),
                wall_ms=wall * 1e3, launches=launches)


def anyres_reference(m, cfg, batch, seed: int) -> dict:
    """A depth cut (a seeded 2-layer image tower and 2-layer LM at full
    width, the phase's projector and newline) of the anyres model, card bf16
    against host f32 from the same weights: the spliced logits within
    PATH_REL_L2, the last row's greedy token equal (or the host's top two
    within the card's error)."""
    from videollamb_torch.config import VisionConfig
    from videollamb_torch.models.assembly import VideoLLaMB, videollamb_forward
    from videollamb_torch.models.lm.llama import init_llama_params
    from videollamb_torch.models.vision.clip_vit import init_vision_params

    kcfg = dataclasses.replace(cfg, max_length=1152, lm=dataclasses.replace(
        cfg.lm, num_hidden_layers=CUT_LAYERS))
    kw = dict(dtype=torch.bfloat16, device="cuda")
    card = VideoLLaMB(None, m.mm_projector, init_llama_params(kcfg.lm, seed=seed + 105, **kw),
                      init_vision_params(VisionConfig(add_time_attn=False,
                                                      num_hidden_layers=CUT_LAYERS),
                                         seed=seed + 106, **kw),
                      m.image_newline.detach().clone())
    host = copy.deepcopy(card).float().cpu()
    zero_counters()
    got = videollamb_forward(card, kcfg, batch)
    k1 = read_counters()["spatial_attention"]
    hbatch = batch._replace(input_ids=batch.input_ids.cpu(),
                            attention_mask=batch.attention_mask.cpu(),
                            images=batch.images.float().cpu(), image_specs=batch.image_specs.cpu())
    want = videollamb_forward(host, kcfg, hbatch)
    valid = want[1].attention_mask[0].bool()
    c, h = got[0][0].float().cpu()[valid], want[0][0][valid]
    rel = float((c - h).norm() / h.norm())
    last_c, last_h = c[-1], h[-1]
    top2 = last_h.topk(2).values
    agree = int(last_c.argmax()) == int(last_h.argmax())
    tie = float(top2[0] - top2[1]) <= float((last_c - last_h).abs().max())
    ok = rel <= PATH_REL_L2 and (agree or tie) and k1 > 0
    print(f"[images] depth cut (2 tower + 2 LM layers, {int(valid.sum())} spliced tokens): card "
          f"bf16 (K1 x {k1}) vs host f32, logits rel_l2 {rel:.3e} tol {PATH_REL_L2}, last "
          f"greedy token equal {agree} (tie within the error: {tie and not agree}) -> "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("images: the anyres depth cut disagrees with the host")
    del card, host
    return dict(rel_l2=rel, greedy_equal=agree, k1_launches=k1)


def image_train_rows(cfg, images, n: int, seed: int) -> list:
    """n 'pad' image conversations: each PNG squared (expand2square) and
    processed, 120 ids with the IMAGE sentinel at 2, the second half labelled."""
    import numpy as np

    from videollamb_torch.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
    from videollamb_torch.data.processing import ImageProcessor
    from videollamb_torch.mm_utils import expand2square

    proc = ImageProcessor(size=cfg.vision.image_size)
    bg = tuple(int(x * 255) for x in proc.image_mean)
    pixels = [proc(expand2square(im, bg)) for im in images]
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        ids = rng.integers(4, cfg.lm.vocab_size, size=120).astype(np.int32)
        ids[2] = IMAGE_TOKEN_INDEX
        labels = np.where(np.arange(120) < 60, IGNORE_INDEX, ids).astype(np.int32)
        rows.append({"input_ids": ids, "labels": labels, "image": pixels[i % len(pixels)]})
    return rows


def image_train_steps(m, cfg, images, seed: int) -> dict:
    """Stage 1 on image rows: a new f32 mlp2x_gelu projector over the frozen
    bf16 7B and image tower, two steps on 2 'pad' rows (``Collator``) and two
    on 5 rows packed into one 2048-token row (``PackedCollator`` with
    ``block_tokens_image``). Finite positive losses; the projector moves."""
    from videollamb_torch.config import TrainConfig
    from videollamb_torch.models.assembly import VideoLLaMB, measure_block_tokens
    from videollamb_torch.models.bridge.builder import init_bridge_params
    from videollamb_torch.train.dataset import Collator, PackedCollator
    from videollamb_torch.train.step import (
        create_optimizer,
        create_train_state,
        make_train_step,
        trainable_mask,
    )
    from videollamb_torch.train.trainer import pin_batch, to_device

    rows = image_train_rows(cfg, images, IMAGE_TRAIN_ROWS, seed + 111)
    dev = torch.device("cuda")
    batches = {
        "pad rows": Collator(max_length=cfg.max_length)(rows[:2]),
        "packed rows": PackedCollator(max_length=cfg.max_length,
                                      block_tokens=measure_block_tokens(cfg, "video"),
                                      block_tokens_image=measure_block_tokens(cfg, "image"),
                                      k_max=IMAGE_TRAIN_ROWS, rows_bucket=1)(rows)}
    tcfg = TrainConfig(tune_mode="adapter", learning_rate=TRAIN_LR)
    out = {}
    for label, batch in batches.items():
        s = VideoLLaMB(None, init_bridge_params(cfg.bridge, cfg.lm.hidden_size, seed=seed + 112,
                                                device="cuda"), m.lm, m.image_tower)
        before = [p.detach().clone() for p in s.mm_projector.parameters()]
        batch = to_device(pin_batch(batch, dev), dev)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        losses, times = [], []
        with torch.enable_grad():
            tx = create_optimizer(tcfg, 1000, s)
            state = create_train_state(s, tx)
            step = make_train_step(cfg, tx, remat=True, attn_impl="chunked",
                                   mask=trainable_mask(tcfg, s))
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, metrics = step(state, batch)
                losses.append(float(metrics["loss"]))
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() / 2**30
        moved = any(not torch.equal(a, b) for a, b in zip(before, s.mm_projector.parameters()))
        ok = all(math.isfinite(x) and x > 0 for x in losses) and moved
        shape = tuple(batch.input_ids.shape)
        segs = int(batch.segment_ids.max()) if batch.segment_ids is not None else shape[0]
        print(f"[images] train mlp2x_gelu on {label}: batch {shape}, {segs} conversations, "
              f"losses {[round(x, 4) for x in losses]}, steps {[round(t, 1) for t in times]} ms"
              f", peak allocated {peak:.2f} GiB, projector moved {moved} -> "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"images: the {label} train step failed its checks")
        out[label] = dict(batch=list(shape), conversations=segs, losses=losses, step_ms=times,
                          peak_gib=peak)
        del s, state, tx, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def convoy_run(model, cfg, g: torch.Generator, prefetch: bool, seed: int) -> dict:
    """IMAGE_SLOTS single-image requests (``prompt_len`` set: the host formula
    of the RMT-R bridge applies) and IMAGE_SLOTS 8-frame video requests,
    interleaved and submitted at once to the paged engine with int8 pages.
    With ``prefetch`` the engine reads back each convoy's prompt lengths in
    one copy; without, each admission reads its own. Copies and the admission
    ms (the ``_admit`` calls' wall time) are counted."""
    import numpy as np

    from videollamb_torch.constants import IMAGE_TOKEN_INDEX
    from videollamb_torch.models.assembly import MultimodalBatch
    from videollamb_torch.serve.paged import PagedServingEngine
    from videollamb_torch.serve.server import Request

    gen = torch.Generator(device="cuda").manual_seed(seed)
    img = cfg.vision.image_size
    reqs = []
    for i in range(2 * IMAGE_SLOTS):
        if i % 2:
            batch = make_batch(cfg, gen, [40], 8)
            reqs.append(Request(uid=i, batch=batch, max_new_tokens=CONVOY_NEW))
        else:
            ids = torch.randint(4, cfg.lm.vocab_size, (1, 40), generator=gen, device="cuda")
            ids[:, 2] = IMAGE_TOKEN_INDEX
            batch = MultimodalBatch(input_ids=ids, attention_mask=torch.ones_like(ids),
                                    images=torch.randn((1, 3, img, img), generator=gen,
                                                       device="cuda").to(torch.bfloat16))
            reqs.append(Request(uid=i, batch=batch, max_new_tokens=CONVOY_NEW, prompt_len=40))
    engine = PagedServingEngine(model, cfg, num_slots=IMAGE_SLOTS, quantize_kv=True,
                                eos_token_id=-1)
    if not prefetch:
        engine._prefetch_admissions = lambda: None
    copies, admits = [], []
    readback, admit = engine._readback, engine._admit

    def counted_readback(t):
        copies.append(int(t.numel()))
        return readback(t)

    def timed_admit():
        n = sum(r is not None for r in engine.slots)
        t0 = time.perf_counter()
        admit()
        torch.cuda.synchronize()
        if sum(r is not None for r in engine.slots) > n:
            admits.append((time.perf_counter() - t0) * 1e3)

    engine._readback, engine._admit = counted_readback, timed_admit
    zero_counters()
    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r)
    engine.run_until_drained(k=8)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for r in reqs:
        if len(r.tokens) != CONVOY_NEW or r.error:
            raise AssertionError(f"convoy request {r.uid}: {r.error} {r.tokens}")
    verified = sorted(engine._len_verified)
    del engine
    torch.cuda.empty_cache()
    return dict(tokens=[r.tokens for r in reqs], copies=copies, admit_ms=admits, wall_s=wall,
                verified=[list(map(str, v)) for v in verified], launches=read_counters(),
                mean_admit_ms=float(np.mean(admits)) if admits else 0.0)


def images_phase(model, cfg, g: torch.Generator, seed: int) -> dict:
    """Anyres images on the resident VideoLLaMB-7B: a seeded LanguageBind
    ViT-L/14 image tower (224, no temporal layers) and a seeded mlp2x_gelu
    projector with a learned ``image_newline``; a 640 x 480 and a 300 x 900
    PNG through ``generate`` under 'spatial_unpad' and 'flat' merges (TTFT,
    tok/s, visual tokens, K1 on the patch stack, K3 in the prefill); a depth
    cut against the host; stage-1 steps on 'pad' image rows and on packed
    image rows; the paged engine's convoy admission of image and video
    requests against per-request admission (equal tokens, one readback per
    convoy); K3 timed at the anyres prefill's own shape and lengths."""
    from videollamb_torch.config import BridgeConfig, VisionConfig
    from videollamb_torch.data.processing import ImageProcessor
    from videollamb_torch.models.assembly import VideoLLaMB, init_image_newline
    from videollamb_torch.models.bridge.builder import init_bridge_params
    from videollamb_torch.models.vision.clip_vit import init_vision_params

    t_phase = time.perf_counter()
    images = write_images(os.path.join("build", "images_smoke"), seed + 100)
    bcfg = BridgeConfig.from_projector_type("mlp2x_gelu", hidden_size=cfg.vision.hidden_size)
    icfg = dataclasses.replace(cfg, bridge=bcfg, image_aspect_ratio="anyres",
                               image_grid_pinpoints=IMAGE_PINPOINTS)
    kw = dict(dtype=torch.bfloat16, device="cuda")
    m = VideoLLaMB(None, init_bridge_params(bcfg, cfg.lm.hidden_size, seed=seed + 101, **kw),
                   model.lm, init_vision_params(VisionConfig(add_time_attn=False),
                                                seed=seed + 102, **kw),
                   init_image_newline(cfg.lm.hidden_size, seed=seed + 103, **kw))
    proc = ImageProcessor(size=cfg.vision.image_size)
    total = dict.fromkeys(counters(), 0)
    out = {"answers": {}}
    rows = [anyres_batch(icfg, g, im, proc) for im in images]
    for merge in ("spatial_unpad", "flat"):
        mcfg = dataclasses.replace(icfg, mm_patch_merge_type=merge)
        for (w, h), batch in zip(IMAGE_SIZES, rows):
            res = image_answer(m, mcfg, batch, f"{w} x {h}, {merge}")
            out["answers"][f"{w}x{h} {merge}"] = res
            for k, v in res["launches"].items():
                total[k] += v
    ucfg = dataclasses.replace(icfg, mm_patch_merge_type="spatial_unpad")
    out["reference"] = anyres_reference(m, ucfg, rows[0], seed)
    # K3 at the anyres prefill's own shape: the 2048-token buffer, the
    # 640 x 480 row's spliced length valid.
    out["k3_anyres"] = k3_likelihood_row(
        [out["answers"]["640x480 spatial_unpad"]["spliced_tokens"]], cfg.max_length, g)
    out["k3_anyres"]["layout"] = ("(B, S, H, Dh) projections through multihead_attention; "
                                  "the anyres prefill (640 x 480, spatial_unpad)")
    out["train"] = image_train_steps(m, ucfg, images, seed)
    del m
    gc.collect()
    torch.cuda.empty_cache()

    runs = {}
    for prefetch in (True, False):
        runs[prefetch] = convoy_run(model, cfg, g, prefetch, seed + 104)
        label = "convoy" if prefetch else "one at a time"
        r = runs[prefetch]
        print(f"[images] paged int8, {IMAGE_SLOTS} slots, {IMAGE_SLOTS} images + {IMAGE_SLOTS} "
              f"videos, admission {label}: {len(r['admit_ms'])} admitting calls, "
              f"{len(r['copies'])} host readbacks of {r['copies']} prompt lengths, admission ms "
              f"{[round(x, 1) for x in r['admit_ms']]}, wall {r['wall_s']:.2f} s, verified "
              f"signatures {r['verified']}")
    equal = runs[True]["tokens"] == runs[False]["tokens"]
    convoys = len(runs[True]["admit_ms"])
    ok = equal and len(runs[True]["copies"]) <= convoys and len(runs[False]["copies"]) > convoys
    print(f"[images] convoy tokens equal to one-at-a-time admission: {equal}; readbacks per "
          f"admitting call {len(runs[True]['copies'])}/{convoys} against "
          f"{len(runs[False]['copies'])}/{len(runs[False]['admit_ms'])} -> "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("images: convoy admission changed the tokens or its readbacks")
    for k, v in runs[True]["launches"].items():
        total[k] += v
    out["convoy"] = {("prefetch" if p else "per_request"): {
        k: v for k, v in r.items() if k not in ("tokens", "launches")} for p, r in runs.items()}
    out["convoy"]["tokens_equal"] = equal
    seconds = time.perf_counter() - t_phase
    print(f"[images] phase launches {total}; {seconds:.1f} s")
    out.update(seconds=seconds, launches=total)
    return out


def tower_answer(kind: str, name: str, frames: int, model, cfg, g: torch.Generator,
                 seed: int) -> dict:
    """One research tower at its published width and depth (seeded bf16)
    under a seeded mlp2x_gelu projector of its width and the resident LM:
    the encode timed, then one request of TOWER_NEW greedy tokens through
    ``generate``; the splice buffer fits the tower's tokens."""
    from videollamb_torch.config import BridgeConfig
    from videollamb_torch.constants import VIDEO_TOKEN_INDEX
    from videollamb_torch.models.assembly import (
        MultimodalBatch,
        VideoLLaMB,
        prepare_multimodal_embeds,
    )
    from videollamb_torch.models.bridge.builder import init_bridge_params
    from videollamb_torch.models.engine import generate
    from videollamb_torch.models.vision.builder import init_tower, resolve_tower, tower_encode

    spec = resolve_tower(name)
    assert spec.kind == kind, (spec.kind, kind)
    kw = dict(dtype=torch.bfloat16, device="cuda")
    tower = init_tower(spec, seed=seed, **kw)
    width = getattr(spec.config, "hidden_size", None) or spec.config.d_model
    bcfg = BridgeConfig.from_projector_type("mlp2x_gelu", hidden_size=width)
    size = spec.config.image_size if hasattr(spec.config, "image_size") else 224
    pixels = torch.randn((1, frames, 3, size, size), generator=g, device="cuda").to(torch.bfloat16)
    tower_encode(spec, tower, pixels)  # warm
    torch.cuda.synchronize()
    zero_counters()
    t0 = time.perf_counter()
    feats = tower_encode(spec, tower, pixels)
    torch.cuda.synchronize()
    encode_ms = (time.perf_counter() - t0) * 1e3
    k1 = read_counters()["spatial_attention"]
    n_visual = feats.shape[1] * feats.shape[2]
    tcfg = dataclasses.replace(cfg, bridge=bcfg, tower=spec,
                               max_length=-(-(n_visual + 64) // 512) * 512)
    m = VideoLLaMB(tower, init_bridge_params(bcfg, cfg.lm.hidden_size, seed=seed + 1, **kw),
                   model.lm)
    ids = torch.randint(4, cfg.lm.vocab_size, (1, 40), generator=g, device="cuda")
    ids[:, 2] = VIDEO_TOKEN_INDEX
    batch = MultimodalBatch(input_ids=ids, attention_mask=torch.ones_like(ids), videos=pixels)
    spliced = int(prepare_multimodal_embeds(m, tcfg, batch).attention_mask.sum())
    torch.cuda.synchronize()
    zero_counters()
    t0 = time.perf_counter()
    res = generate(m, tcfg, batch, max_new_tokens=TOWER_NEW, do_sample=False,
                   max_seq_len=tcfg.max_length + 64, eos_token_id=-1)
    torch.cuda.synchronize()
    answer_ms = (time.perf_counter() - t0) * 1e3
    launches = {k: v for k, v in read_counters().items() if k in K123}
    toks = res.tokens
    ok = (bool(torch.isfinite(feats.float()).all()) and toks.shape == (1, TOWER_NEW)
          and 0 <= int(toks.min()) and int(toks.max()) < cfg.lm.vocab_size
          and spliced == 39 + n_visual and launches["flash_attention"] > 0
          and (k1 > 0) == (kind == "rmt_languagebind_video"))
    print(f"[towers] {kind} ({name}, {frames} frames of {size}): features {tuple(feats.shape)}, "
          f"encode {encode_ms:.1f} ms (K1 x {k1}), {n_visual} visual tokens in a "
          f"{tcfg.max_length} buffer, {TOWER_NEW} tokens in {answer_ms:.1f} ms, launches "
          f"{launches}, tokens {toks[0].tolist()} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"towers: {kind} failed its checks")
    del m, tower
    return dict(name=name, frames=frames, features=list(feats.shape), encode_ms=encode_ms,
                visual_tokens=n_visual, buffer=tcfg.max_length, answer_ms=answer_ms,
                k1_encode_launches=k1, launches=launches)


def tower_reference(kind: str, name: str, frames: int, seed: int) -> dict:
    """A 2-layer depth cut of the tower at full width: card bf16 against host
    f32 from the same weights, features within PATH_REL_L2."""
    from videollamb_torch.models.vision.builder import init_tower, resolve_tower, tower_encode

    spec = resolve_tower(name)
    field = "encoder_layers" if kind == "deformable" else "num_hidden_layers"
    spec = dataclasses.replace(spec, config=dataclasses.replace(spec.config, **{field: 2}))
    tower = init_tower(spec, seed=seed, dtype=torch.bfloat16, device="cuda")
    host = copy.deepcopy(tower).float().cpu()
    size = spec.config.image_size if hasattr(spec.config, "image_size") else 224
    pixels = torch.randn((1, frames, 3, size, size), generator=torch.Generator().manual_seed(seed))
    got = tower_encode(spec, tower, pixels.to("cuda", torch.bfloat16)).float().cpu()
    want = tower_encode(spec, host, pixels)
    rel = float((got - want).norm() / want.norm())
    ok = rel <= PATH_REL_L2 and bool(torch.isfinite(got).all())
    print(f"[towers] {kind} depth cut (2 layers): card bf16 vs host f32, features "
          f"{tuple(want.shape)} rel_l2 {rel:.3e} tol {PATH_REL_L2} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"towers: the {kind} depth cut disagrees with the host")
    del tower, host
    return dict(rel_l2=rel)


def towers_phase(model, cfg, g: torch.Generator, seed: int) -> dict:
    """Every research tower kind of ``resolve_tower`` at its published width
    and depth with seeded weights through ``generate`` on the resident LM
    under a seeded mlp2x_gelu projector of its width; a 2-layer depth cut of
    each against the host."""
    t_phase = time.perf_counter()
    total = dict.fromkeys(counters(), 0)
    out = {}
    for i, (kind, name, frames) in enumerate(TOWERS):
        res = tower_answer(kind, name, frames, model, cfg, g, seed + 120 + i)
        res["reference"] = tower_reference(kind, name, frames, seed + 140 + i)
        for k, v in res["launches"].items():
            total[k] += v
        total["spatial_attention"] += res["k1_encode_launches"]
        out[kind] = {k: v for k, v in res.items() if k != "launches"}
        gc.collect()
        torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    print(f"[towers] phase launches {total}; {seconds:.1f} s")
    return dict(towers=out, seconds=seconds, launches=total)


def write_peft_adapter(path: str, cfg, seed: int) -> None:
    """A seeded PEFT LoRA directory (r = 8, alpha 16 on q_proj and v_proj of
    every layer; ``adapter_config.json`` and ``adapter_model.bin``). PEFT's
    A is A^T / (alpha / r); B is scaled to std 1, so the adapter moves the
    answer."""
    os.makedirs(path, exist_ok=True)
    ad = seeded_adapters(cfg, {"smoke": 8}, seed + 50)["smoke"]
    sd = {}
    for proj in ("q_proj", "v_proj"):
        a, b = ad[f"{proj}_lora_a"], ad[f"{proj}_lora_b"]
        for layer in range(a.shape[0]):
            key = f"base_model.model.model.layers.{layer}.self_attn.{proj}"
            sd[f"{key}.lora_A.weight"] = torch.from_numpy(a[layer].T.copy() / 2.0)
            sd[f"{key}.lora_B.weight"] = torch.from_numpy(b[layer].T.copy() * 50.0)
    torch.save(sd, os.path.join(path, "adapter_model.bin"))
    with open(os.path.join(path, "adapter_config.json"), "w") as f:
        json.dump({"r": 8, "lora_alpha": 16, "target_modules": ["q_proj", "v_proj"]}, f)


SHARDED_FRAMES, SHARDED_NEW = 16, 32


def sharded_serving_phase(model, cfg, g: torch.Generator) -> dict:
    """The serving engines over sharded weights on a one-rank NCCL group: a
    deep copy of the full-width, full-depth 7B model through ``shard_params``
    on a (1, 1) mesh (the LM's weights DTensors on the size-1 'model' axis,
    every LM and tower layer and the root an FSDP unit on 'data'), then
    ``generate``, the dense engine, the paged engine on int8 and on bf16
    pages and a sampled request, each against the same run over the
    unsharded model: the tokens must be equal (a one-rank mesh does the same
    arithmetic), and K1-K6 must launch in the sharded runs. The cross-rank
    tensor-parallel and FSDP collectives run only on the CPU's gloo ranks
    (tests/test_torch_parallel_steps.py): this machine has one card."""
    import socket

    import torch.distributed as dist

    from videollamb_torch.models.engine import generate
    from videollamb_torch.parallel.mesh import create_mesh
    from videollamb_torch.parallel.sharding import shard_params
    from videollamb_torch.serve.paged import PagedServingEngine
    from videollamb_torch.serve.server import Request, ServingEngine

    t_phase = time.perf_counter()
    g_sh = torch.Generator(device="cuda").manual_seed(int(g.initial_seed()) + 300)
    gen_batch = make_batch(cfg, g_sh, [40], SHARDED_FRAMES)
    lens = {"dense": [36, 52], "paged int8": [40, 75, 29, 58], "paged bf16": [33, 61, 47, 70],
            "sampled": [44]}
    batches = {name: [make_batch(cfg, g_sh, [n], SHARDED_FRAMES) for n in ns]
               for name, ns in lens.items()}

    def engine(m, name):
        if name.startswith("paged"):
            return PagedServingEngine(m, cfg, num_slots=4, quantize_kv=name == "paged int8",
                                      eos_token_id=-1)
        return ServingEngine(m, cfg, num_slots=2, eos_token_id=-1, seed=5)

    def runs(m) -> dict:
        out = {}
        kw = dict(max_new_tokens=SHARDED_NEW, eos_token_id=-1,
                  max_seq_len=cfg.max_length + SHARDED_NEW)
        generate(m, cfg, gen_batch, **dict(kw, max_new_tokens=2))  # warm-up
        for name in ["generate", *lens]:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            if name == "generate":
                tokens = generate(m, cfg, gen_batch, **kw).tokens.tolist()
            else:
                temp = 0.9 if name == "sampled" else 0.0
                reqs = [Request(uid=i, batch=b, max_new_tokens=SHARDED_NEW, temperature=temp,
                                top_p=0.9) for i, b in enumerate(batches[name])]
                eng = engine(m, name)
                for r in reqs:
                    eng.submit(r)
                eng.run_until_drained(k=8)
                tokens = [r.tokens for r in reqs]
                del eng
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n = len(tokens)
            out[name] = dict(tokens=tokens, ms_per_request=wall * 1e3 / n,
                             tok_s=n * SHARDED_NEW / wall,
                             peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        return out

    plain = runs(model)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0, world_size=1)
    before = torch.cuda.memory_allocated()
    try:
        t0 = time.perf_counter()
        sharded_model = shard_params(create_mesh(1, 1), copy.deepcopy(model))
        torch.cuda.synchronize()
        shard_s = time.perf_counter() - t0
        zero_counters()
        sharded = runs(sharded_model)
        launches = read_counters()
    finally:
        sharded_model = None
        gc.collect()
        torch.cuda.empty_cache()
        dist.destroy_process_group()
    left_gib = (torch.cuda.memory_allocated() - before) / 2**30
    ok = True
    for name, r in sharded.items():
        p = plain[name]
        same = r["tokens"] == p["tokens"]
        ok &= same
        print(f"[sharded] {name}: sharded {r['ms_per_request']:.1f} ms a request, "
              f"{r['tok_s']:.1f} tok/s, peak allocated {r['peak_gib']:.2f} GiB; unsharded "
              f"{p['ms_per_request']:.1f} ms, {p['tok_s']:.1f} tok/s, {p['peak_gib']:.2f} GiB; "
              f"tokens {'equal' if same else 'DIFFER'} (first {r['tokens'][0][:8]})")
    needed = ("spatial_attention", "temporal_attention", "flash_attention",
              "gathered_paged_attention", "paged_fresh_write", "paged_attention_stats")
    missing = [k for k in needed if launches[k] == 0]
    seconds = time.perf_counter() - t_phase
    print(f"[sharded] shard_params on a (1, 1) mesh of a deep copy took {shard_s:.1f} s; "
          f"launches in the sharded runs {launches}; {left_gib:.2f} GiB still allocated after "
          f"the copy was freed; phase {seconds:.1f} s")
    if not ok:
        raise AssertionError("an engine over the sharded model gave other tokens")
    if missing:
        raise AssertionError(f"kernels {missing} were never launched over the sharded model")
    out = {name: {"sharded": {k: v for k, v in r.items() if k != "tokens"},
                  "unsharded": {k: v for k, v in plain[name].items() if k != "tokens"}}
           for name, r in sharded.items()}
    return dict(out, shard_s=shard_s, left_gib=left_gib, seconds=seconds, launches=launches)


def quantized_phase(model, cfg, int8_lm, g: torch.Generator) -> dict:
    """int8 LM, then int4 LM (offline and paged), then the int8 tower. The bf16
    LM of ``model`` is consumed by the int4 quantiser."""
    from videollamb_torch.models.assembly import VideoLLaMB
    from videollamb_torch.models.lm.quant import linear_weight_bytes
    from videollamb_torch.models.vision.clip_vit import vision_encode
    from videollamb_torch.models.vision.quant import quantize_vision_params

    requests = [([40], 16), ([40, 27], 32)]
    gib = 2 ** 30
    bf16_bytes = linear_weight_bytes(model.lm)
    stats = []

    int8_model = VideoLLaMB(model.video_tower, model.mm_projector, int8_lm)
    int8 = slice_phase(int8_model, cfg, g, requests=requests, new=16, label="int8 LM")
    int8_bytes = linear_weight_bytes(int8_lm)
    stats += int8["stats"]
    del int8_model

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    before = torch.cuda.memory_allocated()
    lm_variant(model, "int4")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    int4_bytes = linear_weight_bytes(model.lm)
    print(f"[quant] int4 quantisation of the 7B LM on the card: {time.perf_counter() - t0:.1f} s, "
          f"allocated {before / gib:.2f} -> {torch.cuda.memory_allocated() / gib:.2f} GiB")
    print(f"[quant] projection and lm_head weights held on the card: bf16 "
          f"{bf16_bytes / gib:.2f} GiB, int8 {int8_bytes / gib:.2f} GiB, int4 "
          f"{int4_bytes / gib:.2f} GiB")
    int4 = slice_phase(model, cfg, g, requests=requests, new=16, label="int4 LM", int4=True)
    stats += int4["stats"]
    paged = serve_run(model, cfg, g, quantize_kv=True, frames=16, new=16, k=8,
                      prompt_lens=[24, 90, 40, 61], label="int4 LM, int8 pages, 8 slots")
    stats.append(paged)
    for name in ("gathered_paged_attention", "paged_fresh_write", "int4_matmul"):
        if paged["launches"][name] == 0:
            raise AssertionError(f"kernel {name} was never launched by the int4 paged run")
    # All four requests are admitted together and decode 16 steps: 225 launches
    # a step, plus lm_head on the last row of each 256-token admission chunk
    # (M = 1, so it takes the kernel; the chunk's other products have M = 256).
    steps, chunks = divmod(paged["launches"]["int4_matmul"], K7_PER_STEP)
    if steps != 16 or not 4 <= chunks <= 32:
        raise AssertionError(f"int4 paged run: int4_matmul launched {K7_PER_STEP} x {steps} + "
                             f"{chunks} times, want 225 x 16 decode steps + 4..32 chunks")
    print(f"[quant] int4 paged run: int4_matmul {K7_PER_STEP} x {steps} decode steps + {chunks} "
          f"admission chunks")

    # int8 tower on one 16-frame clip against the bf16 tower.
    clip = make_batch(cfg, g, [40], 16).videos
    want = vision_encode(model.video_tower, clip, cfg.vision)
    bf16_ms = cuda_ms(lambda: vision_encode(model.video_tower, clip, cfg.vision), iters=3, warmup=1)
    quantize_vision_params(model.video_tower)
    got = vision_encode(model.video_tower, clip, cfg.vision)
    int8_ms = cuda_ms(lambda: vision_encode(model.video_tower, clip, cfg.vision), iters=3, warmup=1)
    rel = float((got.float() - want.float()).norm() / want.float().norm())
    ok = bool(torch.isfinite(got).all()) and got.shape == want.shape and rel <= INT8_TOWER_REL_L2
    print(f"[quant] int8 tower, 16 frames: rel_l2 vs the bf16 tower {rel:.3e} (tol "
          f"{INT8_TOWER_REL_L2}), {int8_ms:.1f} ms against {bf16_ms:.1f} ms -> "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the int8 tower disagrees with the bf16 tower")
    return dict(stats=stats, launches=int4["launches"], paged_launches=paged["launches"],
                weight_gib=dict(bf16=bf16_bytes / gib, int8=int8_bytes / gib,
                                int4=int4_bytes / gib),
                int8_tower=dict(rel_l2=rel, ms=int8_ms, bf16_ms=bf16_ms))


TRAIN_TEXT = 64  # text ids per training sample, spliced with 16 frames into 2048 tokens
TRAIN_STEPS = 8  # timed steps per recipe, after one warm-up step
TRAIN_LR = 1e-3
# Depth-cut train step, kernels in bf16 on the card against the plain route in
# f32 on the host: relative error of the loss and relative L2 of each trained
# group's gradient (bf16 activations through the tower, bridge and two layers).
# The loss limit lies between the sound runs' readings (5.81e-05 and 1.72e-04)
# and that of a known fault (8.31e-03: SceneTilling cut different segments on
# the two sides); a random-init LM's loss sits near ln(32000) whatever its
# inputs, so the loss alone moves little under a fault.
TRAIN_LOSS_REL = 2e-3
TRAIN_GRAD_REL_L2 = 1e-1


class TrainClips:
    """An in-memory dataset of processed clips (16 frames unless ``frames``
    says) and their conversation ids, with the interface the Trainer reads."""

    def __init__(self, cfg, n: int, seed: int, frames: int = 16):
        import numpy as np

        from videollamb_torch.constants import IGNORE_INDEX, VIDEO_TOKEN_INDEX

        rng = np.random.default_rng(seed)
        img = cfg.vision.image_size
        self.samples = []
        for _ in range(n):
            ids = rng.integers(4, cfg.lm.vocab_size, size=TRAIN_TEXT).astype(np.int32)
            ids[2] = VIDEO_TOKEN_INDEX
            labels = np.where(np.arange(TRAIN_TEXT) < TRAIN_TEXT // 2, IGNORE_INDEX, ids)
            self.samples.append({"input_ids": ids, "labels": labels.astype(np.int32),
                                 "video": rng.normal(size=(frames, 3, img, img))
                                 .astype(np.float32)})

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]

    def modality(self, i):
        return "video"

    def modality_lengths(self):
        return [TRAIN_TEXT] * len(self.samples)


def train_batch(cfg, clips: "TrainClips"):
    from videollamb_torch.train.dataset import Collator
    from videollamb_torch.train.trainer import pin_batch, to_device

    return to_device(pin_batch(Collator(max_length=cfg.max_length)([clips[0]]),
                             torch.device("cuda")), torch.device("cuda"))


def kernel_device_ms(prof) -> dict:
    """Device time of the kernels in a profile, in total and by kind (name)."""
    kinds = {"gemm": ("gemm", "cutlass", "xmma", "cublas", "matmul"),
             "optimizer": ("multi_tensor", "foreach", "adam")}
    out = {"total": 0.0, "gemm": 0.0, "optimizer": 0.0}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        out["total"] += us / 1e3
        name = e.key.lower()
        for kind, marks in kinds.items():
            if any(m in name for m in marks):
                out[kind] += us / 1e3
                break
    return out


def chunked_attention_ms(cfg) -> float:
    """One layer's chunked attention at the step's shape, as a remat step runs
    it (forward, the layer's recompute, and the backward with its own block
    recompute), timed alone with CUDA events."""
    from videollamb_torch.ops.attention import multihead_attention

    lm = cfg.lm
    shape = (1, cfg.max_length, lm.num_attention_heads, lm.head_dim)
    q, k, v = (torch.randn(shape, device="cuda", dtype=torch.bfloat16).requires_grad_(True)
               for _ in range(3))
    mask = torch.ones((1, cfg.max_length), dtype=torch.bool, device="cuda")

    def once():
        with torch.no_grad():
            multihead_attention(q, k, v, causal=True, k_mask=mask, impl="chunked")
        out = multihead_attention(q, k, v, causal=True, k_mask=mask, impl="chunked")
        torch.autograd.grad(out.float().square().mean(), (q, k, v))

    with torch.enable_grad():
        return cuda_ms(once, iters=3, warmup=1)


class GcClock:
    """Wall time the interpreter spends in its cyclic garbage collector, and
    its collections of the oldest generation, while installed."""

    def __init__(self):
        self.ms, self.full, self._t0 = 0.0, 0, 0.0

    def __call__(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.ms += (time.perf_counter() - self._t0) * 1e3
            self.full += info["generation"] == 2

    @contextlib.contextmanager
    def installed(self):
        gc.callbacks.append(self)
        try:
            yield self
        finally:
            gc.callbacks.remove(self)


@contextlib.contextmanager
def unfrozen_after():
    """Give the objects that ``gc.freeze`` set aside back to the collector."""
    try:
        yield
    finally:
        gc.unfreeze()


def allocator_counts(clock: GcClock) -> dict:
    """The caching allocator's running counts of cudaMalloc calls and of
    retries (a failed allocation that frees the cache and tries again), and
    the collector's running ms and full collections."""
    stats = torch.cuda.memory_stats()
    return {**{k: stats.get(k, 0) for k in ("num_device_alloc", "num_alloc_retries")},
            "gc_ms": clock.ms, "gc_full": clock.full}


def run_recipe(label, model, cfg, tcfg, clips) -> dict:
    """One warm-up step and TRAIN_STEPS timed steps on one batch repeated
    through the port's create_optimizer / trainable_mask / make_train_step, then
    one profiled step. Without dropout (no generator, as bench.py's stage-1
    step runs), so that the loss can only move by the updates."""
    from videollamb_torch.train.step import (
        create_optimizer,
        create_train_state,
        make_train_step,
        trainable_mask,
    )

    tx = create_optimizer(tcfg, 1000, model)
    state = create_train_state(model, tx)
    step = make_train_step(cfg, tx, remat=True, attn_impl="chunked",
                           mask=trainable_mask(tcfg, model))
    batch = train_batch(cfg, clips)
    # This script's earlier phases leave over a million objects that the
    # collector tracks, and a full collection over them took 2.0 s of one
    # step. They belong to no training run, so they are collected (with the
    # device memory their cycles hold) and frozen out of the collector's
    # reach while the steps are timed.
    gc.collect()
    tracked = len(gc.get_objects())
    gc.freeze()
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    reserved = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    losses, times, allocs = [], [], []
    with GcClock().installed() as clock, unfrozen_after():
        for i in range(1 + TRAIN_STEPS):
            torch.cuda.synchronize()
            before = allocator_counts(clock)
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            loss = float(metrics["loss"])
            torch.cuda.synchronize()
            losses.append(loss)
            if i:
                times.append((time.perf_counter() - t0) * 1e3)
                allocs.append({k: v - before[k] for k, v in allocator_counts(clock).items()})
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            float(metrics["loss"])
            torch.cuda.synchronize()
            profiled_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    dev = kernel_device_ms(prof)
    n_trained = sum(p.numel() for p in tx.params)
    median = statistics.median(times)
    out = dict(step_ms_median=median, step_ms_min=min(times), step_ms_max=max(times),
               step_ms=times, step_allocator=allocs, samples_per_s=1000.0 / median,
               losses=losses, grad_norm=float(metrics["grad_norm"]), trained_params=n_trained,
               profiled_step_ms=profiled_ms, device_ms=dev,
               peak_allocated_gib=peak / 2**30, resident_gib=resident / 2**30)
    busy = ("device time not measured" if dev["total"] == 0.0 else
            f"{dev['total']:.1f} ms of kernels ({dev['total'] / profiled_ms:.1%} of it busy; "
            f"{dev['total'] / out['step_ms_median']:.1%} of the unprofiled median): GEMMs "
            f"{dev['gemm']:.1f} ms, optimizer {dev['optimizer']:.1f} ms")
    print(f"[train] {label}: {n_trained / 1e6:.1f} M trained parameters, step "
          f"{median:.1f} ms median ({min(times):.1f}-{max(times):.1f}) over "
          f"{TRAIN_STEPS} steps, {out['samples_per_s']:.2f} samples/s; losses "
          f"{[round(x, 4) for x in losses]}; peak allocated {peak / 2**30:.2f} GiB "
          f"({(peak - resident) / 2**30:.2f} GiB over the {resident / 2**30:.2f} GiB resident); "
          f"profiled step {profiled_ms:.1f} ms, {busy}")
    print(f"[train] {label.split()[0]}: steps in order (ms; device mallocs, allocator "
          f"retries, ms in the garbage collector, its full collections; "
          f"{reserved / 2**30:.2f} GiB reserved and {tracked} objects frozen out of the "
          f"collector at the start): " + ", ".join(
              f"{t:.1f} ({a['num_device_alloc']}, {a['num_alloc_retries']}, "
              f"{a['gc_ms']:.1f}, {a['gc_full']})" for t, a in zip(times, allocs)))
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: losses {losses} not finite or not falling on one batch")
    return out


def train_reference(g: torch.Generator, seed: int) -> dict:
    """One LoRA + projector train step's loss and gradients on a depth-cut
    model at full width (2 tower layers, 2 LM layers): kernels in bf16 on the
    card against the plain route in f32 on the host."""
    from unittest import mock

    from videollamb_torch.config import ModelConfig, TrainConfig
    from videollamb_torch.models.assembly import causal_lm_loss, videollamb_forward
    from videollamb_torch.models.bridge import rmt_r
    from videollamb_torch.models.lm.lora import add_lora_params
    from videollamb_torch.models.vision.clip_vit import vision_encode
    from videollamb_torch.ops.scene_tilling import segment_topk
    from videollamb_torch.train.step import apply_trainable_mask, trainable_mask

    base = ModelConfig()
    cfg = dataclasses.replace(
        base, max_length=1280, vision=dataclasses.replace(base.vision, num_hidden_layers=3),
        lm=dataclasses.replace(base.lm, num_hidden_layers=2))
    gpu = build_model(cfg, seed + 40, "cuda", torch.bfloat16)
    add_lora_params(gpu.lm, cfg.lm, r=16, alpha=32.0, dtype=torch.bfloat16,
                    generator=torch.Generator(device="cuda").manual_seed(seed + 41))
    for m in gpu.lm.modules():  # B away from zero, so that A takes a gradient too
        if hasattr(m, "lora_b"):
            m.lora_b.data.normal_(0.0, 0.02, generator=g)
    cpu = copy.deepcopy(gpu).float().cpu()
    gpu.mm_projector.float()  # f32 masters on the card, as the recipes train them
    clips = TrainClips(cfg, 1, seed + 42)
    clips.samples[0]["video"] = scene_clip(g, cfg.vision.image_size, [2, 2, 2, 2], 0.05)
    tcfg = TrainConfig(tune_mode="lora")
    batch = train_batch(cfg, clips)
    sides = [(gpu, "cuda"), (cpu, "cpu")]
    batches = [type(batch)(*(None if x is None else x.to(dev) for x in batch)) for _, dev in sides]
    cuts = []
    for (model, _), b in zip(sides, batches):
        feats = vision_encode(model.video_tower, b.videos, cfg.vision)
        cuts.append(segment_topk(feats[0, :, 0], k=cfg.bridge.segment_topk).tolist())
    # Both steps segment the clip at the host's cuts. A random 3-layer tower
    # hardly tells the four scenes apart, so their depths near-tie and bf16
    # may pick another cut: a different segment plan, not a numerical error.
    # Each side's own cuts are printed.
    plan = cuts[1]
    results = []
    with torch.enable_grad(), mock.patch.object(
            rmt_r, "segment_topk", lambda f, k: torch.tensor(plan, dtype=torch.int32,
                                                             device=f.device)):
        for (model, _), b in zip(sides, batches):
            apply_trainable_mask(model, trainable_mask(tcfg, model))
            zero_counters()
            logits, spliced = videollamb_forward(model, cfg, b, remat=True, attn_impl="chunked")
            loss, _ = causal_lm_loss(logits, spliced.labels)
            names = [n for n, p in model.named_parameters() if p.requires_grad]
            grads = torch.autograd.grad(loss, [p for n, p in model.named_parameters()
                                               if p.requires_grad], allow_unused=True)
            launched = read_counters()
            results.append((float(loss.detach()), dict(zip(names, grads)), launched))
    (gl, gg, launched), (cl, cg, _) = results
    groups = {"projector": lambda n: n.startswith("mm_projector."),
              "lora_a": lambda n: n.endswith(".lora_a"), "lora_b": lambda n: n.endswith(".lora_b")}
    errs = {}
    for group, pick in groups.items():
        a = torch.cat([gg[n].float().cpu().flatten() for n in gg if pick(n) and gg[n] is not None])
        b = torch.cat([cg[n].flatten() for n in cg if pick(n) and cg[n] is not None])
        errs[group] = float((a - b).norm() / b.norm())
    loss_rel = abs(gl - cl) / abs(cl)
    ok = (loss_rel <= TRAIN_LOSS_REL and all(e <= TRAIN_GRAD_REL_L2 for e in errs.values())
          and launched["spatial_attention"] > 0 and launched["temporal_attention"] > 0)
    print(f"[train] depth-cut LoRA + projector step, kernels bf16 on the card vs plain f32 on "
          f"the host: segment ends {cuts[0]} / {cuts[1]}, both steps at {plan}; "
          f"loss {gl:.5f} vs {cl:.5f} (rel {loss_rel:.2e}, tol {TRAIN_LOSS_REL}); "
          f"gradient rel_l2 { {k: f'{v:.3e}' for k, v in errs.items()} } (tol "
          f"{TRAIN_GRAD_REL_L2}); card K1 {launched['spatial_attention']}, K2 "
          f"{launched['temporal_attention']} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the card's train step disagrees with the host's")
    del gpu, cpu
    torch.cuda.empty_cache()
    return dict(loss_card=gl, loss_host=cl, loss_rel=loss_rel, grad_rel_l2=errs,
                segment_ends=cuts)


def trainer_run(model, cfg, seed: int) -> dict:
    """The Trainer over TrainClips (adapter recipe, one clip a step): it saves a
    checkpoint at the end; a second Trainer over a fresh projector resumes
    from it, and its parameters, update count and generator must equal."""
    import shutil

    from videollamb_torch.config import TrainConfig
    from videollamb_torch.models.assembly import VideoLLaMB
    from videollamb_torch.models.bridge.rmt_r import init_rmt_r_params
    from videollamb_torch.train.trainer import Trainer

    outdir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "train_smoke")
    shutil.rmtree(outdir, ignore_errors=True)
    tcfg = TrainConfig(tune_mode="adapter", per_device_batch_size=1, save_steps=0,
                       learning_rate=TRAIN_LR, output_dir=outdir, seed=seed)
    clips = TrainClips(cfg, 3, seed + 50)

    def fresh(bridge_seed):
        return VideoLLaMB(model.video_tower, init_rmt_r_params(
            cfg.bridge, cfg.lm.hidden_size, seed=bridge_seed, device="cuda"), model.lm)

    logs = []
    t0 = time.perf_counter()
    first = Trainer(cfg, tcfg, fresh(seed + 51), clips, log_fn=logs.append)
    state = first.train()
    train_s = time.perf_counter() - t0
    resumed = Trainer(cfg, tcfg, fresh(seed + 52), clips, log_fn=logs.append)
    same = all(torch.equal(a, b) for a, b in zip(state.model.mm_projector.parameters(),
                                                 resumed.state.model.mm_projector.parameters()))
    ok = (same and resumed.state.step == state.step == len(clips)
          and resumed.tx.updates == first.tx.updates
          and torch.equal(resumed.generator.get_state(), first.generator.get_state())
          and os.path.exists(os.path.join(outdir, f"checkpoint-{state.step}", "mm_projector.bin"))
          and all(math.isfinite(m["loss"]) for m in logs))
    print(f"[train] Trainer: {state.step} steps over {len(clips)} clips in {train_s:.1f} s "
          f"(checkpoint included), losses {[round(m['loss'], 4) for m in logs]}; resumed at "
          f"step {resumed.state.step} with equal projector, updates and generator -> "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the Trainer did not resume from its checkpoint")
    shutil.rmtree(outdir, ignore_errors=True)
    return dict(steps=state.step, seconds=train_s, losses=[m["loss"] for m in logs])


def remove_lora(lm) -> None:
    from videollamb_torch.models.lm.lora import LoRALinear, _targets, LORA_TARGETS

    for parent, name in _targets(lm, LORA_TARGETS):
        module = getattr(parent, name)
        if isinstance(module, LoRALinear):
            setattr(parent, name, module.base)


def train_phase(model, cfg, int8_lm, g: torch.Generator, seed: int) -> dict:
    """Training at full width and depth: the stage-1 adapter recipe over the
    frozen bf16 7B and tower, the stage-2 QLoRA recipe over the int8 LM (LoRA
    r=128, alpha 256, on every projection, and the projector), the Trainer with
    a checkpoint and a resume, then the depth-cut card-vs-host step."""
    from videollamb_torch.config import TrainConfig
    from videollamb_torch.models.assembly import VideoLLaMB
    from videollamb_torch.models.bridge.rmt_r import init_rmt_r_params
    from videollamb_torch.models.lm.lora import add_lora_params

    clips = TrainClips(cfg, 1, seed + 60)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    zero_counters()
    with torch.enable_grad():
        adapter_model = VideoLLaMB(model.video_tower, init_rmt_r_params(
            cfg.bridge, cfg.lm.hidden_size, seed=seed + 61, device="cuda"), model.lm)
        adapter = run_recipe("train_adapter (stage 1: projector over the frozen bf16 7B)",
                             adapter_model, cfg, TrainConfig(tune_mode="adapter",
                                                             learning_rate=TRAIN_LR),
                             clips)
        del adapter_model
        add_lora_params(int8_lm, cfg.lm, r=128, alpha=256.0,
                        generator=torch.Generator(device="cuda").manual_seed(seed + 63))
        qlora_model = VideoLLaMB(model.video_tower, init_rmt_r_params(
            cfg.bridge, cfg.lm.hidden_size, seed=seed + 64, device="cuda"), int8_lm)
        qlora = run_recipe("train_qlora (stage 2: LoRA r=128 on every projection of the "
                           "int8 7B, and the projector)", qlora_model, cfg,
                           TrainConfig(tune_mode="lora", learning_rate=TRAIN_LR),
                           clips)
        del qlora_model
        remove_lora(int8_lm)
        trainer = trainer_run(model, cfg, seed)
    torch.cuda.synchronize()
    launches = read_counters()
    seconds = time.perf_counter() - t0
    attn_ms = chunked_attention_ms(cfg)
    per_step = attn_ms * cfg.lm.num_hidden_layers
    print(f"[train] chunked attention at (1, {cfg.max_length}, {cfg.lm.num_attention_heads}, "
          f"{cfg.lm.head_dim}) bf16, forward + remat recompute + backward, timed alone: "
          f"{attn_ms:.2f} ms a layer, {per_step:.1f} ms over {cfg.lm.num_hidden_layers} layers: "
          f"{per_step / adapter['step_ms_median']:.1%} of the adapter step, "
          f"{per_step / qlora['step_ms_median']:.1%} of the QLoRA step")
    print(f"[train] phase launches K1 {launches['spatial_attention']}, K2 "
          f"{launches['temporal_attention']}; {seconds:.1f} s")
    if launches["spatial_attention"] == 0 or launches["temporal_attention"] == 0:
        raise AssertionError("the train phase launched no K1 or K2")
    reference = train_reference(g, seed)
    return dict(train_adapter=adapter, train_qlora=qlora, trainer=trainer,
                chunked_attention_ms_per_layer=attn_ms, seconds=seconds, launches=launches,
                reference=reference)


def speculative_reference(cpu_model, cfg) -> None:
    """On the host copy of the depth-cut model, f32: lookup and int8 self-draft
    speculation give plain greedy's tokens, one for one."""
    from videollamb_torch.models.lm.quant import quantize_llama_params
    from videollamb_torch.serve.chat import Chat

    cfg = dataclasses.replace(cfg, max_length=1024)
    chat = Chat(SmokeTokenizer(cfg.lm.vocab_size), cpu_model, cfg, {})
    img = cfg.vision.image_size
    frames = torch.randn((8, 3, img, img), generator=torch.Generator().manual_seed(3)).numpy()
    draft = quantize_llama_params(copy.deepcopy(cpu_model.lm))
    # Few tokens and short chunks: every int8 draft pass dequantises lm_head on the host.
    runs = speculative_chat_runs(chat, frames, draft, 10, "depth-cut f32, host", k=4)
    greedy = runs["greedy"][0]
    for mode in ("lookup", "draft"):
        if runs[mode][0] != greedy or not greedy:
            raise AssertionError(f"f32 {mode} speculation differs from greedy: "
                                 f"{runs[mode][0]} vs {greedy}")
    print("[spec] depth-cut f32: lookup and int8 self-draft equal greedy token for token -> ok")


def reference_phase(g: torch.Generator, seed: int) -> None:
    """Kernel path (card, bf16) vs plain path (host, f32) on a depth-cut model."""
    from videollamb_torch.config import ModelConfig
    from videollamb_torch.models.assembly import prepare_multimodal_embeds
    from videollamb_torch.models.lm.llama import embed_tokens, init_kv_cache, llama_prefill
    from videollamb_torch.models.lm.paged import fused_admit, init_paged_cache, paged_decode_step
    from videollamb_torch.models.vision.clip_vit import vision_encode

    base = ModelConfig()
    cfg = dataclasses.replace(
        base, vision=dataclasses.replace(base.vision, num_hidden_layers=3),
        lm=dataclasses.replace(base.lm, num_hidden_layers=1))
    gpu = build_model(cfg, seed + 10, "cuda", torch.bfloat16)
    cpu = copy.deepcopy(gpu).float().cpu()
    batch = make_batch(cfg, g, [40], 16)

    def rel_l2(a, b):
        return float((a.float().cpu() - b.float()).norm() / b.float().norm())

    feats_gpu = vision_encode(gpu.video_tower, batch.videos, cfg.vision)
    feats_cpu = vision_encode(cpu.video_tower, batch.videos.float().cpu(), cfg.vision)
    errs = {"tower features": rel_l2(feats_gpu, feats_cpu)}
    spliced = prepare_multimodal_embeds(gpu, cfg, batch)
    logits = []
    for model, dev, dtype in ((gpu, "cuda", torch.bfloat16), (cpu, "cpu", torch.float32)):
        cache = init_kv_cache(cfg.lm, 1, cfg.max_length, dtype=dtype, device=dev)
        out, _ = llama_prefill(model.lm, cfg.lm, spliced.embeds.to(dev, dtype),
                               spliced.attention_mask.to(dev), cache)
        logits.append(out)
    errs["prefill logits"] = rel_l2(*logits)

    # Paged admission of the same splice and two decode steps with forced
    # tokens, per pool type, two slots (the second empty): the card runs K4
    # and K5 (int8 pages) or K6 (bf16 pages), the host the XLA twins.
    prompt_len = int(spliced.attention_mask.sum())
    pages = list(range(1, 1 + -(-(prompt_len + 2) // PAGE)))
    page_ids = pages + [0] * (PPS - len(pages))
    forced = [[101, 7], [2024, 9]]
    for quantize_kv in (True, False):
        step_logits = []
        for model, dev, dtype in ((gpu, "cuda", torch.bfloat16), (cpu, "cpu", torch.float32)):
            cache = init_paged_cache(cfg.lm, 2, 1 + 2 * PPS, PAGE, PPS, dtype,
                                     quantize=quantize_kv, device=dev)
            first = torch.zeros((2, cfg.lm.vocab_size), device=dev)
            fused_admit(model.lm, cfg.lm, spliced.embeds.to(dev, dtype),
                        spliced.attention_mask.to(dev), prompt_len, cache, first, 0, page_ids)
            for tok in forced:
                out = paged_decode_step(model.lm, cfg.lm, embed_tokens(
                    model.lm, torch.tensor(tok, device=dev)[:, None]), cache)
            step_logits.append(out[0])
        errs[f"paged decode logits, {'int8' if quantize_kv else 'bf16'} pages"] = rel_l2(
            *step_logits)
        if not torch.isfinite(step_logits[0]).all():
            raise AssertionError("non-finite paged decode logits on the card")
    ok = all(e <= PATH_REL_L2 for e in errs.values())
    print(f"[reference] depth-cut model, kernels bf16 vs plain f32, rel_l2: "
          f"{ {k: f'{v:.3e}' for k, v in errs.items()} }, tol {PATH_REL_L2} -> "
          f"{'ok' if ok else 'FAIL'}")
    if not ok or not all(torch.isfinite(x).all() for x in (feats_gpu, logits[0])):
        raise AssertionError("kernel path disagrees with the plain path")
    del gpu
    torch.cuda.empty_cache()
    speculative_reference(cpu, cfg)


def encoder_phase(g: torch.Generator, seed: int) -> dict:
    """The tower's encode-throughput path at full width and depth: 256 frames
    through ``vision_encode`` in bf16, then int8 (K1 and K2, 23 launches each
    per encode); the (b, n, t, d) temporal branch through K9, K10 in K2's place
    and K11 in K1's, each held against the live tower's features; the
    isolated split-layout core (K8) x 23."""
    from scripts.profile_torch_encoder import encode_with, layer_variant
    from videollamb_torch.config import VisionConfig
    from videollamb_torch.models.vision.clip_vit import init_vision_params, vision_encode
    from videollamb_torch.models.vision.quant import quantize_vision_params
    from videollamb_torch.ops.spatial_attention import fused_spatial_core

    cfg = VisionConfig()
    tower = init_vision_params(cfg, seed=seed + 20, dtype=torch.bfloat16, device="cuda")
    img = cfg.image_size
    pixels = torch.randn((ENC_VIDEOS, ENC_T, 3, img, img), generator=g,
                         device="cuda").to(torch.bfloat16)
    out, launches = {}, {}

    def rel_l2(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    def counted(label, fn):
        torch.cuda.synchronize()
        zero_counters()
        res = fn()
        torch.cuda.synchronize()
        launches[label] = read_counters()
        return res

    ref = counted("encode bf16", lambda: vision_encode(tower, pixels, cfg))
    ms = cuda_ms(lambda: vision_encode(tower, pixels, cfg), iters=3, warmup=1)
    out["bf16"] = dict(ms=ms, frames_per_s=ENC_FRAMES / ms * 1e3)
    n_layers = ENC_LAYERS
    variants = {}
    for label, mode, kernel in (("old_temporal (K9)", "old_temporal", "temporal_core"),
                                ("K10 for K2", "fm_three", "temporal_core_fm"),
                                ("K11 for K1", "block_spatial", "block_attention")):
        layer = layer_variant(cfg, mode, ENC_T)
        feats = counted(label, lambda: encode_with(tower, pixels, cfg, layer, n_layers))
        ms = cuda_ms(lambda: encode_with(tower, pixels, cfg, layer, n_layers), iters=2, warmup=1)
        err = rel_l2(feats.reshape(ref.shape), ref)
        variants[label] = dict(ms=ms, frames_per_s=ENC_FRAMES / ms * 1e3, rel_l2=err,
                               launches=launches[label][kernel])
        print(f"[encoder] {label}: {ms:.1f} ms ({ENC_FRAMES / ms * 1e3:.1f} f/s), rel_l2 vs the "
              f"live tower {err:.3e} (tol {ENCODER_REL_L2}), {kernel} launched "
              f"{launches[label][kernel]} times")
        if not torch.isfinite(feats).all() or err > ENCODER_REL_L2:
            raise AssertionError(f"encoder variant {label} disagrees with the live tower")
        if launches[label][kernel] != n_layers:
            raise AssertionError(f"encoder variant {label}: {kernel} launched "
                                 f"{launches[label][kernel]} times, want {n_layers}")
        del feats
    out["variants"] = variants

    x = [torch.randn((ENC_FRAMES, 16, 257, 64), generator=g, device="cuda").to(torch.bfloat16)
         for _ in range(3)]
    x[0] *= 0.125

    def core_x23():
        for _ in range(n_layers):
            fused_spatial_core(*x)

    counted("spatial core x23", core_x23)
    out["spatial_core_x23_ms"] = cuda_ms(core_x23, iters=2, warmup=1)
    del x

    tower8 = quantize_vision_params(tower)  # in place: the bf16 runs are done
    got = counted("encode int8", lambda: vision_encode(tower8, pixels, cfg))
    ms = cuda_ms(lambda: vision_encode(tower8, pixels, cfg), iters=3, warmup=1)
    mean_rel = float((got.float() - ref.float()).abs().mean() / ref.float().abs().mean())
    out["int8"] = dict(ms=ms, frames_per_s=ENC_FRAMES / ms * 1e3, rel_err_vs_bf16=mean_rel,
                       rel_l2_vs_bf16=rel_l2(got, ref))
    del tower8, got, ref
    torch.cuda.empty_cache()
    for label in ("encode bf16", "encode int8"):
        k1, k2 = launches[label]["spatial_attention"], launches[label]["temporal_attention"]
        if (k1, k2) != (n_layers, n_layers):
            raise AssertionError(f"{label}: K1 launched {k1} and K2 {k2} times, want {n_layers}")
    if launches["spatial core x23"]["spatial_core"] != n_layers:
        raise AssertionError("the isolated split-layout core did not launch K8 23 times")
    ok = (out["int8"]["rel_l2_vs_bf16"] <= INT8_TOWER_REL_L2)
    print(f"[encoder] {ENC_VIDEOS} videos x {ENC_T} frames, {n_layers} layers: bf16 "
          f"{out['bf16']['ms']:.1f} ms ({out['bf16']['frames_per_s']:.1f} f/s), int8 "
          f"{out['int8']['ms']:.1f} ms ({out['int8']['frames_per_s']:.1f} f/s), int8 error "
          f"mean|d|/mean|bf16| {mean_rel:.4f}, rel_l2 {out['int8']['rel_l2_vs_bf16']:.3e} (tol "
          f"{INT8_TOWER_REL_L2}); K8 x{n_layers} {out['spatial_core_x23_ms']:.2f} ms; K1 / K2 "
          f"launches per encode {n_layers} / {n_layers} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the int8 tower disagrees with the bf16 tower at 256 frames")
    out["launches"] = launches
    return out


def gradient_phase(g: torch.Generator, seed: int) -> dict:
    """Gradients through the tower: a 2-layer tower at full width on the card
    (the forward launches K1 and K2, the backward no kernel) against the plain
    route on a host copy in f32; then a forward-only wrapper refuses an input
    that wants a gradient."""
    from videollamb_torch.config import VisionConfig
    from videollamb_torch.models.vision.clip_vit import init_vision_params, vision_encode
    from videollamb_torch.ops.flash_attention import block_attention

    cfg = VisionConfig(num_hidden_layers=3)  # select layer -2: two layers run
    tower = init_vision_params(cfg, seed=seed + 30, dtype=torch.bfloat16, device="cuda")
    host = copy.deepcopy(tower).float().cpu()
    img = cfg.image_size
    pixels = torch.randn((2, 8, 3, img, img), generator=g, device="cuda").to(torch.bfloat16)
    names = ("vision_model.encoder.layers.0.temporal_attn.q_proj.weight",
             "vision_model.encoder.layers.0.self_attn.k_proj.weight")
    grads = []
    with torch.enable_grad():
        for model, px in ((tower, pixels), (host, pixels.float().cpu())):
            px = px.clone().requires_grad_(True)
            torch.cuda.synchronize()
            zero_counters()
            feats = vision_encode(model, px, cfg)
            torch.cuda.synchronize()
            forward = read_counters()
            (feats.float() ** 2).sum().backward()
            torch.cuda.synchronize()
            backward = {k: v - forward[k] for k, v in read_counters().items()}
            params = dict(model.named_parameters())
            grads.append([px.grad] + [params[n].grad for n in names])
            if model is tower:
                launched = (forward, backward)
    errs = {name: float((a.float().cpu() - b).norm() / b.norm())
            for name, a, b in zip(("pixels",) + names, *grads)}
    forward, backward = launched
    ok = (all(e <= GRAD_REL_L2 for e in errs.values())
          and all(torch.isfinite(x).all() for x in grads[0])
          and forward["spatial_attention"] == 2 and forward["temporal_attention"] == 2
          and not any(backward.values()))
    print(f"[grad] 2-layer tower, 2 videos x 8 frames, kernels bf16 vs plain f32 host, rel_l2 "
          f"{ {k.split('.', 3)[-1]: f'{v:.3e}' for k, v in errs.items()} } (tol {GRAD_REL_L2}); "
          f"forward launches K1 {forward['spatial_attention']}, K2 "
          f"{forward['temporal_attention']}; backward launches {sum(backward.values())} "
          f"-> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("gradients through the tower disagree, or the backward launched "
                             "a kernel")
    x = torch.randn((1, 2, 16, 64), device="cuda").to(torch.bfloat16).requires_grad_(True)
    with torch.enable_grad():
        try:
            block_attention(x, x, x)
        except RuntimeError as exc:
            print(f"[grad] a forward-only wrapper refuses an input that wants a gradient: {exc}")
        else:
            raise AssertionError("block_attention took a requires_grad input without raising")
    del tower, host
    torch.cuda.empty_cache()
    return dict(rel_l2=errs, forward_launches=forward, backward_launches=backward)


class CaptureTx:
    """The optimizer contract of the train steps (``params``, ``update``)
    keeping each call's gradients in place of an update, so that the
    parallel steps' gradients can be held against the plain step's."""

    def __init__(self, params):
        self.params = list(params)
        self.grads = None

    def update(self, grads, norm_fn=None) -> bool:
        from torch.distributed.tensor import DTensor

        self.grads = [(g.full_tensor() if isinstance(g, DTensor) else g).detach().float()
                      for g in grads]
        return True


# The parallel phase's depth cut: train_reference's (3 tower layers, 2 LM
# layers, 1280 tokens) at full width.
PARALLEL_TOWER_LAYERS, PARALLEL_LM_LAYERS, PARALLEL_MAX_LENGTH = 3, 2, 1280


def parallel_phase(seed: int) -> dict:
    """The multi-GPU training paths on a one-rank group: the stage-1 step
    (f32 projector over the frozen bf16 tower and LM) through ``shard_params``
    on a (1, 1) mesh and the sharded step, through the sequence-parallel
    factory at one shard, and through the pipeline at one stage, each held
    against the plain port step's loss and gradients on the same batch."""
    import socket

    import torch.distributed as dist

    from videollamb_torch.config import ModelConfig, TrainConfig
    from videollamb_torch.parallel.mesh import create_mesh
    from videollamb_torch.parallel.pipeline import (
        create_pipeline_mesh,
        make_pipeline_videollamb_step,
        shard_stacked_layers,
    )
    from videollamb_torch.parallel.ring_attention import create_seq_mesh
    from videollamb_torch.parallel.seq_parallel import make_seq_parallel_videollamb_step
    from videollamb_torch.parallel.sharding import make_sharded_train_step, shard_params
    from videollamb_torch.train.step import TrainState, make_train_step, trainable_mask

    t_phase = time.perf_counter()
    base = ModelConfig()
    cfg = dataclasses.replace(
        base, max_length=PARALLEL_MAX_LENGTH,
        vision=dataclasses.replace(base.vision, num_hidden_layers=PARALLEL_TOWER_LAYERS),
        lm=dataclasses.replace(base.lm, num_hidden_layers=PARALLEL_LM_LAYERS))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0, world_size=1)
    try:
        template = build_model(cfg, seed + 200, "cuda", torch.bfloat16)
        template.mm_projector.float()  # the recipe's f32 masters
        clips = TrainClips(cfg, 1, seed + 201)
        tcfg = TrainConfig(tune_mode="adapter")
        from videollamb_torch.train.dataset import Collator
        from videollamb_torch.train.trainer import pin_batch, to_device

        cuda = torch.device("cuda")
        batch = to_device(pin_batch(Collator(max_length=cfg.max_length)([clips[0]]), cuda), cuda)

        def run(label, prepare, factory):
            model = copy.deepcopy(template)
            extra = prepare(model)
            mask = trainable_mask(tcfg, model)
            tx = CaptureTx(p for n, p in model.named_parameters() if mask[n])
            step = factory(model, tx, mask, extra)
            state = TrainState(0, model, tx)
            with torch.enable_grad():
                state, metrics = step(state, batch, None)  # warm-up
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                zero_counters()
                t0 = time.perf_counter()
                state, metrics = step(state, batch, None)
                loss = float(metrics["loss"])
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
            launched = read_counters()
            names = [n for n, p in model.named_parameters() if mask[n]]
            peak = torch.cuda.max_memory_allocated() / 2**30
            grads = dict(zip(names, tx.grads))
            del model, state, step
            gc.collect()
            torch.cuda.empty_cache()
            return dict(label=label, loss=loss, grads=grads, ms=ms, peak_gib=peak,
                        launches=launched)

        def plain(model, tx, mask, _):
            step = make_train_step(cfg, tx, remat=True, attn_impl="chunked", mask=mask)
            return lambda state, b, gen: step(state, b, gen)

        def sharded_prep(model):
            mesh = create_mesh(1, 1)
            shard_params(mesh, model)
            return mesh

        def sharded(model, tx, mask, mesh):
            return make_sharded_train_step(mesh, cfg, tx, remat=True, mask=mask)

        def seq(model, tx, mask, _):
            return make_seq_parallel_videollamb_step(create_seq_mesh(1), cfg, tx, mask=mask)

        def pipe_prep(model):
            mesh = create_pipeline_mesh(1)
            shard_stacked_layers(mesh, model.lm)
            return mesh

        def pipe(model, tx, mask, mesh):
            return make_pipeline_videollamb_step(mesh, cfg, tx, n_micro=1, mask=mask)

        ref = run("plain", lambda m: None, plain)
        runs = [run("FSDP x TP on a (1, 1) mesh", sharded_prep, sharded),
                run("sequence parallel at 1 shard", lambda m: None, seq),
                run("pipeline at 1 stage", pipe_prep, pipe)]
    finally:
        dist.destroy_process_group()
    out, ok = {"plain": {k: ref[k] for k in ("loss", "ms", "peak_gib", "launches")}}, True
    for r in runs:
        loss_rel = abs(r["loss"] - ref["loss"]) / abs(ref["loss"])
        a = torch.cat([r["grads"][n].flatten().cpu() for n in ref["grads"]])
        b = torch.cat([ref["grads"][n].flatten().cpu() for n in ref["grads"]])
        grad_rel = float((a - b).norm() / b.norm())
        good = (loss_rel <= TRAIN_LOSS_REL and grad_rel <= TRAIN_GRAD_REL_L2
                and r["launches"]["spatial_attention"] > 0
                and r["launches"]["temporal_attention"] > 0)
        ok &= good
        print(f"[parallel] {r['label']}: loss {r['loss']:.5f} vs plain {ref['loss']:.5f} "
              f"(rel {loss_rel:.2e}, tol {TRAIN_LOSS_REL}); projector gradient rel_l2 "
              f"{grad_rel:.3e} (tol {TRAIN_GRAD_REL_L2}); step {r['ms']:.1f} ms (plain "
              f"{ref['ms']:.1f}); peak allocated {r['peak_gib']:.2f} GiB (plain "
              f"{ref['peak_gib']:.2f}); K1 {r['launches']['spatial_attention']}, K2 "
              f"{r['launches']['temporal_attention']} -> {'ok' if good else 'FAIL'}")
        out[r["label"]] = dict(loss=r["loss"], loss_rel=loss_rel, grad_rel_l2=grad_rel,
                               ms=r["ms"], peak_gib=r["peak_gib"], launches=r["launches"])
    seconds = time.perf_counter() - t_phase
    print("[parallel] one-rank NCCL group, depth cut "
          f"({cfg.vision.num_hidden_layers} tower, {cfg.lm.num_hidden_layers} LM layers at "
          f"width {cfg.lm.hidden_size}); the cross-rank collectives are checked on the CPU "
          f"with gloo only; {seconds:.1f} s")
    if not ok:
        raise AssertionError("a parallel train path disagrees with the plain step")
    launches = dict.fromkeys(counters(), 0)
    for r in runs:
        for k, v in r["launches"].items():
            launches[k] += v
    return dict(out, seconds=seconds, launches=launches)


# EgoVLP's retrieval model at its published widths: roberta-base's text
# encoder (12 x 768, 6 fusion layers, projection 4096) and the ViT-B/16
# tower over 4 frames; the host check cuts both to 4 layers, 2 of them fused.
EGOVLP_TEXTS, EGOVLP_VIDEOS, EGOVLP_TEXT_LEN = 8, 4, 32
EGOVLP_REL_L2 = 5e-2


def egovlp_text_phase(seed: int) -> dict:
    """EgoVLP's text side on the card in bf16: text and video embeddings, their
    similarity matrix and an ITM fusion forward at full width and depth
    (timed); then a depth cut against the host in f32."""
    from videollamb_torch.models.vision import egovlp as ev
    from videollamb_torch.models.vision import egovlp_text as et

    t_phase = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(seed + 300)

    def models(tcfg, vcfg, device, dtype):
        text = et.init_egovlp_text_params(tcfg, vcfg, seed=seed + 301, dtype=dtype, device=device)
        video = et.init_fusion_video_params(vcfg, tcfg, seed=seed + 302, dtype=dtype,
                                            device=device)
        with torch.no_grad():  # open the gates: the fusion paths count
            for name, p in list(text.named_parameters()) + list(video.named_parameters()):
                if name.endswith(("alpha_t2i", "alpha_i2t")):
                    p.fill_(0.5)
        return text.eval(), video.eval()

    def inputs(tcfg, vcfg, n_text, n_video):
        ids = torch.randint(3, tcfg.vocab_size, (n_text, EGOVLP_TEXT_LEN), generator=g,
                            device="cuda")
        mask = torch.ones_like(ids)
        mask[1::2, EGOVLP_TEXT_LEN // 2:] = 0
        ids = torch.where(mask.bool(), ids, tcfg.pad_token_id)
        img = vcfg.image_size
        pixels = torch.randn((n_video, vcfg.num_frames, 3, img, img), generator=g, device="cuda")
        return ids, mask, pixels

    def forward(text, video, tcfg, vcfg, ids, mask, pixels):
        cls = ev.egovlp_encode(video, pixels, vcfg)[:, 0]
        t_emb = et.compute_text(text, tcfg, ids, mask)
        v_emb = et.compute_video_embed(text, cls)
        sims = et.sim_matrix(t_emb.float(), v_emb.float())
        n = pixels.shape[0]
        itm = et.fusion_forward(text, video, vcfg, tcfg, pixels, ids[:n], mask[:n])
        return dict(text=t_emb, video=v_emb, sims=sims, itm=itm)

    tcfg, vcfg = et.RobertaTextConfig(), ev.EgoVLPConfig()
    text, video = models(tcfg, vcfg, "cuda", torch.bfloat16)
    ids, mask, pixels = inputs(tcfg, vcfg, EGOVLP_TEXTS, EGOVLP_VIDEOS)
    out = forward(text, video, tcfg, vcfg, ids, mask, pixels.to(torch.bfloat16))
    if not all(torch.isfinite(v.float()).all() for v in out.values()):
        raise AssertionError("egovlp: non-finite outputs")
    bf = pixels.to(torch.bfloat16)
    times = {
        "text_embed": cuda_ms(lambda: et.compute_text(text, tcfg, ids, mask), iters=5),
        "video_embed": cuda_ms(lambda: et.compute_video_embed(
            text, ev.egovlp_encode(video, bf, vcfg)[:, 0]), iters=5),
        "itm_fusion": cuda_ms(lambda: et.fusion_forward(
            text, video, vcfg, tcfg, bf, ids[:EGOVLP_VIDEOS], mask[:EGOVLP_VIDEOS]), iters=5)}
    print(f"[egovlp] roberta-base text ({tcfg.num_hidden_layers} layers, "
          f"{tcfg.num_fuse_block} fused) and ViT-B/16 over {vcfg.num_frames} frames, bf16: "
          f"text embeds {tuple(out['text'].shape)}, video embeds {tuple(out['video'].shape)}, "
          f"sims {tuple(out['sims'].shape)}, ITM {tuple(out['itm'].shape)}; ms "
          + ", ".join(f"{k} {v:.2f}" for k, v in times.items())
          + f" ({EGOVLP_TEXTS} texts, {EGOVLP_VIDEOS} videos)")
    del text, video
    torch.cuda.empty_cache()

    cut_t = dataclasses.replace(tcfg, num_hidden_layers=4, num_fuse_block=2)
    cut_v = dataclasses.replace(vcfg, num_hidden_layers=4)
    text, video = models(cut_t, cut_v, "cuda", torch.bfloat16)
    host_text, host_video = (copy.deepcopy(m).float().cpu() for m in (text, video))
    ids, mask, pixels = inputs(cut_t, cut_v, 4, 2)
    card = forward(text, video, cut_t, cut_v, ids, mask, pixels.to(torch.bfloat16))
    host = forward(host_text, host_video, cut_t, cut_v, ids.cpu(), mask.cpu(), pixels.cpu())
    errs = {k: float((card[k].float().cpu() - host[k]).norm() / host[k].norm()) for k in card}
    ok = all(e <= EGOVLP_REL_L2 for e in errs.values())
    seconds = time.perf_counter() - t_phase
    print(f"[egovlp] depth cut (4 text layers, 2 fused; 4 tower layers) card bf16 vs host f32 "
          f"rel_l2 { {k: f'{v:.3e}' for k, v in errs.items()} } (tol {EGOVLP_REL_L2}) -> "
          f"{'ok' if ok else 'FAIL'}; {seconds:.1f} s")
    if not ok:
        raise AssertionError("egovlp: the card's text side disagrees with the host's")
    del text, video
    torch.cuda.empty_cache()
    return dict(ms=times, rel_l2=errs, seconds=seconds)


def tools_phase(seed: int) -> dict:
    """The video reader's backend on a cv2-written clip, and a weight-tool
    round trip: ``export_hf_checkpoint`` of a one-layer model at full width,
    read back through the port's loader."""
    import numpy as np

    from videollamb_torch.config import ModelConfig
    from videollamb_torch.data.video_reader import load_video, video_backend
    from videollamb_torch.models.builder import load_pretrained_model
    from videollamb_torch.tools.weights import export_hf_checkpoint

    import cv2

    root = os.path.join("build", "tools_smoke")
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, "clip.mp4")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10, (64, 48))
    rng = np.random.default_rng(seed)
    for _ in range(20):
        writer.write(rng.integers(0, 255, size=(48, 64, 3), dtype=np.uint8))
    writer.release()
    frames = load_video(path, num_frames=8)
    backend = video_backend()
    print(f"[decoder] load_video decoded {tuple(frames.shape)} through the {backend} backend "
          f"(native: the libav decoder of videollamb_torch/native where it builds, else cv2)")

    base = ModelConfig()
    cfg = dataclasses.replace(base, lm=dataclasses.replace(base.lm, num_hidden_layers=1))
    model = build_model(cfg, seed + 400, "cuda", torch.bfloat16)
    model.video_tower = None
    t0 = time.perf_counter()
    out_dir = os.path.join(root, "export")
    export_hf_checkpoint(model, out_dir)
    lm = cfg.lm
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump({"vocab_size": lm.vocab_size, "hidden_size": lm.hidden_size,
                   "intermediate_size": lm.intermediate_size,
                   "num_hidden_layers": lm.num_hidden_layers,
                   "num_attention_heads": lm.num_attention_heads,
                   "num_key_value_heads": lm.num_key_value_heads,
                   "mm_projector_type": "rmt_r_transformer1x"}, f)
    _, back, _, _, _ = load_pretrained_model(out_dir, dtype="bfloat16", load_tokenizer=False,
                                             device="cuda")
    want = model.state_dict()
    got = back.state_dict()
    equal = set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)
    seconds = time.perf_counter() - t0
    print(f"[weights] export_hf_checkpoint of a 1-layer model at full width ({len(want)} "
          f"tensors) read back through load_pretrained_model: "
          f"{'equal' if equal else 'DIFFERENT'}; {seconds:.1f} s")
    if not equal:
        raise AssertionError("weights: the exported checkpoint does not read back equal")
    del model, back
    torch.cuda.empty_cache()
    return dict(backend=backend, frames=list(frames.shape), export_equal=equal,
                export_seconds=seconds)


SOURCES = {  # name -> (source, TPU kernel it replaces)
    "spatial_attention": ("videollamb_torch/csrc/spatial_attention.cu",
                          "videollamb_tpu/ops/spatial_attention.py:122"),
    "temporal_attention": ("videollamb_torch/csrc/temporal_attention.cu",
                           "videollamb_tpu/ops/temporal_attention.py:207"),
    "flash_attention": ("videollamb_torch/csrc/flash_attention.cu",
                        "videollamb_tpu/ops/flash_attention.py:93"),
    "gathered_paged_attention": ("videollamb_torch/csrc/gathered_paged_attention.cu",
                                 "videollamb_tpu/ops/gathered_paged_attention.py:273"),
    "paged_fresh_write": ("videollamb_torch/csrc/paged_fresh_write.cu",
                          "videollamb_tpu/ops/paged_fresh_write.py:81"),
    "paged_attention_stats": ("videollamb_torch/csrc/paged_attention_stats.cu",
                              "videollamb_tpu/ops/paged_attention_stats.py:36"),
    "int4_matmul": ("videollamb_torch/csrc/int4_matmul.cu",
                    "videollamb_tpu/ops/int4_matmul.py:147"),
    "spatial_core": ("videollamb_torch/csrc/spatial_attention.cu",
                     "videollamb_tpu/ops/spatial_attention.py:160"),
    "temporal_core": ("videollamb_torch/csrc/temporal_attention.cu",
                      "videollamb_tpu/ops/temporal_attention.py:86"),
    "temporal_core_fm": ("videollamb_torch/csrc/temporal_attention.cu",
                         "videollamb_tpu/ops/temporal_attention.py:240"),
    "block_attention": ("videollamb_torch/csrc/block_attention.cu",
                        "videollamb_tpu/ops/flash_attention.py:213"),
}


def ptxas_summary(log: str) -> list:
    """(kernel, registers, spill store + load bytes) of each entry function in
    nvcc's -Xptxas -v output, names demangled where c++filt is found."""
    import re

    rows, name, spills = [], None, 0
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            name, spills = entry.group(1), 0
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill:
            spills = int(spill.group(1)) + int(spill.group(2))
        used = re.search(r"Used (\d+) registers", line)
        if used and name:
            rows.append((name, int(used.group(1)), spills))
            name = None
    try:
        names = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows),
                               capture_output=True, text=True, timeout=60).stdout.split("\n")
        rows = [(n or r[0], *r[1:]) for r, n in zip(rows, names)]
    except OSError:
        pass
    return list(dict.fromkeys(rows))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)

    from videollamb_torch.config import ModelConfig
    from videollamb_torch.kernels import build as kb

    card = card_line()
    print(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    lib_path = kb.build()
    kb.kernels()
    print(f"[build] {lib_path.name} ready in {time.perf_counter() - t0:.1f} s")
    for name, regs, spills in ptxas_summary(lib_path.with_suffix(".log").read_text()):
        print(f"[build] ptxas: {name}: {regs} registers, {spills} bytes spilled")

    g = torch.Generator(device="cuda").manual_seed(args.seed)
    cfg = ModelConfig()
    kernels = kernel_phase(g, stream_system_len(cfg))
    encoded = encoder_phase(g, args.seed)
    graded = gradient_phase(g, args.seed)
    t0 = time.perf_counter()
    model = build_model(cfg, args.seed, "cuda", torch.bfloat16)
    torch.cuda.synchronize()
    print(f"[model] VideoLLaMB-7B bf16 built in {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    sliced = slice_phase(model, cfg, g)
    served = serving_phase(model, cfg, g)
    t0 = time.perf_counter()
    featured = features_phase(model, cfg, g)
    print(f"[features] features phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    streamed = stream_phase(model, cfg, g)
    lived = liveinfer_phase(model, cfg, g)
    chatted = kv_chat_phase(model, cfg, g)
    print(f"[stream] stream, LiveInfer and KV-chat phases took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    surfaced = surfaces_phase(model, cfg, args.seed)
    print(f"[http] serving-surfaces phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    evaluated = eval_phase(model, cfg, g, args.seed)
    print(f"[eval] eval phase took {time.perf_counter() - t0:.1f} s")
    broad = breadth_phase(model, cfg, g, args.seed)
    imaged = images_phase(model, cfg, g, args.seed)
    towered = towers_phase(model, cfg, g, args.seed)
    shard_served = sharded_serving_phase(model, cfg, g)

    t0 = time.perf_counter()
    int8_lm = lm_variant(model, "int8").lm
    torch.cuda.synchronize()
    print(f"[quant] int8 copy of the 7B LM made on the card in {time.perf_counter() - t0:.1f} s")
    speculated = speculative_phase(model, cfg, int8_lm, g)
    # Training before the quantised phase, which quantises the bf16 LM and the
    # tower in place.
    trained = train_phase(model, cfg, int8_lm, g, args.seed)
    quantized = quantized_phase(model, cfg, int8_lm, g)
    del model, int8_lm
    torch.cuda.empty_cache()
    reference_phase(g, args.seed)
    paralleled = parallel_phase(args.seed)
    ego = egovlp_text_phase(args.seed)
    tooled = tools_phase(args.seed)

    launches = {**{k: sliced["launches"][k] for k in
                   ("spatial_attention", "temporal_attention", "flash_attention")},
                **{k: served["launches"][k] for k in
                   ("gathered_paged_attention", "paged_fresh_write", "paged_attention_stats")},
                "int4_matmul": quantized["launches"]["int4_matmul"]}
    enc = encoded["launches"]
    launches.update(spatial_core=enc["spatial core x23"]["spatial_core"],
                    temporal_core=enc["old_temporal (K9)"]["temporal_core"],
                    temporal_core_fm=enc["K10 for K2"]["temporal_core_fm"],
                    block_attention=enc["K11 for K1"]["block_attention"])
    for extra in (evaluated["k3_likelihood"], imaged["k3_anyres"]):
        kernels["flash_attention"]["shapes"].append(extra)
        kernels["flash_attention"]["max_abs_err"] = max(
            kernels["flash_attention"]["max_abs_err"], extra["max_abs_err"])
    rows = []
    for name, (source, replaces) in SOURCES.items():
        r = kernels[name]
        rows.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": launches[name], "max_abs_err": r["max_abs_err"],
                     "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
                     "bound_by": r["bound"][1], "library_ms": r["library_ms"]})
        if name in ("spatial_attention", "temporal_attention"):
            rows[-1]["encode_launches"] = enc["encode bf16"][name]
        if name in ("gathered_paged_attention", "paged_fresh_write", "paged_attention_stats"):
            rows[-1]["features_launches"] = sum(
                run["launches"][name] for res in featured.values() for run in res.values()
                if "launches" in run)
        if name in ("spatial_attention", "temporal_attention", "flash_attention"):
            rows[-1]["path_launches"] = {"stream": streamed["launches"][name],
                                         "liveinfer": lived["launches"][name],
                                         "kv_chat": chatted["launches"][name],
                                         "eval": evaluated["launches"][name]}
        rows[-1].setdefault("path_launches", {})["train"] = trained["launches"][name]
        if name in ("spatial_attention", "temporal_attention", "flash_attention",
                    "gathered_paged_attention", "paged_fresh_write"):
            rows[-1]["path_launches"]["http"] = surfaced["launches"]["http"][name]
        if name in ("spatial_attention", "temporal_attention"):
            rows[-1]["path_launches"]["embed"] = surfaced["launches"]["embed"][name]
        if name in ("spatial_attention", "temporal_attention", "flash_attention",
                    "gathered_paged_attention", "paged_fresh_write", "paged_attention_stats"):
            rows[-1]["path_launches"]["breadth"] = broad["launches"][name]
        if name in ("spatial_attention", "temporal_attention", "flash_attention",
                    "gathered_paged_attention", "paged_fresh_write"):
            rows[-1]["path_launches"]["images"] = imaged["launches"][name]
        if name in ("spatial_attention", "flash_attention"):
            rows[-1]["path_launches"]["towers"] = towered["launches"][name]
        if name in ("spatial_attention", "temporal_attention"):
            rows[-1]["path_launches"]["parallel"] = paralleled["launches"][name]
        if name in ("spatial_attention", "temporal_attention", "flash_attention",
                    "gathered_paged_attention", "paged_fresh_write", "paged_attention_stats"):
            rows[-1]["path_launches"]["sharded"] = shard_served["launches"][name]
        if name == "flash_attention":  # launches whose sliding window bit
            rows[-1]["path_launches"]["breadth_windowed"] = broad["k3_windowed_launches"]
        if "host_ms" in r:
            rows[-1].update(host_enqueue_ms=r["host_ms"], graph_replay_ms=r["device_ms"])
        if "shapes" in r:  # every further main-path shape, beside the first one's numbers
            rows[-1]["shapes"] = [
                {"shape": x["shape"], "max_abs_err": x["max_abs_err"], "ms": x["ms"],
                 "plain_ms": x["plain_ms"], "bound_ms": x["bound"][0],
                 "bound_by": x["bound"][1], "library_ms": x["library_ms"],
                 **({"host_enqueue_ms": x["host_ms"], "graph_replay_ms": x["device_ms"]}
                    if "host_ms" in x else {}),
                 **({"library_graph_replay_ms": x["library_device_ms"]}
                    if "library_device_ms" in x else {}),
                 **({k: x[k] for k in ("layout", "q_dtype", "lengths", "shared_pages",
                                       "rewound_slot", "rewind", "slots", "window")
                     if k in x}),
                 **({"causal": x["causal"]} if "causal" in x else {}),
                 **({"tp": x["tp"]} if "tp" in x else {})} for x in r["shapes"]]
    print(json.dumps({"requests": sliced["stats"] + served["stats"] + quantized["stats"],
                      "speculative": speculated, "weight_gib": quantized["weight_gib"],
                      "stream": {k: v for k, v in streamed.items() if k != "launches"},
                      "liveinfer": lived, "kv_chat": chatted,
                      "int8_tower": quantized["int8_tower"],
                      "encode": {k: v for k, v in encoded.items() if k != "launches"},
                      "gradients": graded, "features": featured,
                      "surfaces": {k: v for k, v in surfaced.items() if k != "launches"},
                      "eval": {k: v for k, v in evaluated.items()
                               if k not in ("launches", "k3_likelihood")},
                      "train": {k: v for k, v in trained.items() if k != "launches"},
                      "breadth": {k: v for k, v in broad.items()
                                  if k not in ("launches", "k3_windowed_launches")},
                      "images": {k: v for k, v in imaged.items()
                                 if k not in ("launches", "k3_anyres")},
                      "towers": {k: v for k, v in towered.items() if k != "launches"},
                      "parallel": {k: v for k, v in paralleled.items() if k != "launches"},
                      "sharded": {k: v for k, v in shard_served.items() if k != "launches"},
                      "egovlp_text": ego, "tools": tooled}))
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
