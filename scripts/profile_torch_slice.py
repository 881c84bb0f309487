"""Where the PyTorch port's main path spends its time on one NVIDIA GPU.

    python3 scripts/profile_torch_slice.py [--frames 16 64] [--new 32] [--seed 0]
        [--weights bf16,int8,int4] [--out results/profile_torch_slice.json]

Builds VideoLLaMB-7B at full width and depth (``ModelConfig()``, seeded
random bf16 weights, as ``chip_smoke.py`` does) and, for each choice of LM
weights (bf16; int8 by ``quantize_llama_params``; int4 by
``quantize_llama_params_int4``, kernel K7 in the decode step) and each frame
count, answers one B=1 request (40-id prompt with one VIDEO sentinel, greedy):

- stage times on the host clock, each ended by ``torch.cuda.synchronize()``:
  tower (``vision_encode``), bridge (``rmt_r_video_forward``), splice,
  prefill, and the mean decode step;
- one ``torch.profiler`` trace of a whole ``generate`` call: device time by
  kernel name, and the device's busy share of the call's wall time.

Writes everything to the ``--out`` JSON file (relative paths are taken from
the repo root) and prints a summary. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def profile_request(model, cfg, batch, new: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from videollamb_torch.models.bridge.rmt_r import rmt_r_video_forward
    from videollamb_torch.models.engine import generate
    from videollamb_torch.models.lm.llama import (
        embed_tokens, init_kv_cache, llama_decode_step, llama_prefill)
    from videollamb_torch.models.splice import splice_multimodal
    from videollamb_torch.models.vision.clip_vit import vision_encode

    kw = dict(max_new_tokens=new, do_sample=False, max_seq_len=cfg.max_length + 64)
    generate(model, cfg, batch, **kw)  # warm-up
    stages = {}
    feats, stages["tower_ms"] = _timed(
        lambda: vision_encode(model.video_tower, batch.videos, cfg.vision))
    bridge, stages["bridge_ms"] = _timed(
        lambda: rmt_r_video_forward(model.mm_projector, cfg.bridge, feats[0]))
    spliced, stages["splice_ms"] = _timed(lambda: splice_multimodal(
        batch.input_ids, batch.attention_mask, None, embed_tokens(model.lm, batch.input_ids),
        bridge.tokens[None], bridge.token_mask[None], cfg.max_length))
    cache = init_kv_cache(cfg.lm, 1, cfg.max_length + 64, dtype=torch.bfloat16, device="cuda")
    (logits, cache), stages["prefill_ms"] = _timed(lambda: llama_prefill(
        model.lm, cfg.lm, spliced.embeds, spliced.attention_mask, cache))
    tok = embed_tokens(model.lm, logits.argmax(-1)[:, None])
    steps = []
    for _ in range(new - 1):
        (logits, cache), ms = _timed(lambda: llama_decode_step(model.lm, cfg.lm, tok, cache))
        steps.append(ms)
    stages["decode_step_ms_mean"] = sum(steps) / len(steps)

    _, wall_ms = _timed(lambda: generate(model, cfg, batch, **kw))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, traced_ms = _timed(lambda: generate(model, cfg, batch, **kw))
    kernels = [(e.key, _device_us(e) / 1e3, e.count) for e in prof.key_averages()
               if _device_us(e) > 0 and e.device_type.name == "CUDA"]
    kernels.sort(key=lambda r: -r[1])
    busy_ms = sum(ms for _, ms, _ in kernels)
    return dict(stages=stages, generate_wall_ms=wall_ms, traced_wall_ms=traced_ms,
                device_busy_ms=busy_ms,
                device_idle_share=1.0 - busy_ms / traced_ms if traced_ms else None,
                top_kernels=[dict(name=n[:120], device_ms=ms, count=c)
                             for n, ms, c in kernels[:20]])


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--frames", type=int, nargs="+", default=[16, 64])
    parser.add_argument("--new", type=int, default=32)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--weights", default="bf16",
                        help="comma list of bf16, int8, int4: the LM weights of each pass")
    parser.add_argument("--out", default=os.path.join("results", "profile_torch_slice.json"))
    args = parser.parse_args()
    weights = [w for w in ("bf16", "int8", "int4") if w in args.weights.split(",")]
    if not weights:
        sys.exit("profile_torch_slice: --weights takes bf16,int8,int4")
    if not torch.cuda.is_available():
        sys.exit("profile_torch_slice: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)

    import chip_smoke
    from videollamb_torch.config import ModelConfig

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    cfg = ModelConfig()
    model = chip_smoke.build_model(cfg, args.seed, "cuda", torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    report = dict(card=card, torch=torch.__version__, requests=[])
    for choice, frames in ((w, f) for w in weights for f in args.frames):
        batch = chip_smoke.make_batch(cfg, g, [40], frames)
        r = profile_request(chip_smoke.lm_variant(model, choice), cfg, batch, args.new)
        r.update(frames=frames, new_tokens=args.new, weights=choice)
        report["requests"].append(r)
        print(f"[profile] {card} {choice} weights, frames={frames}: "
              f"{json.dumps(r['stages'])}; generate "
              f"{r['generate_wall_ms']:.1f} ms, device idle share "
              f"{r['device_idle_share']:.3f}")
        for k in r["top_kernels"][:8]:
            print(f"    {k['device_ms']:9.3f} ms  x{k['count']:<5d} {k['name']}")
    out = os.path.join(REPO, args.out)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
