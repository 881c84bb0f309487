"""Where the PyTorch port's paged serving engine spends its time on one NVIDIA GPU.

    python3 scripts/profile_torch_paged.py [--slots 8] [--frames 16] [--seed 0]
        [--weights bf16,int8,int4] [--pages int8,bf16]
        [--out results/profile_torch_paged.json]

Builds VideoLLaMB-7B at full width and depth (``ModelConfig()``, seeded
random bf16 weights, as ``chip_smoke.py`` does) and, for each choice of LM
weights in ``--weights`` (bf16; int8 by ``quantize_llama_params``; int4 by
``quantize_llama_params_int4``, kernel K7 in the decode step) and each page
type in ``--pages``, fills a ``PagedServingEngine`` of ``--slots`` slots with
video requests (``--frames`` frames, prompts of 24-90 ids, one VIDEO sentinel):

- admission on the host clock, each stage ended by
  ``torch.cuda.synchronize()``: the splice (tower, SceneTilling, bridge),
  the chunked prefill and the page insert of one request, then the whole
  ``_admit`` of all slots;
- the decode step with every slot active: wall time per step of an 8-step
  ``decode_steps`` (greedy), and one ``torch.profiler`` trace of another
  8 steps: device time by kernel name and the device's idle share.

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

PROMPT_LENS = [24, 90, 40, 61, 33, 77, 52, 45]
STEPS = 8


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


def profile_engine(model, cfg, g, *, quantize_kv: bool, slots: int, frames: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from videollamb_torch.models.assembly import prepare_multimodal_embeds
    from videollamb_torch.models.lm.llama import chunked_prefill, init_kv_cache
    from videollamb_torch.models.lm.paged import paged_insert
    from videollamb_torch.serve.paged import PagedServingEngine
    from videollamb_torch.serve.server import Request, decode_steps

    engine = PagedServingEngine(model, cfg, num_slots=slots, quantize_kv=quantize_kv,
                                eos_token_id=-1)

    def request(uid, n):
        return Request(uid=uid, batch=chip_smoke.make_batch(cfg, g, [n], frames),
                       max_new_tokens=4 * STEPS)

    engine.submit(request(-1, 30))  # warm-up: every op of admission and decode
    engine.run_until_drained(k=2)

    # One admission, stage by stage, into pages taken from the pool.
    req = request(-2, 40)
    spliced, splice_ms = _timed(lambda: prepare_multimodal_embeds(model, cfg, req.batch))
    prompt_len = int(spliced.attention_mask.sum())
    single = init_kv_cache(cfg.lm, 1, cfg.max_length, dtype=engine._dtype, device="cuda")
    (_, single), prefill_ms = _timed(lambda: chunked_prefill(
        model.lm, cfg.lm, spliced.embeds, spliced.attention_mask, single, lengths=[prompt_len]))
    pages = engine.allocator.alloc(engine.allocator.pages_needed(prompt_len, engine.page_size))
    row = pages + [0] * (engine.pages_per_seq - len(pages))
    _, insert_ms = _timed(lambda: paged_insert(engine.cache, single, 0, row))
    engine.allocator.free(pages)
    engine.cache.page_table[0] = 0
    engine.cache.lengths[0] = 0
    del single

    for i, n in enumerate(PROMPT_LENS[:slots]):
        engine.submit(request(i, n))
    _, admit_ms = _timed(engine._admit)
    prompt_tokens = [int(x) for x in engine._host_len]
    engine._ensure_pages(3 * STEPS)
    engine._sync_table()
    out, steps_ms = _timed(lambda: decode_steps(engine._forward, engine.logits, STEPS))
    engine.logits = out.logits
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out, traced_ms = _timed(lambda: decode_steps(engine._forward, engine.logits, STEPS))
        engine.logits = out.logits
    kernels = [(e.key, _device_us(e) / 1e3, e.count) for e in prof.key_averages()
               if _device_us(e) > 0 and e.device_type.name == "CUDA"]
    kernels.sort(key=lambda r: -r[1])
    busy_ms = sum(ms for _, ms, _ in kernels)
    return dict(
        pages="int8" if quantize_kv else "bf16", slots=slots, frames=frames,
        prompt_tokens=prompt_tokens,
        admission=dict(splice_ms=splice_ms, chunked_prefill_ms=prefill_ms,
                       page_insert_ms=insert_ms, prompt_len=prompt_len,
                       admit_all_slots_ms=admit_ms),
        decode=dict(step_ms=steps_ms / STEPS, traced_step_ms=traced_ms / STEPS,
                    device_busy_step_ms=busy_ms / STEPS,
                    device_idle_share=1.0 - busy_ms / traced_ms,
                    top_kernels=[dict(name=n[:120], device_ms_per_step=ms / STEPS,
                                      launches_per_step=c / STEPS)
                                 for n, ms, c in kernels[:20]]))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--slots", type=int, default=8)
    parser.add_argument("--frames", type=int, default=16)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--weights", default="bf16",
                        help="comma list of bf16, int8, int4: the LM weights of each pass")
    parser.add_argument("--pages", default="int8,bf16", help="comma list of int8, bf16")
    parser.add_argument("--out", default=os.path.join("results", "profile_torch_paged.json"))
    args = parser.parse_args()
    weights = [w for w in ("bf16", "int8", "int4") if w in args.weights.split(",")]
    pages = [p for p in ("int8", "bf16") if p in args.pages.split(",")]
    if not weights or not pages:
        sys.exit("profile_torch_paged: --weights takes bf16,int8,int4 and --pages int8,bf16")
    if not torch.cuda.is_available():
        sys.exit("profile_torch_paged: needs a CUDA device")
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
    report = dict(card=card, torch=torch.__version__, engines=[])
    for choice, page_type in ((w, p) for w in weights for p in pages):
        r = profile_engine(chip_smoke.lm_variant(model, choice), cfg, g,
                           quantize_kv=page_type == "int8", slots=args.slots,
                           frames=args.frames)
        r["weights"] = choice
        report["engines"].append(r)
        torch.cuda.empty_cache()
        print(f"[profile] {card} {choice} weights, {r['pages']} pages, {r['slots']} slots: "
              f"admission "
              f"{json.dumps(r['admission'])}; decode step {r['decode']['step_ms']:.1f} ms "
              f"(device busy {r['decode']['device_busy_step_ms']:.1f} ms, idle share "
              f"{r['decode']['device_idle_share']:.3f})")
        for k in r["decode"]["top_kernels"][:10]:
            print(f"    {k['device_ms_per_step']:8.3f} ms/step  x{k['launches_per_step']:<6.0f} "
                  f"{k['name']}")
    out = os.path.join(REPO, args.out)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
