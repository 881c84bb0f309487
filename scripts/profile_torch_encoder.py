"""Where the LanguageBind tower's encode time goes on one NVIDIA GPU.

    python3 scripts/profile_torch_encoder.py [--batch 32] [--frames 8]
        [--weights bf16,int8] [--seed 0] [--device cuda]
        [--out results/profile_torch_encoder.json]

The tower's encode-throughput path at full width (``VisionConfig()``:
ViT-L/14 at 224x224, 16 heads of 64, seeded random bf16 weights), 23 of 24
layers run (select layer -2), ``--batch`` videos of ``--frames`` frames. It
ports the JAX package's ``bench.py::bench_encode`` and the three encoder
ablations of ``benchmarks/`` into one script. Every variant is a local
function here; none is a switch of the package. Results, one JSON line each
(and all of them in ``--out``; relative paths are taken from the repo root):

- ``encode``: frames/s of ``vision_encode`` for each ``--weights`` choice
  (bf16; then int8 by ``quantize_vision_params``), and for int8 the
  relative error against bf16, mean|int8 - bf16| / mean|bf16| of the
  features (as ``bench.py`` computes it);
- ``cores``: the live tower (K1 + K2), K2 with the plain packed spatial
  core, both cores plain (``encoder_bench.py``; its "fused temporal only"
  variant patched a function the tower no longer called, so it timed the
  fused tower twice: here the plain core really runs); and the two kernels
  beside the path in the places they could take: K10 (three projections,
  three frame-major operands) for K2, K11 (split layout, scale on the
  scores) for K1;
- ``bisect``: ms per layer of a 23-layer stack on a random residual stream
  for each ``encoder_bisect.py`` mode: full, old_temporal (the (b, n, t, d)
  branch through K9 behind an explicit transpose pair), no_temporal,
  no_spatial_core, gemms_only, no_ln; and the ideal GEMM chain of the same
  shapes;
- ``floor``: the tower without temporal attention, the isolated split-layout
  core (K8) x 23, SDPA on the same (B*T, 16, 257, 64) operands x 23
  (``library``, a yardstick that no package module calls), the GEMM floor
  in TFLOP/s, and the full encode's utilisation of the H100's dense bf16
  peak of 989 TFLOP/s (``encoder_profile.py``);
- ``trace``: device time by kernel name of one bf16 encode
  (``torch.profiler``), and the device's busy share of its wall time.

On the card every time is CUDA events around five calls after two
warm-ups, on distinct inputs. ``--device cpu`` runs the same variants on
the host at a small width (a rehearsal of the control flow: its times are
the host's, labelled so, and never a device's).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from videollamb_torch.config import VisionConfig  # noqa: E402
from videollamb_torch.models.bridge.layers import _act  # noqa: E402
from videollamb_torch.models.vision import clip_vit as cv  # noqa: E402
from videollamb_torch.ops import spatial_attention as sa  # noqa: E402
from videollamb_torch.ops import temporal_attention as ta  # noqa: E402
from videollamb_torch.ops.flash_attention import block_attention  # noqa: E402

PEAK_BF16 = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
ITERS, WARMUP = 5, 2
# Host rehearsal: the same topology at a width the CPU runs in seconds.
CPU_CFG = VisionConfig(hidden_size=128, intermediate_size=512, num_hidden_layers=4,
                       num_attention_heads=2, image_size=56, patch_size=14)


class Timer:
    """ms per call: CUDA events on the card, the host clock on the CPU."""

    def __init__(self, device: torch.device, iters: int, warmup: int):
        self.cuda = device.type == "cuda"
        self.iters, self.warmup = iters, warmup

    def __call__(self, fn, inputs) -> float:
        """Mean ms of ``fn(x)`` over ``inputs`` cycled ``iters`` times, after warm-ups."""
        for i in range(self.warmup):
            fn(inputs[i % len(inputs)])
        if not self.cuda:
            t0 = time.perf_counter()
            for i in range(self.iters):
                fn(inputs[i % len(inputs)])
            return (time.perf_counter() - t0) * 1e3 / self.iters
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(self.iters):
            fn(inputs[i % len(inputs)])
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / self.iters


def encoder_flops(frames: int, layers: int, n: int, d: int) -> float:
    """Operations of an encode: per frame and layer, 24 n d^2 (spatial qkvo and
    the MLP) + 4 n^2 d (the spatial scores and product) + 8 n d^2 (temporal qkvo)."""
    return frames * layers * (32 * n * d * d + 4 * n * n * d)


# --- the layer variants (after benchmarks/encoder_bisect.py) ------------------------


def _plain_temporal_fm(layer, x, cfg, t):
    """K2's branch with the plain core: LN, fused qkv, plain core, out_proj."""
    bt, n, d = x.shape
    xt, normed = ta._ln_fm(x.reshape(bt // t, t, n, d), layer.temporal_embedding,
                           layer.temporal_layer_norm1, cfg.layer_norm_eps)
    qkv = ta._qkv_fused(layer.temporal_attn, normed, (d // cfg.num_attention_heads) ** -0.5)
    o = ta.temporal_core_fm3_reference(qkv, cfg.num_attention_heads)
    return (xt + layer.temporal_attn.out_proj(o)).reshape(bt, n, d)


def _plain_spatial(attn, x, heads):
    q = attn.q_proj(x) * (x.shape[-1] // heads) ** -0.5
    return attn.out_proj(sa.spatial_core_packed_reference(q, attn.k_proj(x), attn.v_proj(x),
                                                          heads))


def _block_spatial(attn, x, heads):
    """CLIP attention with K11 as the core: split layout, scale on the f32 scores."""
    bt, n, d = x.shape

    def split(y):
        return y.reshape(bt, n, heads, d // heads).transpose(1, 2).contiguous()

    o = block_attention(split(attn.q_proj(x)), split(attn.k_proj(x)), split(attn.v_proj(x)),
                        scale=(d // heads) ** -0.5)
    return attn.out_proj(o.transpose(1, 2).reshape(bt, n, d))


def _temporal_fm_three(layer, x, cfg, t):
    """The frame-major branch with three projections and K10 (the JAX tests' route)."""
    bt, n, d = x.shape
    heads = cfg.num_attention_heads
    xt, q, k, v = ta._ln_qkv_fm(x.reshape(bt // t, t, n, d), layer.temporal_embedding,
                                layer.temporal_layer_norm1, layer.temporal_attn,
                                cfg.layer_norm_eps)
    o = ta.fused_temporal_core_fm(q * (d // heads) ** -0.5, k, v, num_heads=heads)
    return (xt + layer.temporal_attn.out_proj(o)).reshape(bt, n, d)


def layer_variant(cfg: VisionConfig, mode: str, t: int):
    """One encoder layer for ``mode``: full | old_temporal | no_temporal |
    no_spatial_core | gemms_only | no_ln, or the cores variants
    plain_spatial (K2 only) | plain_both (no kernel) | fm_three (K10 for K2) |
    block_spatial (K11 for K1)."""
    eps, heads = cfg.layer_norm_eps, cfg.num_attention_heads

    def ln(mod, x):
        return x if mode == "no_ln" else ta._layer_norm(mod, x, eps)

    def qkvo_only(attn, h):  # the projections' cost without an attention core
        return attn.out_proj(attn.q_proj(h) + attn.k_proj(h) * 0 + attn.v_proj(h) * 0)

    def layer(p, x):
        bt, n, d = x.shape
        if mode == "old_temporal":
            # (b, n, t, d) branch (K9) behind an explicit transpose pair.
            x_bntd = x.reshape(bt // t, t, n, d).transpose(1, 2).contiguous()
            y = ta.temporal_attention(x_bntd, p.temporal_embedding, p.temporal_layer_norm1,
                                      p.temporal_attn, heads, eps)
            x = y.transpose(1, 2).reshape(bt, n, d)
        elif mode == "plain_both":
            x = _plain_temporal_fm(p, x, cfg, t)
        elif mode == "fm_three":
            x = _temporal_fm_three(p, x, cfg, t)
        elif mode == "gemms_only":
            x = x + qkvo_only(p.temporal_attn, ln(p.temporal_layer_norm1, x))
        elif mode != "no_temporal":  # the live frame-major branch (K2), its LN kept
            x = ta.temporal_attention_fm(x.reshape(bt // t, t, n, d), p.temporal_embedding,
                                         p.temporal_layer_norm1, p.temporal_attn, heads,
                                         eps).reshape(bt, n, d)
        h = ln(p.layer_norm1, x)
        if mode in ("no_spatial_core", "gemms_only"):
            x = x + qkvo_only(p.self_attn, h)
        elif mode in ("plain_spatial", "plain_both"):
            x = x + _plain_spatial(p.self_attn, h, heads)
        elif mode == "block_spatial":
            x = x + _block_spatial(p.self_attn, h, heads)
        else:
            x = x + cv._clip_attention(p.self_attn, h, heads)
        h = ln(p.layer_norm2, x)
        return x + p.mlp.fc2(_act(cfg.hidden_act, p.mlp.fc1(h)))

    return layer


def encode_with(tower, pixels, cfg: VisionConfig, layer, n_layers: int):
    """``vision_encode`` with another layer function (the cores variants)."""
    b, t, c, h, w = pixels.shape
    vm = tower.vision_model
    x = cv._embed(vm.embeddings, pixels.reshape(b * t, c, h, w), cfg)
    x = ta._layer_norm(vm.pre_layrnorm, x, cfg.layer_norm_eps)
    for p in vm.encoder.layers[:n_layers]:
        x = layer(p, x)
    return x


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def trace_encode(fn, x) -> dict:
    from torch.profiler import ProfilerActivity, profile

    fn(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [(e.key, _device_us(e) / 1e3, e.count) for e in prof.key_averages()
               if _device_us(e) > 0 and e.device_type.name == "CUDA"]
    kernels.sort(key=lambda r: -r[1])
    busy = sum(ms for _, ms, _ in kernels)
    return dict(traced_wall_ms=wall_ms, device_busy_ms=busy,
                device_idle_share=1.0 - busy / wall_ms if wall_ms else None,
                top_kernels=[dict(name=k[:120], device_ms=ms, count=c)
                             for k, ms, c in kernels[:15]])


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--frames", type=int, default=8)
    parser.add_argument("--weights", default="bf16,int8", help="comma list of bf16, int8")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out", default=os.path.join("results", "profile_torch_encoder.json"))
    args = parser.parse_args()
    weights = [w for w in ("bf16", "int8") if w in args.weights.split(",")]
    if not weights or weights[0] != "bf16":
        sys.exit("profile_torch_encoder: --weights takes bf16[,int8] (int8 is held against bf16)")
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        sys.exit("profile_torch_encoder: no CUDA device (pass --device cpu for a host rehearsal)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)
    on_card = dev.type == "cuda"

    from videollamb_torch.models.vision.quant import quantize_vision_params

    cfg = VisionConfig() if on_card else CPU_CFG
    dtype = torch.bfloat16 if on_card else torch.float32
    layers = cfg.num_hidden_layers - 1  # select layer -2: the last layer is never run
    b, t = args.batch, args.frames
    frames, n, d, heads = b * t, cfg.seq_len, cfg.hidden_size, cfg.num_attention_heads
    report = dict(device=(torch.cuda.get_device_name(0) if on_card else "cpu (host rehearsal)"),
                  torch=torch.__version__, batch=b, frames_per_video=t, layers=layers,
                  hidden=d, heads=heads, tokens=n, dtype=str(dtype), results=[])
    if on_card:
        report["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip()
        print(f"[encoder] {report['card']}; torch {torch.__version__}")

    def emit(kind: str, **fields):
        row = dict(kind=kind, **fields)
        report["results"].append(row)
        print(json.dumps(row), flush=True)

    timer = Timer(dev, iters=ITERS, warmup=WARMUP)
    tower = cv.init_vision_params(cfg, seed=args.seed, dtype=dtype, device=dev)
    g = torch.Generator(device=dev).manual_seed(args.seed)
    img = cfg.image_size
    pixels = [torch.randn((b, t, 3, img, img), generator=g, device=dev).to(dtype)
              for _ in range(3)]
    encode_ms = {}

    # Encode throughput, bf16 (int8 comes last: quantising consumes the tower).
    ref = cv.vision_encode(tower, pixels[0], cfg)
    encode_ms["bf16"] = timer(lambda x: cv.vision_encode(tower, x, cfg), pixels)
    emit("encode", weights="bf16" if on_card else "f32", ms=encode_ms["bf16"],
         frames_per_s=frames / encode_ms["bf16"] * 1e3)

    # Cores: kernel against plain.
    for name, mode in (("live tower (K1 + K2)", "full"),
                       ("K2, plain packed spatial core", "plain_spatial"),
                       ("both cores plain", "plain_both"),
                       ("K10 three-operand temporal core for K2", "fm_three"),
                       ("K11 block attention for the spatial core K1", "block_spatial")):
        layer = layer_variant(cfg, mode, t)
        ms = timer(lambda x: encode_with(tower, x, cfg, layer, layers), pixels)
        emit("cores", variant=name, ms=ms, frames_per_s=frames / ms * 1e3)

    # Bisect: ms per layer of the stack on a random residual stream.
    x0 = [torch.randn((frames, n, d), generator=g, device=dev).to(dtype) for _ in range(2)]
    stack = tower.vision_model.encoder.layers[:layers]
    for mode in ("full", "old_temporal", "no_temporal", "no_spatial_core", "gemms_only",
                 "no_ln"):
        layer = layer_variant(cfg, mode, t)

        def run(x, layer=layer):
            for p in stack:
                x = layer(p, x)
            return x

        emit("bisect", mode=mode, ms_per_layer=timer(run, x0) / layers)
    w = [torch.randn(shape, generator=g, device=dev).to(dtype) * shape[0] ** -0.5
         for shape in ((d, d), (d, cfg.intermediate_size), (cfg.intermediate_size, d))]

    def gemm_chain(x):
        h = x.reshape(frames * n, d)
        for _ in range(layers):
            for _ in range(8):  # qkv + o of the temporal and the spatial branch
                h = h @ w[0]
            h = (h @ w[1]) @ w[2]
        return h

    gemm_ms = timer(gemm_chain, x0)
    gemm_flops = layers * 2 * frames * n * d * (8 * d + 2 * cfg.intermediate_size)
    emit("bisect", mode="ideal_gemm", ms_per_layer=gemm_ms / layers)

    # Floor: no temporal attention, the isolated split-layout core, the GEMMs.
    cfg_img = dataclasses.replace(cfg, add_time_attn=False)
    ms = timer(lambda x: cv.vision_encode(tower, x, cfg_img), pixels)
    emit("floor", variant="tower without temporal attention", ms=ms,
         frames_per_s=frames / ms * 1e3, temporal_cost_ms=encode_ms["bf16"] - ms)
    e = d // heads
    qkv4 = [[torch.randn((frames, heads, n, e), generator=g, device=dev).to(dtype)
             for _ in range(3)] for _ in range(2)]
    for a in qkv4:
        a[0] *= e ** -0.5  # pre-scaled q, as the core takes it
    ms = timer(lambda a: sa.fused_spatial_core(*a), qkv4)
    emit("floor", variant="split-layout spatial core (K8) x layers", ms=ms * layers,
         ms_one=ms, launches_per_encode=layers)
    ms = timer(lambda a: F.scaled_dot_product_attention(*a, scale=1.0), qkv4)
    emit("floor", variant="library: SDPA on the same operands x layers", ms=ms * layers,
         ms_one=ms)
    flops = encoder_flops(frames, layers, n, d)
    emit("floor", variant="GEMM floor x layers", ms=gemm_ms,
         tflop_per_s=gemm_flops / gemm_ms / 1e9, gflop=gemm_flops / 1e9)
    emit("floor", variant="full encode", ms=encode_ms["bf16"], tflop=flops / 1e12,
         tflop_per_s=flops / encode_ms["bf16"] / 1e9,
         utilisation_of_989_tflop_s=(flops / encode_ms["bf16"] * 1e3 / PEAK_BF16
                                     if on_card else None))
    if on_card:
        trace = trace_encode(lambda x: cv.vision_encode(tower, x, cfg), pixels[1])
        emit("trace", weights="bf16", **trace)
        for k in trace["top_kernels"][:10]:
            print(f"    {k['device_ms']:9.3f} ms  x{k['count']:<5d} {k['name']}")

    if "int8" in weights:
        tower8 = quantize_vision_params(tower)  # in place: the bf16 tower is done with
        got = cv.vision_encode(tower8, pixels[0], cfg)
        rel = float((got.float() - ref.float()).abs().mean() / ref.float().abs().mean())
        encode_ms["int8"] = timer(lambda x: cv.vision_encode(tower8, x, cfg), pixels)
        emit("encode", weights="int8", ms=encode_ms["int8"],
             frames_per_s=frames / encode_ms["int8"] * 1e3, rel_err_vs_bf16=rel)
        if on_card:
            trace = trace_encode(lambda x: cv.vision_encode(tower8, x, cfg), pixels[1])
            emit("trace", weights="int8", **trace)

    out = os.path.join(REPO, args.out)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
