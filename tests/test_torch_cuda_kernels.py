"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every case is marked ``cuda`` and skips without an NVIDIA GPU (the kernels
have no CPU mode; their plain versions are held against the JAX package in
test_torch_{spatial,temporal,flash}_attention.py). This file imports no jax,
so it also runs where jax is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Shapes are the main path's: 257 tokens x 16 heads of 64 in the tower, (B,
32, 2048, 128) in the LM prefill (and the transposed (B, S, H, Dh) views it
takes there; with Mistral's sliding window at (1, 32, 4096, 128)), the paged decode step's pools at 7B (plus small GQA cases up
to 8 query heads a kv head, K6's split boundaries, and K4's and K6's merge
counters over repeated calls, lengths past the table's width and CUDA-graph
replay; page tables whose rows share a prefix's full pages, and K5 writing
over rows past a rewound length before K4 reads it). Tolerances: K1-K3 have
bf16 outputs (relative step 2^-8) and f32 sums taken in other orders, atol
1e-2 + rtol 2e-2. K4 and K6 return f32 statistics (m, l) within 1e-5 and
outputs within 2e-3 (K4: one int8 step of the probability requantisation)
or 1e-4 (K6) of max|out|. K5 is a copy: exact outside the trash page. K7
sums each group in f32 in another order than its plain version and rounds
once: 2e-5 in f32, one bf16 step (2^-7 relative) plus 1e-3 absolute in
bf16; its cases reach both of its kernels (f32 FMAs: f32, M = 1, groups of
16; tensor cores: bf16 from M = 2 on) with ragged N and M on each. K8-K11
round to bf16 like K1-K3 and take their tolerance. The differentiable tower
ops launch K1 / K2 / K8 / K9 in their forward and none in their backward;
every kernel wrapper refuses a CUDA input that wants a gradient.
"""

from __future__ import annotations

import pytest
import torch

from videollamb_torch.ops.flash_attention import (
    block_attention,
    block_attention_reference,
    flash_attention,
    flash_attention_reference,
)
from videollamb_torch.ops.int4_matmul import (
    dequantize_int4,
    int4_matmul,
    int4_matmul_reference,
    quantize_int4,
)
from videollamb_torch.ops.gathered_paged_attention import (
    gathered_paged_attention_int8,
    gathered_paged_attention_int8_reference,
)
from videollamb_torch.ops.paged_attention_stats import (
    attend_paged_with_stats_xla,
    paged_attention_with_stats,
)
from videollamb_torch.ops import split_merge
from videollamb_torch.ops.paged_fresh_write import paged_fresh_write, paged_fresh_write_xla
from videollamb_torch.ops.spatial_attention import (
    fused_spatial_core,
    fused_spatial_core_packed,
    spatial_core,
    spatial_core_packed,
    spatial_core_packed_reference,
    spatial_core_reference,
)
from videollamb_torch.ops.temporal_attention import (
    fused_temporal_core,
    fused_temporal_core_fm,
    fused_temporal_core_fm3,
    temporal_core,
    temporal_core_fm3,
    temporal_core_fm3_reference,
    temporal_core_fm_reference,
    temporal_core_reference,
)

TOL = dict(rtol=2e-2, atol=1e-2)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _randn(dev, *shape, scale=1.0, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=dev) * scale).to(torch.bfloat16)


# Token counts: the tower's 257 and a ragged 5 (one block stages the whole
# head), the largest such head (272), and past it (the streamed route); an
# anyres patch stack (a 2 x 2 grid plus the base image, 5 frames of 257) and
# the RMT tower's step (128 memories + 257 = 385, streamed).
SPATIAL_SHAPES = [(16, 257), (3, 5), (2, 272), (2, 300), (5, 257), (2, 385)]


@pytest.mark.cuda
@pytest.mark.parametrize("frames,n", SPATIAL_SHAPES)
def test_spatial_kernel_matches_plain(dev, frames, n):
    q = _randn(dev, frames, n, 1024, scale=0.125, seed=1)
    k, v = _randn(dev, frames, n, 1024, seed=2), _randn(dev, frames, n, 1024, seed=3)
    before = fused_spatial_core_packed.launches
    got = fused_spatial_core_packed(q, k, v, heads=16)
    torch.cuda.synchronize()
    assert fused_spatial_core_packed.launches == before + 1
    torch.testing.assert_close(got.float(), spatial_core_packed_reference(q, k, v, 16).float(),
                               **TOL)
    with pytest.raises(ValueError):
        fused_spatial_core_packed(q.float(), k.float(), v.float(), heads=16)


@pytest.mark.cuda
@pytest.mark.parametrize("tp", [2, 4])
def test_kernels_at_tensor_parallel_widths_match_plain(dev, tp):
    """A tensor-parallel rank's tower holds 16 / tp heads: K1 at
    (16, 257, 1024 / tp), K2 at (2, 8, 257, 3 * 1024 / tp)."""
    d, h = 1024 // tp, 16 // tp
    q = _randn(dev, 16, 257, d, scale=0.125, seed=60)
    k, v = _randn(dev, 16, 257, d, seed=61), _randn(dev, 16, 257, d, seed=62)
    torch.testing.assert_close(fused_spatial_core_packed(q, k, v, heads=h).float(),
                               spatial_core_packed_reference(q, k, v, h).float(), **TOL)
    qkv = torch.cat([_randn(dev, 2, 8, 257, d, scale=0.125, seed=63),
                     _randn(dev, 2, 8, 257, 2 * d, seed=64)], dim=-1)
    torch.testing.assert_close(fused_temporal_core_fm3(qkv, num_heads=h).float(),
                               temporal_core_fm3_reference(qkv, h).float(), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,n", [(2, 8, 257), (1, 4, 3)])
def test_temporal_kernel_matches_plain(dev, b, t, n):
    qkv = torch.cat([_randn(dev, b, t, n, 1024, scale=0.125, seed=4),
                     _randn(dev, b, t, n, 2048, seed=5)], dim=-1)
    before = fused_temporal_core_fm3.launches
    got = fused_temporal_core_fm3(qkv, num_heads=16)
    torch.cuda.synchronize()
    assert fused_temporal_core_fm3.launches == before + 1
    torch.testing.assert_close(got.float(), temporal_core_fm3_reference(qkv, 16).float(), **TOL)
    with pytest.raises(ValueError):
        fused_temporal_core_fm3(qkv[..., :300], num_heads=16)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,s,dh,lengths,causal", [
    (1, 32, 2048, 128, [1400], True),
    (2, 32, 2048, 128, [1400, 1873], True),
    (2, 4, 37, 64, [37, 20], False),
])
def test_flash_kernel_matches_plain(dev, b, h, s, dh, lengths, causal):
    q, k, v = (_randn(dev, b, h, s, dh, seed=6 + i) for i in range(3))
    mask = torch.arange(s, device=dev)[None] < torch.tensor(lengths, device=dev)[:, None]
    before = flash_attention.launches
    got = flash_attention(q, k, v, mask, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention_reference(q, k, v, mask, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), **TOL)


@pytest.mark.cuda
def test_flash_kernel_gives_mean_of_v_on_rows_without_a_valid_key(dev):
    q, k, v = (_randn(dev, 1, 2, 70, 64, seed=9 + i) for i in range(3))
    mask = torch.arange(70, device=dev)[None] >= 6  # keys 0..5 padded (left padding)
    got = flash_attention(q, k, v, mask, causal=True)
    mean_v = v.float().mean(dim=2, keepdim=True).expand(-1, -1, 6, -1)
    torch.testing.assert_close(got[:, :, :6].float(), mean_v, **TOL)
    torch.testing.assert_close(got.float(),
                               flash_attention_reference(q, k, v, mask, causal=True).float(),
                               **TOL)


def _key_mask(dev, b, s, kind, seed=0):
    """(B, Skv) bool key masks: right or left padding, a wholly masked batch
    row, or random keys (tiles that the mask crosses element by element)."""
    pos = torch.arange(s, device=dev)[None]
    if kind == "right":
        return pos < torch.tensor([s, (2 * s) // 3][:b], device=dev)[:, None]
    if kind == "left":
        return pos >= torch.tensor([70, 5][:b], device=dev)[:, None]
    if kind == "row":
        return (pos < s) & (torch.arange(b, device=dev)[:, None] != 1)
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.rand((b, s), generator=g, device=dev) < 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,s,dh,kind,causal", [
    (2, 4, 300, 128, "left", True),     # rows before a row's first key take the mean of v
    (2, 4, 300, 64, "left", False),
    (2, 4, 300, 64, "row", True),       # a batch row with no valid key, through the epilogue
    (2, 3, 300, 128, "row", False),
    (1, 3, 100, 128, "right", True),    # Sq off 64
    (2, 2, 77, 64, "right", False),     # Sq off 64 at Dh 64
    (2, 2, 333, 64, "random", True),    # tiles the mask crosses element by element
    (1, 2, 1, 128, "right", True),      # one query row
])
def test_flash_kernel_on_projection_views_matches_plain(dev, b, h, s, dh, kind, causal):
    """K3 on the transposed (B, S, H, Dh) views the LM hands it: no copy in,
    the output in the projections' layout, rows without a valid key set in
    the kernel's epilogue to the mean of v."""
    q, k, v = (_randn(dev, b, s, h, dh, seed=40 + i).transpose(1, 2) for i in range(3))
    mask = _key_mask(dev, b, s, kind, seed=s)
    before = flash_attention.launches
    got = flash_attention(q, k, v, mask, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.stride() == q.stride() and got.transpose(1, 2).is_contiguous()
    want = flash_attention_reference(q, k, v, mask, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,s,dh,window,kind", [
    (1, 32, 4096, 128, 1024, None),     # Mistral's band at the breadth phase's shape
    (1, 32, 2048, 128, 4096, None),     # a window that does not bite: today's kernel
    (2, 4, 300, 128, 64, "right"),      # band edges on tile edges, padded rows
    (2, 4, 333, 64, 37, "random"),      # band edges inside tiles, partial masks
    (2, 2, 300, 64, 100, "left"),       # rows without a valid key: the mean of v
    (1, 2, 200, 128, 1, "right"),       # each row sees itself only
])
def test_flash_kernel_window_matches_plain(dev, b, h, s, dh, window, kind):
    """K3 with a sliding window (causal): the key loop starts at the band's
    first tile and the band's edge is masked inside its tiles."""
    q, k, v = (_randn(dev, b, s, h, dh, seed=60 + i).transpose(1, 2) for i in range(3))
    mask = None if kind is None else _key_mask(dev, b, s, kind, seed=s)
    before = flash_attention.launches
    got = flash_attention(q, k, v, mask, causal=True, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention_reference(q, k, v, mask, causal=True, window=window)
    torch.testing.assert_close(got.float(), want.float(), **TOL)
    if window < s:  # the band bites: the unwindowed kernel gives other rows
        full = flash_attention(q, k, v, mask, causal=True)
        assert (full.float() - got.float()).abs().max() > 1e-2


@pytest.mark.cuda
def test_flash_kernel_on_projection_views_is_one_launch(dev):
    """The prefill's call (transposed bf16 views, a bool key mask) launches
    the kernel and nothing else: no copy, no post-pass."""
    q, k, v = (_randn(dev, 2, 300, 4, 128, seed=50 + i).transpose(1, 2) for i in range(3))
    mask = _key_mask(dev, 2, 300, "right")
    flash_attention(q, k, v, mask, causal=True)  # the build, outside the trace
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        got = flash_attention(q, k, v, mask, causal=True)
        torch.cuda.synchronize()
    on_card = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(on_card) == 1 and "flash" in on_card[0], on_card
    torch.testing.assert_close(
        got.float(), flash_attention_reference(q, k, v, mask, causal=True).float(), **TOL)


def _paged_case(dev, b, lengths, page, pps, p_total, seed):
    """A page table of disjoint random pages (from page 1 on) per slot."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    perm = torch.randperm(p_total - 1, generator=g) + 1
    table = torch.zeros((b, pps), dtype=torch.int32)
    nxt = 0
    for i, n in enumerate(lengths):
        used = min(-(-n // page), pps)
        table[i, :used] = perm[nxt:nxt + used]
        nxt += used
    return table.to(dev), torch.tensor(lengths, dtype=torch.int32, device=dev)


def _assert_stats_close(got, want, out_tol):
    out, m, l = (x.float() for x in got)
    w_out, w_m, w_l = (x.float() for x in want)
    torch.testing.assert_close(m, w_m, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(l, w_l, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(out, w_out, rtol=0, atol=out_tol * float(w_out.abs().max()))


def _gathered_case(dev, h, h_kv, page, pps, lengths, seed):
    b, p_total = len(lengths), 1 + len(lengths) * pps
    g = torch.Generator(device=dev).manual_seed(seed)
    kd = h_kv * 128
    k = torch.randint(-128, 128, (p_total, page, kd), generator=g, device=dev, dtype=torch.int8)
    v = torch.randint(-128, 128, (p_total, page, kd), generator=g, device=dev, dtype=torch.int8)
    ks = torch.rand((p_total, page, h_kv), generator=g, device=dev) + 0.05
    vs = torch.rand((p_total, page, h_kv), generator=g, device=dev) + 0.05
    q = torch.randn((b, h, 128), generator=g, device=dev) * 128 ** -0.5
    table, lens = _paged_case(dev, b, lengths, page, pps, p_total, seed=seed + 1)
    return q, k, v, table, lens, ks, vs


@pytest.mark.cuda
@pytest.mark.parametrize("h,h_kv,page,pps,ppb,lengths", [
    (32, 32, 64, 40, 8, [0, 300, 517, 1024, 1500, 2047, 2560, 1777]),  # 7B serving shape
    (8, 2, 16, 8, 2, [5, 0, 128, 77]),                                  # GQA, small pages
    (8, 1, 16, 8, 2, [5, 0, 128, 77, 33]),                              # G = 8
])
def test_gathered_int8_kernel_matches_plain(dev, h, h_kv, page, pps, ppb, lengths):
    q, k, v, table, lens, ks, vs = _gathered_case(dev, h, h_kv, page, pps, lengths, seed=11)
    before = gathered_paged_attention_int8.launches
    got = gathered_paged_attention_int8(q, k, v, table, lens, ks, vs, pages_per_block=ppb)
    torch.cuda.synchronize()
    assert gathered_paged_attention_int8.launches == before + 1
    want = gathered_paged_attention_int8_reference(q, k, v, table, lens, ks, vs,
                                                   pages_per_block=ppb)
    _assert_stats_close(got, want, 2e-3)
    zero = lens == 0
    assert not got[0][zero].any() and torch.isneginf(got[1][zero]).all()
    assert not got[2][zero].any()


@pytest.mark.cuda
def test_gathered_int8_kernel_is_one_launch(dev):
    """The paged step's call: the blocks of every slot and their merge are
    one kernel, nothing else runs on the card."""
    q, k, v, table, lens, ks, vs = _gathered_case(dev, 32, 32, 64, 40, [2560, 0, 1500, 300],
                                                  seed=81)
    call = lambda: gathered_paged_attention_int8(q, k, v, table, lens, ks, vs,
                                                 pages_per_block=8)
    call()  # build and scratch, outside the trace
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        got = call()
        torch.cuda.synchronize()
    on_card = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(on_card) == 1 and "gathered_paged_attention" in on_card[0], on_card
    _assert_stats_close(got, gathered_paged_attention_int8_reference(
        q, k, v, table, lens, ks, vs, pages_per_block=8), 2e-3)


@pytest.mark.cuda
def test_gathered_int8_kernel_resets_its_merge_counters(dev):
    """The block that merges a (slot, kv head) sets its counter back to 0:
    repeated calls give the same bits, and calls with other lengths after
    them are right. Lengths past the table's width (pps x page) count as the
    width, as in the plain version, and leave the counters at 0 too."""
    def counters_are_zero():
        torch.cuda.synchronize()
        key = (q.device, torch.cuda.current_stream(q.device).cuda_stream)
        return not split_merge._COUNTERS[key].any()

    q, k, v, table, lens, ks, vs = _gathered_case(
        dev, 32, 32, 64, 40, [2560, 0, 1500, 700, 2047, 1, 512, 999], seed=71)

    def both(lengths):
        return (gathered_paged_attention_int8(q, k, v, table, lengths, ks, vs,
                                              pages_per_block=8),
                gathered_paged_attention_int8_reference(q, k, v, table, lengths, ks, vs,
                                                        pages_per_block=8))

    first, want = both(lens)
    _assert_stats_close(first, want, 2e-3)
    for _ in range(3):
        again = gathered_paged_attention_int8(q, k, v, table, lens, ks, vs, pages_per_block=8)
        for a, b in zip(first, again):
            assert torch.equal(a, b)
    assert counters_are_zero()
    over = lens.clone()
    over[0], over[3] = 2560 + 300, 9000  # the table holds 40 x 64 = 2560 tokens
    for lens2 in (over, (lens * 3 // 4).int(), lens):
        got, want = both(lens2)
        _assert_stats_close(got, want, 2e-3)
        assert counters_are_zero()


@pytest.mark.cuda
def test_gathered_int8_kernel_in_a_cuda_graph(dev):
    """A call captured into a CUDA graph (merge counters of its own, zeroed
    by the graph) replays right, also after the lengths change in place, and
    leaves the eager calls' counters alone."""
    q, k, v, table, lens, ks, vs = _gathered_case(
        dev, 32, 32, 64, 40, [2560, 0, 1500, 700, 2047, 1, 512, 999], seed=72)
    call = lambda: gathered_paged_attention_int8(q, k, v, table, lens, ks, vs,
                                                 pages_per_block=8)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = call()
    for lengths in ([2560, 0, 1500, 700, 2047, 1, 512, 999], [100, 2560, 0, 513, 1, 2000, 9000, 64]):
        lens.copy_(torch.tensor(lengths, dtype=torch.int32, device=dev))
        for _ in range(2):
            graph.replay()
            torch.cuda.synchronize()
            want = gathered_paged_attention_int8_reference(q, k, v, table, lens, ks, vs,
                                                           pages_per_block=8)
            _assert_stats_close(captured, want, 2e-3)
        _assert_stats_close(call(), want, 2e-3)  # an eager call between replays


@pytest.mark.cuda
@pytest.mark.parametrize("h,h_kv,page,pps,lengths", [
    (32, 32, 64, 40, [0, 300, 517, 1024, 1500, 2047, 2560, 1777]),
    (8, 2, 16, 8, [5, 0, 128, 77]),
])
def test_paged_stats_kernel_matches_plain(dev, h, h_kv, page, pps, lengths):
    b, p_total = len(lengths), 1 + len(lengths) * pps
    g = torch.Generator(device=dev).manual_seed(13)
    shape = (h_kv, p_total, page, 128)
    k = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    q = torch.randn((b, h, 128), generator=g, device=dev) * 128 ** -0.5
    table, lens = _paged_case(dev, b, lengths, page, pps, p_total, seed=14)
    before = paged_attention_with_stats.launches
    got = paged_attention_with_stats(q, k, v, lens, table)
    torch.cuda.synchronize()
    assert paged_attention_with_stats.launches == before + 1
    _assert_stats_close(got, attend_paged_with_stats_xla(q, k, v, table, lens), 1e-4)


def _paged_bf16(dev, h, h_kv, page, pps, lengths, seed, q_dtype=torch.float32):
    b, p_total = len(lengths), 1 + len(lengths) * pps
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (h_kv, p_total, page, 128)
    k = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    q = (torch.randn((b, h, 128), generator=g, device=dev) * 128 ** -0.5).to(q_dtype)
    table, lens = _paged_case(dev, b, lengths, page, pps, p_total, seed=seed + 1)
    return q, k, v, table, lens


@pytest.mark.cuda
@pytest.mark.parametrize("h,h_kv,page,pps,lengths,q_dtype", [
    # On, just under and just over the 256-token split; one token; none; a
    # table of 576 tokens, not a multiple of the split.
    (32, 32, 64, 9, [256, 255, 257, 512, 513, 1, 0, 576], torch.float32),
    (32, 4, 16, 40, [640, 1, 0, 257, 639, 300], torch.float32),  # G = 8, page 16
    (16, 16, 64, 7, [448, 447, 0, 256, 1], torch.float32),       # table width 448 tokens
    (32, 32, 64, 9, [576, 0, 300, 17], torch.bfloat16),          # the paged step's bf16 q
])
def test_paged_stats_kernel_split_boundaries(dev, h, h_kv, page, pps, lengths, q_dtype):
    q, k, v, table, lens = _paged_bf16(dev, h, h_kv, page, pps, lengths, seed=60,
                                       q_dtype=q_dtype)
    before = paged_attention_with_stats.launches
    got = paged_attention_with_stats(q, k, v, lens, table)
    torch.cuda.synchronize()
    assert paged_attention_with_stats.launches == before + 1
    want = attend_paged_with_stats_xla(q, k, v, table, lens)
    assert got[0].dtype == q_dtype
    if q_dtype == torch.float32:
        _assert_stats_close(got, want, 1e-4)
    else:  # out rounded to bf16 (relative step 2^-8) in both
        _assert_stats_close((want[0], *got[1:]), want, 1e-4)
        torch.testing.assert_close(got[0].float(), want[0].float(), **TOL)
    zero = lens == 0
    assert not got[0][zero].any() and torch.isneginf(got[1][zero]).all()
    assert not got[2][zero].any()


@pytest.mark.cuda
def test_paged_stats_kernel_is_one_launch(dev):
    """The paged step's call (bf16 q, int32 lengths and table): the split
    attention and the merge of the splits are one kernel, nothing else runs."""
    q, k, v, table, lens = _paged_bf16(dev, 32, 32, 64, 40, [2560, 0, 1500, 300], seed=80,
                                       q_dtype=torch.bfloat16)
    paged_attention_with_stats(q, k, v, lens, table)  # build and scratch, outside the trace
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        got = paged_attention_with_stats(q, k, v, lens, table)
        torch.cuda.synchronize()
    on_card = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(on_card) == 1 and "paged_attention_stats" in on_card[0], on_card
    want = attend_paged_with_stats_xla(q, k, v, table, lens)
    _assert_stats_close((want[0], *got[1:]), want, 1e-4)
    torch.testing.assert_close(got[0].float(), want[0].float(), **TOL)


@pytest.mark.cuda
def test_paged_stats_kernel_resets_its_merge_counters(dev):
    """The block that merges a (slot, kv head) sets its counter back to 0: a
    repeated call gives the same bits, and a call with other lengths after it
    is right. A length past the table's width (pps x page) counts as the
    width, as in the plain version, and leaves the counters at 0 too."""
    def counters_are_zero():
        torch.cuda.synchronize()
        key = (q.device, torch.cuda.current_stream(q.device).cuda_stream)
        return not split_merge._COUNTERS[key].any()

    q, k, v, table, lens = _paged_bf16(dev, 32, 32, 64, 40,
                                       [2560, 0, 1500, 700, 2047, 1, 256, 999], seed=70)
    first = paged_attention_with_stats(q, k, v, lens, table)
    for _ in range(3):
        again = paged_attention_with_stats(q, k, v, lens, table)
        for a, b in zip(first, again):
            assert torch.equal(a, b)
    assert counters_are_zero()
    over = lens.clone()
    over[0], over[3] = 2560 + 300, 9000  # the table holds 40 x 64 = 2560 tokens
    for lens2 in (over, (lens * 3 // 4).int(), lens):
        _assert_stats_close(paged_attention_with_stats(q, k, v, lens2, table),
                            attend_paged_with_stats_xla(q, k, v, table, lens2), 1e-4)
        assert counters_are_zero()


def _shared_prefix_table(dev, lengths, page, pps, p_total, n_shared, seed):
    """Every slot maps the same ``n_shared`` full pages first (one cached
    prefix), then private pages of its own."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    perm = torch.randperm(p_total - 1, generator=g) + 1
    table = torch.zeros((len(lengths), pps), dtype=torch.int32)
    table[:, :n_shared] = perm[:n_shared]
    nxt = n_shared
    for i, n in enumerate(lengths):
        used = min(-(-n // page), pps)
        table[i, n_shared:used] = perm[nxt:nxt + used - n_shared]
        nxt += used - n_shared
    return table.to(dev), torch.tensor(lengths, dtype=torch.int32, device=dev)


# 8 slots sharing 16 full pages of 64 (a 1024-token prefix), as prefix-cached
# questions about one video; and a small GQA case.
SHARED_CASES = [(32, 32, 64, 40, 8, 16, [1034, 1100, 1157, 1191, 1060, 1201, 1090, 1175]),
                (8, 2, 16, 8, 2, 3, [49, 60, 97, 128])]


@pytest.mark.cuda
@pytest.mark.parametrize("h,h_kv,page,pps,ppb,n_shared,lengths", SHARED_CASES)
def test_paged_kernels_on_shared_prefix_pages(dev, h, h_kv, page, pps, ppb, n_shared, lengths):
    """K4 (int8 pages) and K6 (bf16 pages) over page tables whose rows share
    their first full pages."""
    # _gathered_case's pool has 1 + (b + 1) * pps >= 1 + n_shared + b * pps pages.
    q, k, v, _, _, ks, vs = _gathered_case(dev, h, h_kv, page, pps, [0] * (len(lengths) + 1),
                                           seed=31)
    p_total, q = k.shape[0], q[:len(lengths)].contiguous()
    table, lens = _shared_prefix_table(dev, lengths, page, pps, p_total, n_shared, seed=32)
    assert (table[:, :n_shared] == table[:1, :n_shared]).all()
    got = gathered_paged_attention_int8(q, k, v, table, lens, ks, vs, pages_per_block=ppb)
    _assert_stats_close(got, gathered_paged_attention_int8_reference(
        q, k, v, table, lens, ks, vs, pages_per_block=ppb), 2e-3)
    g = torch.Generator(device=dev).manual_seed(33)
    kb = torch.randn((h_kv, p_total, page, 128), generator=g, device=dev).to(torch.bfloat16)
    vb = torch.randn((h_kv, p_total, page, 128), generator=g, device=dev).to(torch.bfloat16)
    _assert_stats_close(paged_attention_with_stats(q, kb, vb, lens, table),
                        attend_paged_with_stats_xla(q, kb, vb, table, lens), 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("layers,page,kd,h_kv,pps,ppb,lengths", [
    (32, 64, 4096, 32, 40, 8, [1034, 1100, 1157, 1191, 1060, 1201, 1090, 1175]),
    (2, 16, 256, 2, 8, 2, [5, 16, 47, 90]),
])
def test_fresh_write_over_rewound_rows_then_gathered(dev, layers, page, kd, h_kv, pps, ppb,
                                                     lengths):
    """A frozen grammar row: three garbage steps written by K5, the length
    rewound by 3, one more K5 write at the rewound position, then K4 over
    the new length. Equal to the plain write and the plain attention; the
    garbage rows past the length change nothing."""
    b, p_total = len(lengths), 1 + len(lengths) * pps
    g = torch.Generator(device=dev).manual_seed(41)
    pools = [torch.randint(-128, 128, (layers, p_total, page, kd), generator=g, device=dev,
                           dtype=torch.int8) for _ in range(2)]
    scales = [torch.rand((p_total, page, h_kv), generator=g, device=dev) + 0.05
              for _ in range(2)]
    table, lens = _paged_case(dev, b, [n + 4 for n in lengths], page, pps, p_total, seed=42)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    rows = torch.arange(b, device=dev)

    def write(kernel, pools, pos):
        fresh = [torch.randint(-128, 128, (layers, b, kd), generator=g, device=dev,
                               dtype=torch.int8) for _ in range(2)]
        pos = pos.long()
        return kernel(*pools, *fresh, table[rows, pos // page], pos % page)

    plain = [p.clone() for p in pools]
    for step in range(3):  # garbage steps past the valid length
        g.manual_seed(100 + step)
        write(paged_fresh_write, pools, lens + step)
        g.manual_seed(100 + step)
        write(paged_fresh_write_xla, plain, lens + step)
    g.manual_seed(200)  # rewound by 3: the next token lands at lens
    write(paged_fresh_write, pools, lens)
    g.manual_seed(200)
    write(paged_fresh_write_xla, plain, lens)
    torch.cuda.synchronize()
    for a, w in zip(pools, plain):
        assert torch.equal(a[:, 1:], w[:, 1:])
    q = torch.randn((b, h_kv, 128), generator=g, device=dev) * 128 ** -0.5
    new_len = lens + 1
    layer = layers - 1
    got = gathered_paged_attention_int8(q, pools[0][layer], pools[1][layer], table, new_len,
                                        *scales, pages_per_block=ppb)
    want = gathered_paged_attention_int8_reference(q, plain[0][layer], plain[1][layer], table,
                                                   new_len, *scales, pages_per_block=ppb)
    _assert_stats_close(got, want, 2e-3)
    for p in pools:  # the two garbage rows past the new length
        for extra in (1, 2):
            pos = (lens + extra).long()
            p[:, table[rows, pos // page].long(), pos % page] = 0
    again = gathered_paged_attention_int8(q, pools[0][layer], pools[1][layer], table, new_len,
                                          *scales, pages_per_block=ppb)
    for a, w in zip(again, got):
        assert torch.equal(a, w)


@pytest.mark.cuda
@pytest.mark.parametrize("layers,p_total,page,kd,b", [(32, 321, 64, 4096, 8), (2, 9, 16, 256, 5)])
def test_fresh_write_kernel_matches_plain(dev, layers, p_total, page, kd, b):
    g = torch.Generator(device=dev).manual_seed(15)
    pools = [torch.randint(-128, 128, (layers, p_total, page, kd), generator=g, device=dev,
                           dtype=torch.int8) for _ in range(2)]
    fresh = [torch.randint(-128, 128, (layers, b, kd), generator=g, device=dev,
                           dtype=torch.int8) for _ in range(2)]
    pages = torch.randperm(p_total - 1, device=dev)[:b].int() + 1
    pages[1] = 0  # two slots on the trash page
    pages[-1] = 0
    offs = torch.randint(0, page, (b,), generator=g, device=dev, dtype=torch.int32)
    want = paged_fresh_write_xla(*(p.clone() for p in pools), *fresh, pages, offs)
    before = paged_fresh_write.launches
    got = paged_fresh_write(*pools, *fresh, pages, offs)
    torch.cuda.synchronize()
    assert paged_fresh_write.launches == before + 1 and got[0] is pools[0]
    for a, w in zip(got, want):
        assert torch.equal(a[:, 1:], w[:, 1:])
    with pytest.raises(ValueError):
        paged_fresh_write(pools[0], pools[1], fresh[0].float(), fresh[1], pages, offs)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,group,dtype", [
    (8, 4096, 11008, 128, torch.bfloat16), (1, 4096, 4096, 128, torch.bfloat16),
    (64, 11008, 4096, 128, torch.bfloat16), (8, 4096, 32000, 128, torch.bfloat16),
    (5, 4096, 4096, 128, torch.float32), (3, 256, 1000, 32, torch.float32),
    (9, 128, 130, 16, torch.bfloat16), (17, 64, 37, 32, torch.float32),
    (9, 128, 130, 32, torch.bfloat16), (40, 256, 203, 64, torch.bfloat16),
    (2, 4096, 4096, 128, torch.bfloat16),
], ids=["up-proj", "m1", "verify-down-proj", "lm-head", "f32", "n-not-tile", "n-not-4", "odd-n",
        "tensor-cores-ragged-n", "tensor-cores-two-m-blocks", "m2"])
def test_int4_matmul_kernel_matches_plain(dev, m, k, n, group, dtype):
    g = torch.Generator(device=dev).manual_seed(m + n)
    w = torch.randn((k, n), generator=g, device=dev) * 0.02
    qk = quantize_int4(w, group)
    x = torch.randn((m, k), generator=g, device=dev).to(dtype)
    before = int4_matmul.launches
    got = int4_matmul(x, qk["q4"], qk["scale"])
    torch.cuda.synchronize()
    assert int4_matmul.launches == before + 1
    assert got.dtype == dtype and got.shape == (m, n)
    want = int4_matmul_reference(x, qk["q4"], qk["scale"])
    tol = dict(rtol=2e-5, atol=2e-5) if dtype == torch.float32 else dict(rtol=2 ** -7, atol=1e-3)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    # A second launch repeats the first bit for bit (no float atomics).
    assert torch.equal(int4_matmul(x, qk["q4"], qk["scale"]), got)
    # The dequantise-then-multiply route of large M computes the same product.
    dense = (x.float() @ dequantize_int4(qk, torch.float32)).to(dtype)
    torch.testing.assert_close(got.float(), dense.float(), rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
def test_int4_matmul_kernel_refuses_other_operands(dev):
    qk = quantize_int4(torch.randn((256, 64), device=dev), 32)
    x = torch.randn((65, 256), device=dev)
    for bad in (lambda: int4_matmul(x, qk["q4"], qk["scale"]),                       # M > 64
                lambda: int4_matmul(x[:4].half(), qk["q4"], qk["scale"]),            # f16
                lambda: int4_matmul(x[:4], qk["q4"].t(), qk["scale"]),               # layout
                lambda: int4_matmul(x[:4], qk["q4"], qk["scale"].float())):          # scales
        with pytest.raises(ValueError):
            bad()


@pytest.mark.cuda
@pytest.mark.parametrize("frames,n", SPATIAL_SHAPES)
def test_split_spatial_kernel_matches_plain(dev, frames, n):
    q = _randn(dev, frames, 16, n, 64, scale=0.125, seed=21)
    k, v = _randn(dev, frames, 16, n, 64, seed=22), _randn(dev, frames, 16, n, 64, seed=23)
    before = fused_spatial_core.launches
    got = fused_spatial_core(q, k, v)
    torch.cuda.synchronize()
    assert fused_spatial_core.launches == before + 1
    torch.testing.assert_close(got.float(), spatial_core_reference(q, k, v).float(), **TOL)
    with pytest.raises(ValueError):
        fused_spatial_core(q[..., :32].contiguous(), k[..., :32].contiguous(),
                           v[..., :32].contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("layout,b,t,n", [("bntd", 2, 8, 257), ("bntd", 1, 4, 3),
                                          ("fm", 2, 8, 257), ("fm", 1, 3, 5)])
def test_three_operand_temporal_kernels_match_plain(dev, layout, b, t, n):
    shape = (b, n, t, 1024) if layout == "bntd" else (b, t, n, 1024)
    q = _randn(dev, *shape, scale=0.125, seed=24)
    k, v = _randn(dev, *shape, seed=25), _randn(dev, *shape, seed=26)
    kernel, plain = ((fused_temporal_core, temporal_core_reference) if layout == "bntd"
                     else (fused_temporal_core_fm, temporal_core_fm_reference))
    before = kernel.launches
    got = kernel(q, k, v, num_heads=16)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    torch.testing.assert_close(got.float(), plain(q, k, v, 16).float(), **TOL)
    with pytest.raises(ValueError):
        kernel(q.float(), k.float(), v.float(), num_heads=16)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 3, 8])
@pytest.mark.parametrize("b", [8, 32])
@pytest.mark.parametrize("layout", ["fm3", "bntd", "fm"])
def test_temporal_core_layouts_at_main_path_shapes(dev, layout, b, t):
    """K2 (packed frame-major), K9 ((b, n, t, d)) and K10 (three frame-major
    operands) at the tower's 257 positions and 16 heads of 64, at the main
    path's 8 and 32 windows, with 1, 3 and 8 frames."""
    n, d = 257, 1024
    if layout == "fm3":
        qkv = torch.cat([_randn(dev, b, t, n, d, scale=0.125, seed=90 + t),
                         _randn(dev, b, t, n, 2 * d, seed=91 + t)], dim=-1)
        kernel, args, want = (fused_temporal_core_fm3, (qkv,),
                              temporal_core_fm3_reference(qkv, 16))
    else:
        shape = (b, n, t, d) if layout == "bntd" else (b, t, n, d)
        qkv = [_randn(dev, *shape, scale=0.125, seed=92 + t), _randn(dev, *shape, seed=93 + t),
               _randn(dev, *shape, seed=94 + t)]
        kernel, plain = ((fused_temporal_core, temporal_core_reference) if layout == "bntd"
                         else (fused_temporal_core_fm, temporal_core_fm_reference))
        args, want = qkv, plain(*qkv, 16)
    before = kernel.launches
    got = kernel(*args, num_heads=16)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), **TOL)
    assert torch.equal(kernel(*args, num_heads=16), got)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,sq,skv,dh,causal", [
    (8, 16, 257, 257, 64, False),   # the tower's shape: K and V staged once per head
    (2, 32, 512, 512, 128, True),   # dh 128: K and V streamed in 64-key tiles
    (1, 4, 37, 300, 64, True),      # Sq < Skv, causal from position 0; streamed
    (1, 4, 37, 200, 64, True),      # the same with the head's K and V staged once
    (1, 2, 90, 20, 128, True),      # Sq > Skv
    (1, 3, 700, 250, 64, True),     # Sq > Skv over several row blocks of one head
    (2, 3, 1, 7, 64, False),        # one query row
    (1, 2, 1, 1000, 128, True),     # one query row sees one key of many
    (1, 2, 45, 130, 128, False),    # Sq off 16, Skv off 64
    (2, 2, 100, 1024, 64, True),    # Skv = 1024: no length cap
    (1, 2, 33, 1024, 128, False),
])
def test_block_kernel_matches_plain(dev, b, h, sq, skv, dh, causal):
    q = _randn(dev, b, h, sq, dh, seed=27)
    k, v = _randn(dev, b, h, skv, dh, seed=28), _randn(dev, b, h, skv, dh, seed=29)
    before = block_attention.launches
    got = block_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert block_attention.launches == before + 1
    want = block_attention_reference(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), **TOL)
    for scale in (0.3, -0.2, 0.0):  # the kernel takes scale > 0; the wrapper maps the others
        got = block_attention(q, k, v, causal=causal, scale=scale)
        want = block_attention_reference(q, k, v, causal=causal, scale=scale)
        torch.testing.assert_close(got.float(), want.float(), **TOL)


@pytest.mark.cuda
def test_block_kernel_refuses_other_operands(dev):
    q = _randn(dev, 1, 2, 16, 64)
    no_kv = q[:, :, :0]
    for bad in (lambda: block_attention(q, no_kv, no_kv),                   # Skv = 0
                lambda: block_attention(q[..., :32], q[..., :32], q[..., :32]),  # dh 32
                lambda: block_attention(q.float(), q.float(), q.float())):  # f32
        with pytest.raises(ValueError):
            bad()


@pytest.mark.cuda
def test_differentiable_ops_launch_forward_only_and_match_plain_grads(dev):
    """Kernel forward (one launch each), plain-recompute backward (no launch);
    the gradients equal those of the plain statements on the same inputs."""
    q4 = _randn(dev, 4, 16, 257, 64, scale=0.125, seed=30)
    k4, v4 = _randn(dev, 4, 16, 257, 64, seed=31), _randn(dev, 4, 16, 257, 64, seed=32)
    packed = [x.transpose(1, 2).reshape(4, 257, 1024).contiguous() for x in (q4, k4, v4)]
    bntd = [_randn(dev, 2, 257, 8, 1024, scale=0.125, seed=33),
            _randn(dev, 2, 257, 8, 1024, seed=34), _randn(dev, 2, 257, 8, 1024, seed=35)]
    qkv = torch.cat([_randn(dev, 2, 8, 257, 1024, scale=0.125, seed=36),
                     _randn(dev, 2, 8, 257, 2048, seed=37)], dim=-1)
    cases = [(spatial_core, spatial_core_reference, (q4, k4, v4), fused_spatial_core),
             (lambda *a: spatial_core_packed(*a, 16),
              lambda *a: spatial_core_packed_reference(*a, 16), packed,
              fused_spatial_core_packed),
             (lambda *a: temporal_core(*a, 16), lambda *a: temporal_core_reference(*a, 16),
              bntd, fused_temporal_core),
             (lambda x: temporal_core_fm3(x, 16), lambda x: temporal_core_fm3_reference(x, 16),
              [qkv], fused_temporal_core_fm3)]
    for op, plain, inputs, kernel in cases:
        g = torch.randn_like(inputs[0][..., :1024] if kernel is fused_temporal_core_fm3
                             else inputs[0])
        leaves = [x.clone().requires_grad_(True) for x in inputs]
        before = kernel.launches
        out = op(*leaves)
        assert kernel.launches == before + 1 and out.grad_fn is not None
        out.backward(g)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        ref_leaves = [x.clone().requires_grad_(True) for x in inputs]
        plain(*ref_leaves).backward(g)
        for got, want in zip(leaves, ref_leaves):
            torch.testing.assert_close(got.grad.float(), want.grad.float(), **TOL)


@pytest.mark.cuda
def test_kernel_wrappers_refuse_inputs_that_want_a_gradient(dev):
    x = _randn(dev, 1, 2, 16, 64).requires_grad_(True)
    xt = _randn(dev, 1, 8, 3, 1024).requires_grad_(True)
    calls = [lambda: fused_spatial_core(x, x, x),
             lambda: fused_temporal_core_fm(xt, xt, xt, num_heads=16),
             lambda: fused_temporal_core(xt, xt, xt, num_heads=16),
             lambda: block_attention(x, x, x),
             lambda: flash_attention(x, x, x)]
    for call in calls:
        with pytest.raises(RuntimeError, match="forward-only"):
            call()
        with torch.no_grad():
            call()  # no graph wanted: it launches


def _loop_peaks(sim, reverse):
    xs = sim.flip(0) if reverse else sim
    peaks = [xs[0]]
    for i in range(1, xs.shape[0]):
        peaks.append(torch.where(xs[i - 1] >= xs[i], peaks[-1], xs[i]))
    out = torch.stack(peaks)
    return out.flip(0) if reverse else out


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "tied", "neg_inf_tail"])
def test_monotone_run_peaks_gather_equals_loop_on_the_card(dev, kind):
    from videollamb_torch.ops.scene_tilling import _monotone_run_peaks

    g = torch.Generator(device=dev).manual_seed(3)
    for n in (1, 7, 511):
        s = torch.randn((n,), generator=g, device=dev)
        if kind == "tied":
            s = s.round()
        elif kind == "neg_inf_tail":
            s[n // 2:] = float("-inf")
        for reverse in (False, True):
            assert torch.equal(_monotone_run_peaks(s, reverse=reverse), _loop_peaks(s, reverse))


class _WordTokenizer:
    bos_token_id, eos_token_id, pad_token_id = 1, 2, 0

    def __call__(self, text):
        import types
        import zlib

        words = text.replace("</s>", " </s> ").split()
        return types.SimpleNamespace(input_ids=[1] + [
            2 if w == "</s>" else 4 + zlib.crc32(w.encode()) % 252 for w in words])

    def decode(self, tokens, skip_special_tokens=True):
        return " ".join(str(int(t)) for t in tokens if int(t) > 2)


@pytest.mark.cuda
def test_streaming_session_kernels_match_plain_on_the_card(dev):
    """A tiny bf16 StreamingSession (head dims 64, as K1 and K3 take) over still
    scenes, with the kernels and with their plain versions: equal boundaries
    and response times, K1 and K3 launched by the first run only, the bridge
    memory close, every encode after the first served from the prefetch."""
    from videollamb_torch.config import BridgeConfig, LlamaConfig, ModelConfig, VisionConfig
    from videollamb_torch.models.assembly import VideoLLaMB
    from videollamb_torch.models.bridge.rmt_r import init_rmt_r_params
    from videollamb_torch.models.lm.llama import init_llama_params
    from videollamb_torch.models.vision.clip_vit import init_vision_params
    from videollamb_torch.ops import attention
    from videollamb_torch.ops import spatial_attention as sa
    from videollamb_torch.serve.chat import Chat
    from videollamb_torch.serve.incremental import StreamingSession

    cfg = ModelConfig(
        vision=VisionConfig(hidden_size=128, intermediate_size=256, num_hidden_layers=2,
                            num_attention_heads=2, image_size=56, patch_size=14),
        lm=LlamaConfig(vocab_size=256, hidden_size=128, intermediate_size=256,
                       num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=2),
        bridge=BridgeConfig.from_projector_type("rmt_r_transformer1x", hidden_size=128),
        max_length=512)
    kw = dict(dtype=torch.bfloat16, device=dev)
    model = VideoLLaMB(init_vision_params(cfg.vision, seed=0, **kw),
                       init_rmt_r_params(cfg.bridge, cfg.lm.hidden_size, seed=1, **kw),
                       init_llama_params(cfg.lm, seed=2, **kw))
    g = torch.Generator().manual_seed(0)
    frames = torch.cat([torch.randn((1, 3, 56, 56), generator=g).expand(n, -1, -1, -1)
                        for n in (12, 12, 6, 6)]).numpy()

    def run():
        sess = StreamingSession(Chat(_WordTokenizer(), model, cfg, {}), max_seq_len=512,
                                max_new_tokens=4)
        sess.video_tensor, sess.num_video_frames = frames, frames.shape[0]
        sess.input_query_stream("what is shown", video_time=5.0)
        ticks = []
        for i in range(frames.shape[0]):
            sess.input_video_stream(float(i))
            q, r = sess()
            ticks.append((q is not None, list(sess._segment_boundaries())))
        return sess, ticks

    with torch.no_grad():
        k1, k3 = sa.fused_spatial_core_packed.launches, attention.flash_attention.launches
        sess, ticks = run()
        launched = (sa.fused_spatial_core_packed.launches - k1,
                    attention.flash_attention.launches - k3)
        saved = sa.fused_spatial_core_packed, attention.flash_attention
        from videollamb_torch.ops.flash_attention import flash_attention_reference

        sa.fused_spatial_core_packed = (
            lambda q, k, v, *, heads: sa.spatial_core_packed_reference(q, k, v, heads))
        attention.flash_attention = flash_attention_reference
        try:
            plain, plain_ticks = run()
        finally:
            sa.fused_spatial_core_packed, attention.flash_attention = saved
    assert launched[0] == frames.shape[0] and launched[1] >= 1
    assert (sa.fused_spatial_core_packed.launches - k1,
            attention.flash_attention.launches - k3) == launched
    assert ticks == plain_ticks and sum(t[0] for t in ticks) >= 2
    assert (sess.prefetch_hits, sess.prefetch_misses) == (frames.shape[0] - 1, 1)
    got, want = sess.bridge_state.memory.float(), plain.bridge_state.memory.float()
    assert torch.isfinite(got).all()
    assert float((got - want).norm() / want.norm()) <= 5e-2
