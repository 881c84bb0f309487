"""Kernels K4 and K6 of the paged decode step: the port's plain versions
against the JAX package on the CPU, at small sizes (h=8, h_kv 8 and 2,
dh=128, page 16), with partial pages and zero-length slots.

- K4: ``gathered_paged_attention_int8_reference`` against the Pallas kernel
  ``gathered_paged_attention_int8(..., interpret=True)``. m and l within
  atol 1e-5 (rtol 1e-5: l sums up to 128 probabilities); out within 1e-3 of
  max|out|, one int8 step of the probability requantisation, which a 1-ulp
  difference in ``exp`` can flip.
- K6: ``paged_attention_with_stats`` on CPU tensors (its plain version
  ``attend_paged_with_stats_xla``) against the JAX XLA statement, and
  against the stock Pallas kernel that the JAX ``paged_attention_with_stats``
  launches, its ``pl.pallas_call`` run in interpret mode for the test.
- K4's split-and-merge decomposition, as the CUDA kernel computes it (each
  requantisation block against its own max, the blocks merged by the
  log-sum-exp rule), stated in this file and held against the same Pallas
  kernel with the same tolerances, including blocks whose max rises from
  block to block and lengths past the table's width.
- The int8 XLA twins (token-major and shared-pool) against the JAX twins,
  and ``merge_one_token``.

The CUDA kernels are held against these plain versions in
test_torch_cuda_kernels.py.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from videollamb_tpu.ops import gathered_paged_attention as jgpa  # noqa: E402
from videollamb_tpu.ops import paged_attention_stats as jpas  # noqa: E402
from videollamb_torch.ops import gathered_paged_attention as gpa  # noqa: E402
from videollamb_torch.ops import paged_attention_stats as pas  # noqa: E402
from videollamb_torch.ops.quantization import (  # noqa: E402
    MAX_INT8,
    exact_div,
    round_to_int8,
)

H, DH, PAGE, PPS = 8, 128, 16, 8
STATS_TOL = dict(rtol=1e-5, atol=1e-5)
F32_TOL = dict(rtol=2e-5, atol=2e-5)


def _tables(rng, b, p_total):
    """Disjoint pages per slot from page 1 on; ragged lengths with a
    zero-length slot, partial last pages and one full slot."""
    table = np.zeros((b, PPS), np.int32)
    perm = rng.permutation(np.arange(1, p_total))
    lengths = [0, PPS * PAGE] + [int(x) for x in rng.integers(1, PPS * PAGE, b - 2)]
    nxt = 0
    for i, n in enumerate(lengths):
        used = -(-n // PAGE)
        table[i, :used] = perm[nxt:nxt + used]
        nxt += used
    return table, np.asarray(lengths, np.int32)


def _token_major(rng, b, h_kv):
    p_total = 1 + b * PPS
    kd = h_kv * DH
    k = rng.integers(-128, 128, (p_total, PAGE, kd)).astype(np.int8)
    v = rng.integers(-128, 128, (p_total, PAGE, kd)).astype(np.int8)
    ks = rng.uniform(0.05, 2.0, (p_total, PAGE, h_kv)).astype(np.float32)
    vs = rng.uniform(0.05, 2.0, (p_total, PAGE, h_kv)).astype(np.float32)
    table, lengths = _tables(rng, b, p_total)
    q = (rng.normal(size=(b, H, DH)) * DH ** -0.5).astype(np.float32)
    return q, k, v, table, lengths, ks, vs


def _t(*xs):
    return [torch.from_numpy(np.asarray(x)) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


@pytest.mark.parametrize("h_kv", [8, 2])
@pytest.mark.parametrize("ppb", [2, 8])
def test_k4_plain_matches_pallas_interpret(h_kv, ppb):
    q, k, v, table, lengths, ks, vs = _token_major(np.random.default_rng(h_kv + ppb), 5, h_kv)
    want = jgpa.gathered_paged_attention_int8(*_j(q, k, v, table, lengths, ks, vs),
                                              pages_per_block=ppb, interpret=True)
    got = gpa.gathered_paged_attention_int8(*_t(q, k, v, table, lengths, ks, vs),
                                            pages_per_block=ppb)
    out, m, l = (np.asarray(x) for x in want)
    np.testing.assert_allclose(got[1].numpy(), m, **STATS_TOL)
    np.testing.assert_allclose(got[2].numpy(), l, **STATS_TOL)
    np.testing.assert_allclose(got[0].numpy(), out, rtol=0, atol=1e-3 * np.abs(out).max())
    assert lengths[0] == 0 and not got[0][0].any() and torch.isneginf(got[1][0]).all()
    assert not got[2][0].any()


def test_k4_multi_layer_pool_selects_the_layer():
    rng = np.random.default_rng(3)
    q, k, v, table, lengths, ks, vs = _token_major(rng, 3, 2)
    k2 = np.stack([rng.permutation(k.ravel()).reshape(k.shape), k])
    v2 = np.stack([v[::-1].copy(), v])
    one = gpa.gathered_paged_attention_int8(*_t(q, k, v, table, lengths, ks, vs),
                                            pages_per_block=4)
    two = gpa.gathered_paged_attention_int8(*_t(q, k2, v2, table, lengths, ks, vs),
                                            pages_per_block=4, layer=1)
    for a, b in zip(one, two):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_pick_ppb_blocks_of_512_tokens():
    assert gpa._pick_ppb(40, 64) == 8 == jgpa._pick_ppb(40, 64)
    assert gpa._pick_ppb(8, 16) == 8
    assert gpa._pick_ppb(6, 64) == 6
    assert gpa._pick_ppb(7, 128) == 1


def _k4_split_merge(q, k, v, table, lengths, ks, vs, ppb):
    """The CUDA kernel's algorithm for K4, stated plainly: every
    (slot, kv head, block of ppb pages) takes exp against its own block's
    max and requantises its probabilities on their own absmax (the TPU
    kernel takes the running max); the blocks' normalised partials merge by
    the log-sum-exp rule in block order, and a slot with one live block
    keeps its block's result. Lengths are cut to the table's width. Returns
    (out, m, l) and the (B, H, n_blocks) block maxima."""
    q, k, v, ks, vs = (torch.from_numpy(np.asarray(x)) for x in (q, k, v, ks, vs))
    b, h, dh = q.shape
    page, h_kv = k.shape[1], ks.shape[2]
    groups, pps = h // h_kv, table.shape[1]
    t = ppb * page
    qs = q.abs().amax(-1, keepdim=True).clamp_min(1e-30)
    q8 = round_to_int8(q * exact_div(MAX_INT8, qs)).double()
    out = torch.zeros((b, h, dh))
    m = torch.full((b, h), -torch.inf)
    l = torch.zeros((b, h))
    maxima = torch.full((b, h, pps // ppb), -torch.inf)
    for slot in range(b):
        n = min(int(lengths[slot]), pps * page)
        if n == 0:
            continue
        pages = torch.from_numpy(table[slot].astype(np.int64))
        tok = (pages[:, None] * page + torch.arange(page)).reshape(-1)[:n]  # pool rows
        kt = k.reshape(-1, h_kv, dh)[tok].double()
        vt = v.reshape(-1, h_kv, dh)[tok].double()
        kst, vst = ks.reshape(-1, h_kv)[tok], vs.reshape(-1, h_kv)[tok]
        for head in range(h):
            kh = head // groups
            parts = []
            for s0 in range(0, n, t):
                sl = slice(s0, min(s0 + t, n))
                dot = (kt[sl, kh] @ q8[slot, head]).float()
                s = dot * exact_div(qs[slot, head] * kst[sl, kh], MAX_INT8 * MAX_INT8)
                m_i = s.max()
                p = torch.exp(s - m_i)
                w = p * exact_div(vst[sl, kh], MAX_INT8)
                wscale = w.abs().max().clamp_min(1e-30)
                w8 = round_to_int8(w * exact_div(MAX_INT8, wscale)).double()
                acc = (w8 @ vt[sl, kh]).float() * exact_div(wscale, MAX_INT8)
                maxima[slot, head, s0 // t] = m_i
                parts.append((acc, m_i, p.sum()))
            if len(parts) == 1:
                acc, m_i, l_i = parts[0]
                out[slot, head], m[slot, head], l[slot, head] = acc / l_i, m_i, l_i
                continue
            m_all = max(m_i for _, m_i, _ in parts)
            wgt = [l_i * torch.exp(m_i - m_all) for _, m_i, l_i in parts]
            l_all = sum(wgt)
            o = sum(w_i * (acc / l_i) for w_i, (acc, _, l_i) in zip(wgt, parts))
            out[slot, head], m[slot, head], l[slot, head] = o / l_all, m_all, l_all
    return out, m, l, maxima


@pytest.mark.parametrize("case", ["random", "rising", "past-width"])
@pytest.mark.parametrize("h_kv,ppb", [(8, 2), (2, 2), (2, 4)])
def test_k4_split_merge_matches_pallas_interpret(case, h_kv, ppb):
    """K4's CUDA decomposition (block-local maxima, log-sum-exp merge)
    against the Pallas kernel in interpret mode: m and l within 1e-5, out
    within 1e-3 of max|out|. "rising": the k-scales grow page by page, so a
    later block's max exceeds an earlier one's and the merge must rescale
    the earlier blocks. "past-width": lengths past the table's 128 tokens
    count as 128, as the Pallas grid sees only the table's pages."""
    rng = np.random.default_rng(50 + h_kv + ppb)
    q, k, v, table, lengths, ks, vs = _token_major(rng, 5, h_kv)
    if case == "rising":  # k-scales of a slot's j-th page times 1 + j
        ks = ks.copy()
        for j in range(1, PPS):
            ks[table[:, j]] *= np.float32(1 + j)
    want = jgpa.gathered_paged_attention_int8(*_j(q, k, v, table, lengths, ks, vs),
                                              pages_per_block=ppb, interpret=True)
    if case == "past-width":
        lengths = lengths.copy()
        lengths[1], lengths[3] = PPS * PAGE + 5, 10 ** 6
        lengths[2] = PPS * PAGE
        want = jgpa.gathered_paged_attention_int8(
            *_j(q, k, v, table, np.minimum(lengths, PPS * PAGE), ks, vs),
            pages_per_block=ppb, interpret=True)
    out, m, l, maxima = _k4_split_merge(q, k, v, table, lengths, ks, vs, ppb)
    if case == "rising":  # heads of the full slot whose last block's max beats the first's
        assert (maxima[1, :, -1] > maxima[1, :, 0]).sum() >= h_kv
    w_out, w_m, w_l = (np.asarray(x) for x in want)
    np.testing.assert_allclose(m.numpy(), w_m, **STATS_TOL)
    np.testing.assert_allclose(l.numpy(), w_l, **STATS_TOL)
    np.testing.assert_allclose(out.numpy(), w_out, rtol=0, atol=1e-3 * np.abs(w_out).max())
    assert lengths[0] == 0 and not out[0].any() and torch.isneginf(m[0]).all()


@pytest.mark.parametrize("h_kv", [8, 2])
def test_token_major_twin_matches_jax(h_kv):
    q, k, v, table, lengths, ks, vs = _token_major(np.random.default_rng(10 + h_kv), 5, h_kv)
    want = jgpa.attend_token_major_int8_stats(*_j(q, k, v, table, lengths, ks, vs))
    got = gpa.attend_token_major_int8_stats(*_t(q, k, v, table, lengths, ks, vs))
    out, m, l = (np.asarray(x) for x in want)
    np.testing.assert_allclose(got[1].numpy(), m, **STATS_TOL)
    np.testing.assert_allclose(got[2].numpy(), l, **STATS_TOL)
    np.testing.assert_allclose(got[0].numpy(), out, rtol=0, atol=1e-3 * np.abs(out).max())


def _head_major(rng, b, h_kv, int8=False):
    p_total = 1 + b * PPS
    shape = (h_kv, p_total, PAGE, DH)
    if int8:
        k = rng.integers(-128, 128, shape).astype(np.int8)
        v = rng.integers(-128, 128, shape).astype(np.int8)
    else:
        k = rng.normal(size=shape).astype(np.float32)
        v = rng.normal(size=shape).astype(np.float32)
    ks = rng.uniform(0.05, 2.0, shape[:-1] + (1,)).astype(np.float32)
    vs = rng.uniform(0.05, 2.0, shape[:-1] + (1,)).astype(np.float32)
    table, lengths = _tables(rng, b, p_total)
    q = (rng.normal(size=(b, H, DH)) * DH ** -0.5).astype(np.float32)
    return q, k, v, table, lengths, ks, vs


@pytest.mark.parametrize("h_kv", [8, 2])
def test_k6_plain_matches_jax_xla(h_kv):
    q, k, v, table, lengths, _, _ = _head_major(np.random.default_rng(20 + h_kv), 5, h_kv)
    want = jpas.attend_paged_with_stats_xla(*_j(q, k, v, table, lengths))
    got = pas.paged_attention_with_stats(*_t(q, k, v, lengths, table))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32_TOL)
    assert not got[0][0].any() and torch.isneginf(got[1][0]).all() and not got[2][0].any()


@pytest.mark.parametrize("h_kv", [8, 2])
def test_k6_plain_matches_pallas_interpret(monkeypatch, h_kv):
    """The stock kernel rounds f32 pages to bf16 on the way in, so K and V
    hold bf16 values (f32 pages would part by 6e-3). G = H / H_kv is 1 and 4;
    slot 0 has no token, slot 1 fills all of its pages. Two pages a compute
    block: the kernel's online softmax crosses four blocks of a full slot."""
    monkeypatch.setattr(jpas.pl, "pallas_call",
                        functools.partial(jpas.pl.pallas_call, interpret=True))
    q, k, v, table, lengths, _, _ = _head_major(np.random.default_rng(40 + h_kv), 5, h_kv)
    k, v = (torch.from_numpy(x).to(torch.bfloat16).float().numpy() for x in (k, v))
    want = jpas.paged_attention_with_stats(*_j(q, k, v, lengths, table),
                                           pages_per_compute_block=2)
    got = pas.paged_attention_with_stats(*_t(q, k, v, lengths, table))
    out, m, l = (np.asarray(x) for x in want)
    np.testing.assert_allclose(got[1].numpy(), m, **STATS_TOL)
    np.testing.assert_allclose(got[2].numpy(), l, **STATS_TOL)
    np.testing.assert_allclose(got[0].numpy(), out, **F32_TOL)
    assert lengths[0] == 0 and not got[0][0].any() and torch.isneginf(got[1][0]).all()
    assert not got[2][0].any()


@pytest.mark.parametrize("h_kv", [8, 2])
def test_int8_twins_match_jax(h_kv):
    q, k, v, table, lengths, ks, vs = _head_major(np.random.default_rng(30 + h_kv), 5, h_kv,
                                                  int8=True)
    want = jpas.attend_pool_int8_stats(*_j(q, k, v, table, lengths, ks, vs))
    got = pas.attend_pool_int8_stats(*_t(q, k, v, table, lengths, ks, vs))
    out, m, l = (np.asarray(x) for x in want)
    np.testing.assert_allclose(got[1].numpy(), m, **STATS_TOL)
    np.testing.assert_allclose(got[2].numpy(), l, **STATS_TOL)
    np.testing.assert_allclose(got[0].numpy(), out, rtol=0, atol=1e-3 * np.abs(out).max())


def test_merge_one_token_matches_jax():
    rng = np.random.default_rng(4)
    o = rng.normal(size=(3, H, DH)).astype(np.float32)
    m = rng.normal(size=(3, H)).astype(np.float32)
    m[0] = -np.inf  # a slot with no resident token
    l = np.abs(rng.normal(size=(3, H))).astype(np.float32) + 0.5
    l[0] = 0.0
    o[0] = 0.0
    s = rng.normal(size=(3, H)).astype(np.float32)
    v = rng.normal(size=(3, H, DH)).astype(np.float32)
    want = np.asarray(jpas.merge_one_token(*_j(o, m, l, s, v)))
    got = pas.merge_one_token(*_t(o, m, l, s, v)).numpy()
    np.testing.assert_allclose(got, want, **F32_TOL)
    np.testing.assert_allclose(got[0], v[0], **F32_TOL)  # only the new key


def test_k4_saturates_the_query_absmax():
    """A query row whose absmax element is positive quantises it to +127:
    +127.5 rounds to +128, which JAX saturates and a bare ``.to(int8)``
    would wrap to -128, flipping the score's sign."""
    rng = np.random.default_rng(5)
    q, k, v, table, lengths, ks, vs = _token_major(rng, 3, 8)
    q = np.abs(q)  # every head's absmax is positive
    k[:] = 100
    want = jgpa.gathered_paged_attention_int8(*_j(q, k, v, table, lengths, ks, vs),
                                              pages_per_block=4, interpret=True)
    got = gpa.gathered_paged_attention_int8(*_t(q, k, v, table, lengths, ks, vs),
                                            pages_per_block=4)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **STATS_TOL)
    assert (got[1][1:] > 0).all()  # all-positive q . k: the max score is positive
