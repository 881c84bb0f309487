"""The chunked, differentiable attention of training (``_chunked_attention``)
and the packed-row ``segment_ids`` of the plain statement, against the JAX
package's ``_chunked_attention`` / ``_xla_attention`` on the CPU in f32:
outputs, and gradients of q, k and v against ``jax.vjp`` with one seeded
cotangent. The cases cover causal and non-causal attention, a ragged key
mask, grouped-query heads, packed segments, a key length that is not a
multiple of ``block_kv``, and a query row that sees no key (l == 0)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from videollamb_tpu.ops.attention import _chunked_attention as jax_chunked  # noqa: E402
from videollamb_tpu.ops.attention import _xla_attention  # noqa: E402
from videollamb_torch.ops.attention import (  # noqa: E402
    _chunked_attention,
    multihead_attention,
)

# f32 online softmax, summed per block in other orders than XLA's.
F32_TOL = dict(rtol=2e-5, atol=2e-5)
# Gradients: a backward through exp and the running rescale, in f32.
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _case(b, s, h, hkv, dh, lengths, segments, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, s, h, dh)).astype(np.float32)
    k = rng.normal(size=(b, s, hkv, dh)).astype(np.float32)
    v = rng.normal(size=(b, s, hkv, dh)).astype(np.float32)
    mask = np.arange(s)[None] < np.asarray(lengths)[:, None]
    seg = None
    if segments:
        # Contiguous runs 1..segments per row, 0 past the row's length.
        cuts = np.sort(rng.choice(np.arange(1, s), size=segments - 1, replace=False))
        seg = np.searchsorted(cuts, np.arange(s), side="right")[None].repeat(b, 0) + 1
        seg = np.where(mask, seg, 0).astype(np.int32)
    cot = rng.normal(size=(b, s, h, dh)).astype(np.float32)
    return q, k, v, mask, seg, cot


CASES = {
    "causal_gqa_ragged": (2, 37, 4, 2, 16, [37, 23], 0, True, 16),
    "noncausal_mha": (1, 40, 2, 2, 8, [40], 0, False, 16),
    "segments_gqa": (2, 45, 4, 2, 16, [45, 31], 3, True, 16),
    "segments_one_block": (1, 24, 2, 1, 8, [20], 2, True, 64),
    "no_key_rows": (2, 33, 2, 2, 8, [33, 0], 0, False, 8),
}


@pytest.mark.parametrize("name", list(CASES))
def test_chunked_matches_jax_forward_and_vjp(name):
    b, s, h, hkv, dh, lengths, segments, causal, block = CASES[name]
    q, k, v, mask, seg, cot = _case(b, s, h, hkv, dh, lengths, segments, seed=s * h)
    scale = dh ** -0.5

    def jax_fn(q_, k_, v_):
        return jax_chunked(q_, k_, v_, causal=causal, k_mask=jnp.asarray(mask), scale=scale,
                           block_kv=block,
                           segment_ids=None if seg is None else jnp.asarray(seg))

    want, vjp = jax.vjp(jax_fn, *(jnp.asarray(x) for x in (q, k, v)))
    want_grads = vjp(jnp.asarray(cot))

    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    got = _chunked_attention(qt, kt, vt, causal=causal, k_mask=torch.from_numpy(mask),
                             scale=scale, block_kv=block,
                             segment_ids=None if seg is None else torch.from_numpy(seg))
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **F32_TOL)
    for t, w in zip((qt, kt, vt), want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), **GRAD_TOL)


@pytest.mark.parametrize("name", ["causal_gqa_ragged", "segments_gqa"])
def test_dispatch_routes_agree_with_xla(name):
    """``multihead_attention`` with impl chunked and torch against the JAX XLA
    statement; the kernel route refuses segments (it has no segment lane)."""
    b, s, h, hkv, dh, lengths, segments, causal, _ = CASES[name]
    q, k, v, mask, seg, _ = _case(b, s, h, hkv, dh, lengths, segments, seed=s + h)
    jseg = None if seg is None else jnp.asarray(seg)
    want = np.asarray(_xla_attention(*(jnp.asarray(x) for x in (q, k, v)), causal=causal,
                                     k_mask=jnp.asarray(mask), scale=dh ** -0.5,
                                     segment_ids=jseg))
    tseg = None if seg is None else torch.from_numpy(seg)
    for impl in ("chunked", "torch"):
        got = multihead_attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                                  k_mask=torch.from_numpy(mask), impl=impl, segment_ids=tseg)
        np.testing.assert_allclose(got.numpy(), want, **F32_TOL, err_msg=impl)
    if seg is not None:
        with pytest.raises(ValueError, match="segment lane"):
            multihead_attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                                k_mask=torch.from_numpy(mask), impl="kernel",
                                segment_ids=tseg)


def test_chunked_backward_recomputes_blocks():
    """With a gradient wanted each block's scores are recomputed in the
    backward: the graph saves no (Sq, block) score tensor, only the carry."""
    b, s, h, dh, block = 1, 256, 2, 8, 64
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=(b, s, h, dh)).astype(np.float32))
               .requires_grad_(True) for _ in range(3))
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = _chunked_attention(q, k, v, causal=True, k_mask=None, scale=dh ** -0.5,
                                 block_kv=block)
    assert not [shape for shape in saved if shape[-1] == block and s in shape], saved
    out.sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()
