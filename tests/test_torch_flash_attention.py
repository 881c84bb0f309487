"""Kernel K3 (flash attention for the LM prefill): the port's plain version
against the JAX package's XLA and chunked statements, through the port's
``multihead_attention`` dispatcher, and against the JAX flash kernel itself
(its ``pl.pallas_call`` run in interpret mode for the test). Kernel K11
(whole-row block attention): the port's plain version against the JAX
``block_attention`` run in interpret mode. The CUDA kernels are held
against the plain versions in test_torch_cuda_kernels.py.

A query row with no valid key gives the mean of v in the port, as the JAX
XLA statement gives on every row; the JAX flash kernel gives such a row
another value (its online softmax starts from a finite -1e30 mask), so it
is compared on the rows that have a valid key."""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from videollamb_tpu.ops.attention import _chunked_attention, _xla_attention  # noqa: E402
from videollamb_torch.ops.attention import multihead_attention  # noqa: E402
from videollamb_tpu.ops import flash_attention as jax_fa  # noqa: E402
from videollamb_torch.ops.flash_attention import (  # noqa: E402
    block_attention,
    block_attention_reference,
    flash_attention,
    flash_attention_reference,
)

F32_TOL = dict(rtol=2e-5, atol=2e-5)


def _case(b, s, h, hkv, dh, lengths, seed, left_pad=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, s, h, dh)).astype(np.float32)
    k = rng.normal(size=(b, s, hkv, dh)).astype(np.float32)
    v = rng.normal(size=(b, s, hkv, dh)).astype(np.float32)
    pos = np.arange(s)[None]
    mask = (pos < np.asarray(lengths)[:, None]) & (pos >= left_pad)
    return q, k, v, mask


@pytest.mark.parametrize("b,s,h,hkv,dh,lengths,causal", [
    (2, 37, 4, 4, 16, [37, 23], True),     # ragged key mask
    (2, 37, 4, 2, 16, [30, 11], True),     # grouped-query heads
    (1, 37, 2, 2, 8, [37], False),
    (1, 2048, 2, 2, 16, [1400], True),     # prefill length, padded tail
])
def test_plain_matches_xla_and_chunked(b, s, h, hkv, dh, lengths, causal):
    q, k, v, mask = _case(b, s, h, hkv, dh, lengths, seed=s + h)
    j = [jnp.asarray(x) for x in (q, k, v, mask)]
    xla = np.asarray(_xla_attention(*j[:3], causal=causal, k_mask=j[3], scale=dh ** -0.5))
    chunked = np.asarray(_chunked_attention(*j[:3], causal=causal, k_mask=j[3],
                                            scale=dh ** -0.5, block_kv=16))
    got = multihead_attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                              k_mask=torch.from_numpy(mask), impl="kernel").numpy()
    np.testing.assert_allclose(got, xla, **F32_TOL)
    np.testing.assert_allclose(got, chunked, **F32_TOL)
    torch_impl = multihead_attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                                     k_mask=torch.from_numpy(mask), impl="torch").numpy()
    np.testing.assert_allclose(torch_impl, xla, **F32_TOL)


def test_rows_without_a_valid_key_give_zero():
    """Rows 0..5 see only padded keys. They used to give 0 in the port; they
    now give what ``_xla_attention`` gives there, the mean of v over all keys,
    through the wrapper and through the plain version alike."""
    q, k, v, mask = _case(1, 37, 2, 2, 8, [37], seed=5, left_pad=6)
    xla = np.asarray(_xla_attention(*map(jnp.asarray, (q, k, v)), causal=True,
                                    k_mask=jnp.asarray(mask), scale=8 ** -0.5))
    args = [torch.from_numpy(x).transpose(1, 2) for x in (q, k, v)]
    for fn in (flash_attention, flash_attention_reference):
        got = fn(*args, torch.from_numpy(mask), causal=True).transpose(1, 2).numpy()
        np.testing.assert_allclose(got[:, :6], np.broadcast_to(v.mean(axis=1, keepdims=True),
                                                               (1, 6, 2, 8)), **F32_TOL)
        np.testing.assert_allclose(got, xla, **F32_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_wrapper_matches_xla_when_a_whole_row_is_masked(causal):
    """A batch row whose keys are all padded: every query row of it has no
    valid key, causal or not."""
    q, k, v, mask = _case(2, 19, 2, 2, 8, [19, 0], seed=7)
    xla = np.asarray(_xla_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                                    k_mask=jnp.asarray(mask), scale=8 ** -0.5))
    got = flash_attention(*(torch.from_numpy(x).transpose(1, 2) for x in (q, k, v)),
                          torch.from_numpy(mask), causal=causal).transpose(1, 2).numpy()
    np.testing.assert_allclose(got, xla, **F32_TOL)



def _interpret_pallas(monkeypatch):
    """Run the JAX package's ``pl.pallas_call`` in interpret mode on the CPU
    (the functions have no interpret flag), the package itself unchanged."""
    monkeypatch.setattr(jax_fa.pl, "pallas_call",
                        functools.partial(jax_fa.pl.pallas_call, interpret=True))


# The port's f32 statement against the Pallas kernel: 5e-7 apart, F32_TOL.
# In bf16 both round p before PV, the kernel against its running max per
# 128-key block, the port against the row's max: 2e-3 to 4e-3 apart, within
# the card tests' tolerance (bf16 outputs, relative step 2^-8).
BF16_TOL = dict(rtol=2e-2, atol=1e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,s,dh,lengths,causal", [
    (2, 2, 300, 32, [300, 173], True),    # three 128-key blocks, ragged right padding
    (2, 2, 300, 32, [211, 0], False),     # a batch row with no valid key
    (1, 2, 600, 16, [455], True),         # five key blocks
    (2, 1, 600, 16, [600, 388], False),
])
def test_flash_plain_matches_pallas_interpret(monkeypatch, dtype, b, h, s, dh, lengths, causal):
    """The online softmax of the JAX kernel crosses several 128-key blocks
    (``block_q=block_kv=128``); the port's plain statement takes one max per row."""
    _interpret_pallas(monkeypatch)
    rng = np.random.default_rng(s + dh + int(causal))
    q, k, v = (rng.normal(size=(b, h, s, dh)).astype(np.float32) for _ in range(3))
    mask = np.arange(s)[None] < np.asarray(lengths)[:, None]
    jd = jnp.dtype(dtype)
    want = np.asarray(jax_fa.flash_attention(
        *(jnp.asarray(x, jd) for x in (q, k, v)), jnp.asarray(mask), causal=causal,
        block_q=128, block_kv=128).astype(jnp.float32))
    td = getattr(torch, dtype)
    got = flash_attention_reference(*(torch.from_numpy(x).to(td) for x in (q, k, v)),
                                    torch.from_numpy(mask), causal=causal).float().numpy()
    # Rows with a valid key: every row of a batch row with a key (right padding).
    rows = np.asarray(lengths) > 0
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got[rows], want[rows], **tol)


@pytest.mark.parametrize("b,h,sq,skv,dh,causal", [
    (2, 2, 37, 37, 16, True),     # lengths off the 16 / 128 paddings
    (1, 2, 20, 20, 8, False),
    (1, 2, 19, 45, 16, True),     # Sq < Skv: causal still counted from position 0
    (1, 1, 50, 30, 8, True),      # Sq > Skv
    (1, 2, 257, 257, 64, False),  # the tower's sequence
    (1, 1, 130, 200, 32, False),
    (1, 2, 40, 700, 16, True),    # Skv > 512: the port's kernel has no length cap either
])
def test_block_plain_matches_pallas_interpret(monkeypatch, b, h, sq, skv, dh, causal):
    """``block_attention`` has no interpret flag: its ``pl.pallas_call`` is run
    in interpret mode for the test, the JAX package itself unchanged."""
    _interpret_pallas(monkeypatch)
    rng = np.random.default_rng(sq + skv)
    q = rng.normal(size=(b, h, sq, dh)).astype(np.float32)
    k, v = (rng.normal(size=(b, h, skv, dh)).astype(np.float32) for _ in range(2))
    want = np.asarray(jax_fa.block_attention(*map(jnp.asarray, (q, k, v)), causal=causal))
    got = block_attention(*map(torch.from_numpy, (q, k, v)), causal=causal).numpy()
    assert got.shape == (b, h, sq, dh)
    np.testing.assert_allclose(got, want, **F32_TOL)
    np.testing.assert_allclose(
        block_attention_reference(*map(torch.from_numpy, (q, k, v)), causal=causal,
                                  scale=0.5).numpy(),
        np.asarray(jax_fa.block_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                                          scale=0.5)), **F32_TOL)


def test_block_wrapper_refuses_devices_without_a_kernel():
    q = torch.empty(1, 1, 4, 64, device="meta")
    with pytest.raises(ValueError, match="bf16 CUDA"):
        block_attention(q, q, q)
