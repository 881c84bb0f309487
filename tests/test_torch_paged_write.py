"""Kernel K5 (the in-place install of the fresh K/V rows into the
token-major int8 pools) and the int8 quantisation helpers of the paged
pools, against the JAX package on the CPU.

K5's plain version must equal the Pallas kernel in interpret mode and the
JAX dynamic-update-slice chain byte for byte outside the trash page (page 0),
where slots that share it may land in any order. The CUDA kernel is held
against the plain version in test_torch_cuda_kernels.py.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas.ops.tpu.paged_attention import quantization_utils as jq  # noqa: E402

from videollamb_tpu.ops import paged_fresh_write as jpfw  # noqa: E402
from videollamb_torch.ops import paged_fresh_write as pfw  # noqa: E402
from videollamb_torch.ops import quantization as q8  # noqa: E402

L, P, PAGE, KD = 2, 9, 16, 256


def _case(seed, b=5):
    rng = np.random.default_rng(seed)
    k = rng.integers(-128, 128, (L, P, PAGE, KD)).astype(np.int8)
    v = rng.integers(-128, 128, (L, P, PAGE, KD)).astype(np.int8)
    fk = rng.integers(-128, 128, (L, b, KD)).astype(np.int8)
    fv = rng.integers(-128, 128, (L, b, KD)).astype(np.int8)
    page = np.asarray([3, 0, 7, 0, 1][:b], np.int32)  # two slots on the trash page
    off = np.asarray([0, 5, PAGE - 1, 9, 8][:b], np.int32)
    return k, v, fk, fv, page, off


@pytest.mark.parametrize("seed", [0, 1])
def test_k5_plain_matches_pallas_interpret_outside_page_0(seed):
    k, v, fk, fv, page, off = _case(seed)
    want = jpfw.paged_fresh_write(*(jnp.asarray(x) for x in (k, v, fk, fv, page, off)),
                                  interpret=True)
    chain = jpfw.paged_fresh_write_xla(*(jnp.asarray(x) for x in (k, v, fk, fv, page, off)))
    tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    got = pfw.paged_fresh_write(tk, tv, *(torch.from_numpy(x) for x in (fk, fv, page, off)))
    assert got[0] is tk and got[1] is tv  # in place
    for g, w, c in zip(got, want, chain):
        np.testing.assert_array_equal(g.numpy()[:, 1:], np.asarray(w)[:, 1:])
        np.testing.assert_array_equal(g.numpy()[:, 1:], np.asarray(c)[:, 1:])
    for i in np.flatnonzero(page != 0):
        np.testing.assert_array_equal(tk.numpy()[:, page[i], off[i]], fk[:, i])
        np.testing.assert_array_equal(tv.numpy()[:, page[i], off[i]], fv[:, i])


def test_quantization_helpers_match_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 3, 64)).astype(np.float32)
    x[0, 0] = 0.0  # an all-zero row: scale 0, quantised values 0
    js = jq.get_quantization_scales(jnp.asarray(x))
    ts = q8.get_quantization_scales(torch.from_numpy(x))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    ji = np.asarray(jq.to_int8(jnp.asarray(x), js))
    ti = q8.to_int8(torch.from_numpy(x), ts)
    assert ti.dtype == torch.int8
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_array_equal(ti.numpy()[0, 0], 0)
    back = q8.from_int8(ti, ts, torch.float32).numpy()
    np.testing.assert_array_equal(back, np.asarray(jq.from_int8(jnp.asarray(ji), js,
                                                                jnp.float32)))


def test_int8_conversion_saturates():
    """A row's absmax element lands on +-127.5 and rounds (half to even)
    to +-128: +128 must saturate to 127 as in JAX, where a bare
    ``.to(torch.int8)`` wraps it to -128."""
    assert int(jnp.int8(jnp.rint(127.5))) == 127
    assert torch.round(torch.tensor(127.5)).to(torch.int8).item() == -128  # the trap
    got = q8.round_to_int8(torch.tensor([127.5, -127.5, 126.5, 300.0, float("nan")]))
    assert got.tolist() == [127, -128, 126, 127, 0]
    row = torch.tensor([[0.25, -0.125, 1.0, 0.5]])  # absmax positive
    quant = q8.to_int8(row, q8.get_quantization_scales(row))
    assert quant.tolist() == [[32, -16, 127, 64]]
    np.testing.assert_array_equal(
        quant.numpy(), np.asarray(jq.to_int8(jnp.asarray(row.numpy()),
                                              jq.get_quantization_scales(jnp.asarray(row.numpy())))))
