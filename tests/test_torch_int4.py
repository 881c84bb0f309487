"""int4 weight-only quantisation of the port against the JAX package, on the CPU.

The same numpy weights go through both packages: the packed nibbles and the
bf16 scales must be equal byte for byte, and the plain version of kernel K7
(``int4_matmul_reference``) must match the Pallas kernel run in interpret
mode. The NF4 load path is checked on hand-built tensors.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from videollamb_tpu.ops import int4_matmul as jx  # noqa: E402
from videollamb_torch.ops import int4_matmul as pt  # noqa: E402


def _bits(a) -> np.ndarray:
    """bf16 (JAX or torch) as its 16-bit patterns."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy()
    return np.asarray(a).view(np.int16)


def test_pack_unpack_equal_jax():
    q = np.random.default_rng(0).integers(-8, 8, size=(64, 24)).astype(np.int8)
    packed = pt.pack_int4(torch.from_numpy(q))
    assert packed.dtype == torch.uint8 and packed.shape == (32, 24)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jx.pack_int4(jnp.asarray(q))))
    np.testing.assert_array_equal(pt.unpack_int4(packed).numpy(), q)
    np.testing.assert_array_equal(pt.unpack_int4(packed).numpy(),
                                  np.asarray(jx.unpack_int4(jnp.asarray(packed.numpy()))))


@pytest.mark.parametrize("k,n,group,scale", [
    (256, 48, 64, 1.0), (128, 32, 128, 0.02), (64, 16, 128, 3.0), (96, 20, 128, 0.5),
    (512, 40, 128, 1e-3),
], ids=["256x48g64", "128x32g128", "64x16shrunk", "96x20shrunk", "512x40small"])
def test_quantize_int4_bytes_equal_jax(k, n, group, scale):
    """q4 and scale byte for byte, including the group-shrinking loop (K = 64
    and 96 cannot hold 128-row groups in each half) and an all-zero column."""
    w = (np.random.default_rng(k + n).normal(size=(k, n)) * scale).astype(np.float32)
    w[:, 3] = 0.0
    want = jx.quantize_int4(jnp.asarray(w), group=group)
    got = pt.quantize_int4(torch.from_numpy(w), group=group)
    assert got["q4"].dtype == torch.uint8 and got["scale"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["q4"].numpy(), np.asarray(want["q4"]))
    np.testing.assert_array_equal(_bits(got["scale"]), _bits(want["scale"]))
    assert k // got["scale"].shape[0] == int(want["group"])
    # The dense weight rebuilt from them is the same too (f32: exact products).
    np.testing.assert_array_equal(
        pt.dequantize_int4(got, torch.float32).numpy(),
        np.asarray(jx.dequantize_int4(want, jnp.float32)))


def test_quantize_int4_from_bf16_weights_equal_jax():
    w = np.random.default_rng(5).normal(size=(128, 24)).astype(np.float32)
    wj = jnp.asarray(w).astype(jnp.bfloat16)
    wt = torch.from_numpy(w).to(torch.bfloat16)
    want, got = jx.quantize_int4(wj, group=32), pt.quantize_int4(wt, group=32)
    np.testing.assert_array_equal(got["q4"].numpy(), np.asarray(want["q4"]))
    np.testing.assert_array_equal(_bits(got["scale"]), _bits(want["scale"]))


# f32 sums of at most 256 products taken in another order than the Pallas
# kernel's dot: the JAX test's own tolerance.
K7_TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("m,k,n,group,block_n", [
    (8, 128, 32, 32, 16), (8, 256, 48, 64, 48), (16, 64, 16, 16, 16),
    (1, 128, 32, 32, 16), (8, 128, 40, 32, 16),
], ids=["8x128x32", "8x256x48", "16x64x16", "m1", "ragged-n"])
def test_int4_matmul_reference_matches_pallas_interpret(m, k, n, group, block_n):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.normal(size=(k, n)).astype(np.float32)
    qk = pt.quantize_int4(torch.from_numpy(w), group=group)
    pad = (-m) % 8  # the JAX caller pads M to the sublane tile
    want = jx.int4_matmul(jnp.asarray(np.pad(x, ((0, pad), (0, 0)))),
                          jnp.asarray(qk["q4"].numpy()),
                          jnp.asarray(_bits(qk["scale"])).view(jnp.bfloat16),
                          block_n=block_n, interpret=True)[:m]
    got = pt.int4_matmul_reference(torch.from_numpy(x), qk["q4"], qk["scale"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **K7_TOL)
    # The wrapper takes the plain version for a CPU tensor and counts no launch.
    before = pt.int4_matmul.launches
    via_wrapper = pt.int4_matmul(torch.from_numpy(x), qk["q4"], qk["scale"])
    assert torch.equal(via_wrapper, got) and pt.int4_matmul.launches == before
    # And it agrees with the dequantise-then-multiply route of large M.
    dense = torch.from_numpy(x) @ pt.dequantize_int4(qk, torch.float32)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), **K7_TOL)


def test_int4_matmul_reference_bf16_applies_the_scale_after_the_group_sum():
    """In bf16 the kernel's order (sum the group in f32, then scale) differs from
    rounding q * scale to bf16 first; the plain version states the former."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(4, 128)).astype(np.float32)).to(torch.bfloat16)
    qk = pt.quantize_int4(torch.from_numpy(rng.normal(size=(128, 16)).astype(np.float32)), 32)
    got = pt.int4_matmul_reference(x, qk["q4"], qk["scale"])
    assert got.dtype == torch.bfloat16
    nib = pt.unpack_int4(qk["q4"]).float().reshape(4, 32, 16)
    want = torch.einsum("mgr,grn->gmn", x.float().reshape(4, 4, 32), nib)
    want = (want * qk["scale"].float()[:, None]).sum(0)
    # One bf16 rounding of the f32 sum; groups added in another order.
    np.testing.assert_allclose(got.float().numpy(), want.to(torch.bfloat16).float().numpy(),
                               rtol=2 ** -7, atol=1e-6)


def test_int4_matmul_refuses_what_the_kernel_does_not_take():
    x = torch.zeros((2, 64))
    qk = pt.quantize_int4(torch.ones((64, 8)), 32)
    with pytest.raises(ValueError, match="int4 matmul kernel takes"):
        pt.int4_matmul(x.to("meta"), qk["q4"].to("meta"), qk["scale"].to("meta"))


def test_dequantize_nf4_equal_jax():
    from videollamb_tpu.models.lm.quant import NF4_CODE as JCODE
    from videollamb_tpu.models.lm.quant import dequantize_nf4 as jax_nf4
    from videollamb_torch.models.lm.quant import NF4_CODE, dequantize_nf4

    np.testing.assert_array_equal(NF4_CODE.numpy(), np.asarray(JCODE))
    codes = np.array([0, 15, 7, 8, 3, 12, 1, 14], np.uint8)
    packed = (codes[0::2] << 4) | codes[1::2]  # high nibble first
    absmax = np.array([2.0, 0.5], np.float32)  # blocksize 4
    got = dequantize_nf4(packed, absmax, shape=(2, 4), blocksize=4, dtype=torch.float32)
    want = np.asarray(jax_nf4(packed, absmax, shape=(2, 4), blocksize=4, dtype=jnp.float32))
    np.testing.assert_array_equal(got.numpy(), want)
    expected = np.asarray(JCODE)[codes] * np.repeat(absmax, 4)
    np.testing.assert_allclose(got.numpy(), expected.reshape(2, 4).T, rtol=1e-6)


def test_load_nf4_state_dict_equal_jax():
    from videollamb_tpu.models.lm.quant import load_nf4_state_dict as jax_load
    from videollamb_torch.models.lm.quant import load_nf4_state_dict, quantize_kernel_int4

    rng = np.random.default_rng(4)
    codes = rng.integers(0, 16, size=64 * 32).astype(np.uint8)
    state = {
        "model.layers.0.mlp.up_proj.weight": (codes[0::2] << 4) | codes[1::2],
        "model.layers.0.mlp.up_proj.weight.absmax": rng.uniform(0.1, 2.0, 32).astype(np.float32),
        "model.layers.0.mlp.up_proj.weight.shape": np.array([32, 64]),
        "model.layers.0.mlp.up_proj.weight.quant_map": np.zeros(16, np.float32),
        "model.norm.weight": np.ones(64, np.float32),
    }
    got = load_nf4_state_dict(state, dtype=torch.float32)
    want = jax_load(state, dtype=jnp.float32)
    assert set(got) == set(want) == {"model.layers.0.mlp.up_proj.weight", "model.norm.weight"}
    w = got["model.layers.0.mlp.up_proj.weight"]
    assert w.shape == (64, 32)  # (d_in, d_out): ready for the int4 quantiser
    np.testing.assert_array_equal(w.numpy(),
                                  np.asarray(want["model.layers.0.mlp.up_proj.weight"]))
    assert got["model.norm.weight"] is state["model.norm.weight"]
    assert quantize_kernel_int4(w, 32)["q4"].shape == (32, 32)
