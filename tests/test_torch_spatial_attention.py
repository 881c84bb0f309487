"""Kernels K1 (packed spatial attention) and K8 (the split (B, H, N, e)
layout): the port's plain versions against the JAX package's Pallas kernels
in interpret mode and their XLA statements; the differentiable ops
``spatial_core`` and ``spatial_core_packed`` against ``jax.grad`` of those
statements (the backward of the JAX ``custom_vjp`` rules). The CUDA kernels
are held against the plain versions in test_torch_cuda_kernels.py."""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from videollamb_tpu.ops import spatial_attention as jax_sa  # noqa: E402
from videollamb_torch.ops.spatial_attention import (  # noqa: E402
    fused_spatial_core,
    fused_spatial_core_packed,
    spatial_core,
    spatial_core_packed,
)

F32_TOL = dict(rtol=2e-5, atol=2e-5)  # f32, same math, different summation order


def _qkv(b, n, h, e, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, n, h * e)).astype(np.float32) * e ** -0.5
    k = rng.normal(size=(b, n, h * e)).astype(np.float32)
    v = rng.normal(size=(b, n, h * e)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("b,n,h,e", [(2, 9, 4, 8), (1, 257, 2, 16), (3, 17, 4, 64)])
def test_plain_matches_pallas_interpret_and_xla(b, n, h, e):
    q, k, v = _qkv(b, n, h, e, seed=n)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    pallas = np.asarray(jax_sa.fused_spatial_core_packed(jq, jk, jv, heads=h, interpret=True))
    xla = np.asarray(jax_sa._xla_core_packed(jq, jk, jv, h))
    got = fused_spatial_core_packed(*map(torch.from_numpy, (q, k, v)), heads=h)
    np.testing.assert_allclose(got.numpy(), pallas, **F32_TOL)
    np.testing.assert_allclose(got.numpy(), xla, **F32_TOL)


def test_wrapper_refuses_devices_without_a_kernel():
    q = torch.empty(1, 4, 64, device="meta")
    with pytest.raises(ValueError, match="bf16 CUDA"):
        fused_spatial_core_packed(q, q, q, heads=1)



@pytest.mark.parametrize("b,h,n,e,hb", [
    (2, 4, 9, 8, 2),   # odd sequence length
    (1, 8, 16, 8, 8),
    (3, 2, 5, 4, 8),   # hb > h after the clamp
    (2, 2, 257, 64, 16),
])
def test_split_plain_matches_pallas_interpret_and_xla(b, h, n, e, hb):
    rng = np.random.default_rng(b * 10 + h)
    q, k, v = (rng.normal(size=(b, h, n, e)).astype(np.float32) for _ in range(3))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    pallas = np.asarray(jax_sa.fused_spatial_core(jq, jk, jv, heads_per_block=hb,
                                                  interpret=True))
    xla = np.asarray(jax_sa._xla_core(jq, jk, jv))
    got = fused_spatial_core(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), pallas, **F32_TOL)
    np.testing.assert_allclose(got.numpy(), xla, **F32_TOL)


def _grads_against_jax(port_fn, jax_fn, inputs, cotangent):
    """VJP of the port's op at ``cotangent`` against jax.vjp of the JAX statement."""
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in inputs]
    out = port_fn(*leaves)
    out.backward(torch.from_numpy(cotangent))
    want_out, vjp = jax.vjp(jax_fn, *map(jnp.asarray, inputs))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), **F32_TOL)
    for got, want in zip(leaves, vjp(jnp.asarray(cotangent))):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("b,h,n,e", [(2, 4, 9, 8), (1, 2, 33, 16)])
def test_spatial_core_grads_match_jax(b, h, n, e):
    rng = np.random.default_rng(n)
    q, k, v, g = (rng.normal(size=(b, h, n, e)).astype(np.float32) for _ in range(4))
    _grads_against_jax(spatial_core, jax_sa._xla_core, (q * e ** -0.5, k, v), g)


@pytest.mark.parametrize("b,n,h,e", [(2, 9, 4, 8), (1, 17, 2, 16)])
def test_spatial_core_packed_grads_match_jax(b, n, h, e):
    q, k, v = _qkv(b, n, h, e, seed=n + 1)
    g = np.random.default_rng(n).normal(size=q.shape).astype(np.float32)
    _grads_against_jax(lambda *a: spatial_core_packed(*a, h),
                       lambda *a: jax_sa._xla_core_packed(*a, h), (q, k, v), g)


def test_split_wrapper_refuses_devices_without_a_kernel():
    q = torch.empty(1, 1, 4, 64, device="meta")
    with pytest.raises(ValueError, match="bf16 CUDA"):
        fused_spatial_core(q, q, q)
