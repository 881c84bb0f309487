"""Kernels K2, K9 and K10 (temporal attention in its three layouts): the
port's plain cores against the JAX Pallas kernels in interpret mode, both
temporal branches against ``temporal_attention_reference``, and the
branches' gradients (x, the temporal embedding, LayerNorm and all four
projections) against ``jax.grad`` of that reference, which is what the JAX
``custom_vjp`` rules' backward computes (the JAX tests never differentiate
through the frame-major op itself). The CUDA kernels are held against the
plain cores in test_torch_cuda_kernels.py."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch import nn

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from videollamb_tpu.ops import temporal_attention as jax_ta  # noqa: E402
from videollamb_torch.models.vision.clip_vit import CLIPAttention  # noqa: E402
from videollamb_torch.ops.temporal_attention import (  # noqa: E402
    _ln_qkv,
    _ln_qkv_fm,
    fused_temporal_core,
    fused_temporal_core_fm,
    fused_temporal_core_fm3,
    temporal_attention,
    temporal_attention_fm,
    temporal_attention_reference,
)

F32_TOL = dict(rtol=1e-5, atol=1e-5)


def _packed_qkv(b, t, n, h, e, seed):
    rng = np.random.default_rng(seed)
    d = h * e
    q = rng.normal(size=(b, t, n, d)).astype(np.float32) * e ** -0.5
    kv = rng.normal(size=(b, t, n, 2 * d)).astype(np.float32)
    return np.concatenate([q, kv], axis=-1)


@pytest.mark.parametrize("b,t,n,h,e,block_n", [
    (2, 8, 9, 4, 8, 4),    # n not a multiple of the TPU kernel's block
    (1, 8, 37, 2, 16, 32),
    (1, 4, 5, 2, 8, 4),    # a shorter window
])
def test_plain_core_matches_pallas_interpret(b, t, n, h, e, block_n):
    qkv = _packed_qkv(b, t, n, h, e, seed=n)
    want = np.asarray(jax_ta.fused_temporal_core_fm3(jnp.asarray(qkv), num_heads=h,
                                                     block_n=block_n, interpret=True))
    got = fused_temporal_core_fm3(torch.from_numpy(qkv), num_heads=h)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


def _branch_params(d, seed):
    rng = np.random.default_rng(seed)

    def dense():
        return {"kernel": rng.normal(size=(d, d)).astype(np.float32) * d ** -0.5,
                "bias": rng.normal(size=(d,)).astype(np.float32) * 0.1}

    ln = {"scale": 1.0 + 0.1 * rng.normal(size=(d,)).astype(np.float32),
          "bias": 0.1 * rng.normal(size=(d,)).astype(np.float32)}
    attn = {name: dense() for name in ("q_proj", "k_proj", "v_proj", "out_proj")}
    temb = rng.normal(size=(8, d)).astype(np.float32) * d ** -0.5
    return ln, attn, temb


def _port_modules(ln, attn, d):
    torch_ln = nn.LayerNorm(d)
    torch_attn = CLIPAttention(d)
    with torch.no_grad():
        torch_ln.weight.copy_(torch.from_numpy(ln["scale"]))
        torch_ln.bias.copy_(torch.from_numpy(ln["bias"]))
        for name, p in attn.items():
            getattr(torch_attn, name).weight.copy_(torch.from_numpy(p["kernel"].T))
            getattr(torch_attn, name).bias.copy_(torch.from_numpy(p["bias"]))
    return torch_ln, torch_attn


@pytest.mark.parametrize("b,t,n,h,d", [(2, 8, 5, 4, 32), (1, 8, 17, 2, 16)])
def test_temporal_branch_matches_reference(b, t, n, h, d):
    ln, attn, temb = _branch_params(d, seed=d + n)
    x = np.random.default_rng(n).normal(size=(b, n, t, d)).astype(np.float32)  # (b, n, t, d)
    want = np.asarray(jax_ta.temporal_attention_reference(
        jnp.asarray(x), jnp.asarray(temb), jax.tree.map(jnp.asarray, ln),
        jax.tree.map(jnp.asarray, attn), num_heads=h))
    torch_ln, torch_attn = _port_modules(ln, attn, d)
    xt = torch.from_numpy(x)
    temb_t = torch.from_numpy(temb)
    with torch.no_grad():
        ref = temporal_attention_reference(xt, temb_t, torch_ln, torch_attn, num_heads=h)
        fm = temporal_attention_fm(xt.transpose(1, 2), temb_t, torch_ln, torch_attn, h)
    np.testing.assert_allclose(ref.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(fm.transpose(1, 2).numpy(), want, rtol=1e-4, atol=1e-4)



def _three(shape, seed, e):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    return q * e ** -0.5, k, v


@pytest.mark.parametrize("b,n,t,h,e,block_n,group", [
    (1, 7, 4, 4, 8, 4, 2),     # the JAX test's blocks: n = 7, block_n = 4, group = 2
    (2, 9, 8, 2, 16, 32, 16),  # production t = 8, one n-block
    (1, 5, 2, 2, 8, 8, 16),
])
def test_bntd_plain_core_matches_pallas_interpret(b, n, t, h, e, block_n, group):
    q, k, v = _three((b, n, t, h * e), seed=n + t, e=e)
    want = np.asarray(jax_ta.fused_temporal_core(
        *map(jnp.asarray, (q, k, v)), num_heads=h, block_n=block_n, group=group,
        interpret=True))
    got = fused_temporal_core(*map(torch.from_numpy, (q, k, v)), num_heads=h)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("b,t,n,h,e,block_n", [
    (2, 4, 9, 4, 8, 4),    # ragged n: the last n-block is padded
    (1, 8, 16, 4, 8, 8),
    (3, 2, 5, 2, 8, 8),    # block_n > n clamp
    (1, 8, 12, 8, 8, 5),   # padded last block at t = 8
])
def test_fm_plain_core_matches_pallas_interpret(b, t, n, h, e, block_n):
    q, k, v = _three((b, t, n, h * e), seed=b * 31 + n, e=e)
    want = np.asarray(jax_ta.fused_temporal_core_fm(
        *map(jnp.asarray, (q, k, v)), num_heads=h, block_n=block_n, interpret=True))
    got = fused_temporal_core_fm(*map(torch.from_numpy, (q, k, v)), num_heads=h)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("fm", [False, True])
def test_ln_qkv_prologues_match_jax(fm):
    d, b, t, n = 16, 2, 8, 5
    ln, attn, temb = _branch_params(d, seed=3)
    shape = (b, t, n, d) if fm else (b, n, t, d)
    x = np.random.default_rng(4).normal(size=shape).astype(np.float32)
    jax_fn = jax_ta._ln_qkv_fm if fm else jax_ta._ln_qkv
    want = jax_fn(jnp.asarray(x), jnp.asarray(temb), jax.tree.map(jnp.asarray, ln),
                  jax.tree.map(jnp.asarray, attn), 1e-5)
    torch_ln, torch_attn = _port_modules(ln, attn, d)
    with torch.no_grad():
        got = (_ln_qkv_fm if fm else _ln_qkv)(torch.from_numpy(x), torch.from_numpy(temb),
                                              torch_ln, torch_attn, 1e-5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def test_bntd_branch_matches_reference():
    b, t, n, h, d = 2, 8, 5, 4, 32
    ln, attn, temb = _branch_params(d, seed=11)
    x = np.random.default_rng(12).normal(size=(b, n, t, d)).astype(np.float32)
    want = np.asarray(jax_ta.temporal_attention_reference(
        jnp.asarray(x), jnp.asarray(temb), jax.tree.map(jnp.asarray, ln),
        jax.tree.map(jnp.asarray, attn), num_heads=h))
    torch_ln, torch_attn = _port_modules(ln, attn, d)
    with torch.no_grad():
        got = temporal_attention(torch.from_numpy(x), torch.from_numpy(temb), torch_ln,
                                 torch_attn, h)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("fm", [False, True])
def test_branch_grads_match_jax_reference(fm):
    """Gradients of sum(out * g) with respect to x, the temporal embedding, the
    LayerNorm and every projection, for the (b, n, t, d) branch (K9's op) and
    the frame-major one (K2's op), against jax.vjp of the reference."""
    b, t, n, h, d = 2, 8, 5, 4, 32
    ln, attn, temb = _branch_params(d, seed=21)
    rng = np.random.default_rng(22)
    x = rng.normal(size=(b, n, t, d)).astype(np.float32)
    g = rng.normal(size=(b, n, t, d)).astype(np.float32)

    def ref(x, temb, ln, attn):
        return jax_ta.temporal_attention_reference(x, temb, ln, attn, num_heads=h)

    _, vjp = jax.vjp(ref, jnp.asarray(x), jnp.asarray(temb), jax.tree.map(jnp.asarray, ln),
                     jax.tree.map(jnp.asarray, attn))
    gx, gtemb, gln, gattn = vjp(jnp.asarray(g))

    torch_ln, torch_attn = _port_modules(ln, attn, d)
    xt = torch.from_numpy(x).requires_grad_(True)
    temb_t = torch.from_numpy(temb).requires_grad_(True)
    if fm:
        out = temporal_attention_fm(xt.transpose(1, 2), temb_t, torch_ln, torch_attn,
                                    h).transpose(1, 2)
    else:
        out = temporal_attention(xt, temb_t, torch_ln, torch_attn, h)
    out.backward(torch.from_numpy(g))
    tol = dict(rtol=1e-4, atol=1e-4)  # f32 through LN, four projections and a softmax
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **tol)
    np.testing.assert_allclose(temb_t.grad.numpy(), np.asarray(gtemb), **tol)
    np.testing.assert_allclose(torch_ln.weight.grad.numpy(), np.asarray(gln["scale"]), **tol)
    np.testing.assert_allclose(torch_ln.bias.grad.numpy(), np.asarray(gln["bias"]), **tol)
    for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
        mod = getattr(torch_attn, name)
        np.testing.assert_allclose(mod.weight.grad.numpy().T,
                                   np.asarray(gattn[name]["kernel"]), **tol)
        np.testing.assert_allclose(mod.bias.grad.numpy(), np.asarray(gattn[name]["bias"]),
                                   **tol)


def test_core_wrappers_refuse_devices_without_a_kernel():
    x = torch.empty(1, 8, 3, 64, device="meta")
    for fn in (fused_temporal_core, fused_temporal_core_fm):
        with pytest.raises(ValueError, match="bf16 CUDA"):
            fn(x, x, x, num_heads=1)
