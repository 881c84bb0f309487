"""int8 and int4 LM weights of the port against the JAX package, on the CPU in f32.

- ``quantize_kernel`` / ``quantize_kernel_int4`` give the JAX package's
  integers and bf16 scales byte for byte.
- A quantised JAX LM tree crosses ``from_jax_params`` bit for bit; prefill
  and four decode steps on it give the JAX functions' logits and greedy
  tokens.
- ``quantize_llama_params*`` on the port's own modules give the same model
  as the converted JAX tree and free the weights they replace.
"""

from __future__ import annotations

import copy
import gc
import weakref

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from test_torch_parity_utils import np_tree, port_config  # noqa: E402

from videollamb_tpu.config import LlamaConfig  # noqa: E402
from videollamb_tpu.models.lm import quant as jq  # noqa: E402
from videollamb_torch.models.lm import quant as pq  # noqa: E402

CFG = LlamaConfig.tiny()
# f32 activations through two layers; the dequantised weights are equal bit
# for bit, the products are summed in another order than XLA's.
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
QUANTIZERS = {"int8": (jq.quantize_llama_params, pq.quantize_llama_params),
              "int4": (jq.quantize_llama_params_int4, pq.quantize_llama_params_int4)}


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy()
    return np.asarray(a).view(np.int16)


@pytest.mark.parametrize("shape", [(64, 48), (3, 32, 24)], ids=["2d", "stacked"])
def test_quantize_kernel_bytes_equal_jax(shape):
    w = np.random.default_rng(0).normal(size=shape).astype(np.float32) * 0.05
    w[..., 5] = 0.0  # an all-zero output channel: the scale floor
    want, got = jq.quantize_kernel(jnp.asarray(w)), pq.quantize_kernel(torch.from_numpy(w))
    assert got["q"].dtype == torch.int8 and got["scale"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(_bits(got["scale"]), _bits(want["scale"]))
    assert int(got["q"].abs().max()) == 127
    np.testing.assert_array_equal(
        pq.dequantize_kernel(got, torch.float32).numpy(),
        np.asarray(jq.dequantize_kernel(want, jnp.float32)))
    assert pq.is_quantized(got) and not pq.is_int4(got)


def test_quantize_kernel_int4_stacked_bytes_equal_jax():
    w = np.random.default_rng(1).normal(size=(2, 64, 24)).astype(np.float32)
    want = jq.quantize_kernel_int4(jnp.asarray(w), group=32)
    got = pq.quantize_kernel_int4(torch.from_numpy(w), group=32)
    np.testing.assert_array_equal(got["q4"].numpy(), np.asarray(want["q4"]))
    np.testing.assert_array_equal(_bits(got["scale"]), _bits(want["scale"]))
    assert pq.is_int4(got) and not pq.is_quantized(got)


def _jax_lm(seed: int = 0):
    from videollamb_tpu.models.lm.llama import init_llama_params

    return init_llama_params(jax.random.PRNGKey(seed), CFG)


def _port_lm(tree):
    """The port's LM holding a (possibly quantised) JAX LM tree."""
    from videollamb_torch.models.convert import from_jax_params, load_converted_state
    from videollamb_torch.models.lm.llama import LlamaForCausalLM

    lm = LlamaForCausalLM(port_config_lm())
    load_converted_state(lm, from_jax_params({"lm": np_tree(tree)}), prefix="lm.")
    return lm.eval()


def port_config_lm():
    from videollamb_tpu.config import ModelConfig

    return port_config(ModelConfig.tiny()).lm


@pytest.fixture(scope="module", params=["int8", "int4"])
def quantized(request):
    jax_quantize, _ = QUANTIZERS[request.param]
    params = jax_quantize(jax.tree.map(jnp.array, _jax_lm()))
    return request.param, params, _port_lm(params)


def test_from_jax_params_carries_quantised_kernels_bit_for_bit(quantized):
    kind, params, lm = quantized
    key = "q4" if kind == "int4" else "q"
    for i, layer in enumerate(lm.model.layers):
        for parent, name in ((layer.self_attn, "o_proj"), (layer.mlp, "down_proj")):
            module = getattr(parent, name)
            assert isinstance(module, pq.QuantLinear) and module.kind == kind
            assert getattr(module, key).dtype == (torch.uint8 if kind == "int4" else torch.int8)
            assert module.scale.dtype == torch.bfloat16
            np.testing.assert_array_equal(getattr(module, key).numpy(),
                                          np.asarray(params["layers"][name][key][i]))
            np.testing.assert_array_equal(_bits(module.scale),
                                          _bits(params["layers"][name]["scale"][i]))
    np.testing.assert_array_equal(getattr(lm.lm_head, key).numpy(),
                                  np.asarray(params["lm_head"][key]))
    assert lm.model.embed_tokens.weight.dtype == torch.float32  # the table stays plain


def test_prefill_and_decode_match_jax(quantized):
    from videollamb_tpu.models.lm import llama as jl
    from videollamb_torch.models.lm import llama as pl

    _, params, lm = quantized
    cfg = port_config_lm()
    prompt = np.random.default_rng(3).integers(4, CFG.vocab_size, size=(2, 12)).astype(np.int32)
    mask = np.ones_like(prompt)
    mask[1, 9:] = 0

    jcache = jl.init_kv_cache(CFG, 2, 32, jnp.float32)
    jlogits, jcache = jl.llama_prefill(
        params, CFG, jl.embed_tokens(params, jnp.asarray(prompt)), jnp.asarray(mask), jcache)
    cache = pl.init_kv_cache(cfg, 2, 32, dtype=torch.float32)
    logits, cache = pl.llama_prefill(lm, cfg, pl.embed_tokens(lm, torch.from_numpy(prompt)),
                                     torch.from_numpy(mask), cache)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **LOGIT_TOL)
    for _ in range(4):
        jnxt = jnp.argmax(jlogits, -1)
        nxt = torch.argmax(logits, dim=-1)
        np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))
        jlogits, jcache = jl.llama_decode_step(
            params, CFG, jl.embed_tokens(params, jnxt[:, None]), jcache)
        logits, cache = pl.llama_decode_step(lm, cfg, pl.embed_tokens(lm, nxt[:, None]), cache)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **LOGIT_TOL)


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_quantize_llama_params_equals_the_converted_jax_tree(kind):
    """Quantising the port's own modules gives the integers and scales that the
    JAX quantiser gives on the same weights, and frees what it replaces."""
    jax_quantize, port_quantize = QUANTIZERS[kind]
    tree = _jax_lm(seed=1)
    plain = _port_lm(tree)
    weights = [weakref.ref(m.weight) for m in plain.modules() if isinstance(m, torch.nn.Linear)]
    assert len(weights) == 7 * CFG.num_hidden_layers + 1
    before = pq.linear_weight_bytes(plain)
    out = port_quantize(plain)
    assert out is plain  # in place
    gc.collect()
    assert all(ref() is None for ref in weights)  # every replaced weight is freed
    assert not [m for m in plain.modules() if isinstance(m, torch.nn.Linear)]
    assert not [name for name, _ in plain.named_parameters() if "proj" in name or "head" in name]
    want = _port_lm(jax_quantize(jax.tree.map(jnp.array, tree))).state_dict()
    got = plain.state_dict()
    assert set(got) == set(want)
    # The kernel takes contiguous buffers: an nn.Linear weight is quantised
    # through its transposed view, whose strides must not be handed on.
    assert all(t.is_contiguous() for t in got.values())
    for name, tensor in got.items():
        assert tensor.dtype == want[name].dtype, name
        assert torch.equal(tensor.view(torch.int16) if tensor.dtype == torch.bfloat16 else tensor,
                           want[name].view(torch.int16) if tensor.dtype == torch.bfloat16
                           else want[name]), name
    # int8 is a byte and a bit per weight of f32's four; int4 half of that.
    ratio = pq.linear_weight_bytes(plain) / before
    assert ratio < (0.27 if kind == "int8" else 0.16), ratio
    # A second pass finds nothing left to quantise.
    state = copy.deepcopy(plain.state_dict())
    port_quantize(plain)
    assert all(torch.equal(v.view(torch.uint8), state[k].view(torch.uint8))
               for k, v in plain.state_dict().items())


def test_project_routes():
    """int8: dequantise in x's type, then the product; int4 on the CPU: the
    dequantise route for any M (the kernel route is the card's)."""
    from videollamb_torch.ops.int4_matmul import dequantize_int4, int4_matmul

    rng = np.random.default_rng(6)
    w = torch.from_numpy(rng.normal(size=(64, 24)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(2, 3, 64)).astype(np.float32))
    k8, k4 = pq.quantize_kernel(w), pq.quantize_kernel_int4(w, 32)
    np.testing.assert_array_equal(pq.project(k8, x).numpy(),
                                  (x @ (k8["q"].float() * k8["scale"].float())).numpy())
    before = int4_matmul.launches
    np.testing.assert_array_equal(pq.project(k4, x).numpy(),
                                  (x @ dequantize_int4(k4, torch.float32)).numpy())
    assert int4_matmul.launches == before
    xb = x.to(torch.bfloat16)
    want = xb @ (k8["q"].to(torch.bfloat16) * k8["scale"])  # the product of bf16 operands
    assert torch.equal(pq.QuantLinear(k8)(xb), want)
