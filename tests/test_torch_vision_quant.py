"""The int8 vision tower of the port against the JAX package, on the CPU in f32.

``dense_int8`` (dynamic per-row activation scales, int8 x int8 -> int32, f32
dequantisation and bias) is held against JAX's on the same operands, the
quantised tree crosses ``from_jax_params`` bit for bit, and the quantised
tower is compared end to end, patch embedding included.
"""

from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from test_torch_parity_utils import jax_params, np_tree, port_config  # noqa: E402

from videollamb_tpu.config import ModelConfig  # noqa: E402
from videollamb_tpu.models.vision import quant as jvq  # noqa: E402
from videollamb_torch.models.vision import quant as pvq  # noqa: E402

CFG = ModelConfig.tiny()


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy()
    return np.asarray(a).view(np.int16)


@pytest.mark.parametrize("shape,bias", [((5, 7, 64), True), ((3, 588), False), ((1, 40), True)],
                         ids=["3d", "patch-width", "one-row"])
def test_dense_int8_matches_jax(shape, bias):
    from videollamb_tpu.models.lm.quant import quantize_kernel as jax_quantize
    from videollamb_torch.models.lm.quant import quantize_kernel

    rng = np.random.default_rng(sum(shape))
    x = rng.normal(size=shape).astype(np.float32)
    x[0, ..., :] *= 30.0  # rows of very different ranges: per-row scales matter
    w = rng.normal(size=(shape[-1], 24)).astype(np.float32) * 0.1
    b = rng.normal(size=(24,)).astype(np.float32) if bias else None
    jk, pk = jax_quantize(jnp.asarray(w)), quantize_kernel(torch.from_numpy(w))
    p = {"kernel": jk, **({"bias": jnp.asarray(b)} if bias else {})}
    want = np.asarray(jvq.dense_int8(p, jnp.asarray(x)))
    got = pvq.dense_int8(pk, torch.from_numpy(x), torch.from_numpy(b) if bias else None)
    # Equal int32 sums; the f32 dequantisation multiplies in the same order.
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)

    # The integer side on its own: the activations' int8 values equal JAX's
    # formula, and the int32 product is exact.
    xf = jnp.asarray(x)
    sx = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True) / 127.0, 1e-8)
    qx = np.asarray(jnp.clip(jnp.round(xf / sx), -127, 127).astype(jnp.int8))
    xt = torch.from_numpy(x)
    sxt = (xt.abs().amax(-1, keepdim=True) / torch.tensor(127.0)).clamp_min(1e-8)
    qxt = torch.round(xt / sxt).clamp(-127, 127).to(torch.int8)
    np.testing.assert_array_equal(qxt.numpy(), qx)
    acc = pvq.int8_matmul(qxt.reshape(-1, shape[-1]), pk["q"])
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(
        acc.numpy(), qx.reshape(-1, shape[-1]).astype(np.int32) @ np.asarray(jk["q"], np.int32))


@pytest.fixture(scope="module")
def towers():
    """(JAX int8 tower tree, port int8 tower from the converted tree, port int8
    tower quantised by the port itself)."""
    from videollamb_torch.models.convert import from_jax_params, load_converted_state
    from videollamb_torch.models.vision.clip_vit import CLIPVisionTower

    tree = jax_params(CFG, seed=11)["video_tower"]
    jtree = jvq.quantize_vision_params(jax.tree.map(jnp.asarray, copy.deepcopy(tree)))
    vision = port_config(CFG).vision
    converted = CLIPVisionTower(vision)
    load_converted_state(converted, from_jax_params({"video_tower": np_tree(jtree)}),
                         prefix="video_tower.")
    own = CLIPVisionTower(vision)
    load_converted_state(own, from_jax_params({"video_tower": tree}), prefix="video_tower.")
    own = pvq.quantize_vision_params(own)
    return jtree, converted.eval(), own.eval()


def test_quantised_tower_crosses_bit_for_bit(towers):
    jtree, converted, own = towers
    a, b = converted.state_dict(), own.state_dict()
    assert set(a) == set(b)
    quantised = [k for k in a if k.endswith(".q")]
    # 4 + 4 attention projections and 2 MLP layers per layer, and the patch embedding.
    assert len(quantised) == 10 * CFG.vision.num_hidden_layers + 1
    for name in a:
        assert a[name].dtype == b[name].dtype, name
        same = (torch.equal(a[name].view(torch.int16), b[name].view(torch.int16))
                if a[name].dtype == torch.bfloat16 else torch.equal(a[name], b[name]))
        assert same, name
    layer0 = jtree["layers"][0]["mlp"]["fc1"]["kernel"]
    fc1 = converted.vision_model.encoder.layers[0].mlp.fc1
    assert isinstance(fc1, pvq.Int8Dense) and fc1.q.dtype == torch.int8
    np.testing.assert_array_equal(fc1.q.numpy(), np.asarray(layer0["q"]))
    np.testing.assert_array_equal(_bits(fc1.scale), _bits(layer0["scale"]))
    patch = converted.vision_model.embeddings.patch_embedding
    assert isinstance(patch, pvq.Int8Dense) and patch.bias is None
    assert not [k for k in a if "proj.weight" in k or "fc1.weight" in k]


@pytest.mark.parametrize("frames", [8, 1], ids=["video", "image"])
def test_quantised_tower_matches_jax(towers, frames):
    """End to end. The port fuses the temporal q/k/v projections into one int8
    product (the JAX package's route on the TPU) while JAX on the CPU runs
    three: the int32 sums are equal and only the f32 epilogues round
    differently, so the features agree to the f32 tolerance of the plain
    tower's test (measured: 1e-6 of a range of 5)."""
    from videollamb_tpu.models.vision.clip_vit import vision_encode as jax_encode
    from videollamb_torch.models.vision.clip_vit import vision_encode

    jtree, converted, own = towers
    img = CFG.vision.image_size
    pixels = np.random.default_rng(frames).normal(size=(2, frames, 3, img, img)).astype(np.float32)
    want = np.asarray(jax_encode(jtree, jnp.asarray(pixels), CFG.vision))
    with torch.no_grad():
        got = vision_encode(converted, torch.from_numpy(pixels), port_config(CFG).vision)
        again = vision_encode(own, torch.from_numpy(pixels), port_config(CFG).vision)
    assert got.shape == want.shape and torch.equal(got, again)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_quantised_tower_stays_close_to_the_plain_tower(towers):
    from videollamb_torch.models.convert import from_jax_params, load_converted_state
    from videollamb_torch.models.vision.clip_vit import CLIPVisionTower, vision_encode

    _, _, own = towers
    vision = port_config(CFG).vision
    plain = CLIPVisionTower(vision)
    load_converted_state(plain, from_jax_params(
        {"video_tower": jax_params(CFG, seed=11)["video_tower"]}), prefix="video_tower.")
    img = CFG.vision.image_size
    pixels = torch.from_numpy(
        np.random.default_rng(2).normal(size=(1, 8, 3, img, img)).astype(np.float32))
    with torch.no_grad():
        a, b = vision_encode(plain.eval(), pixels, vision), vision_encode(own, pixels, vision)
    rel = float((a - b).norm() / a.norm())
    assert rel < 0.05, rel  # int8 weights and activations: a few percent


def test_fused_qkv_keeps_its_scales_in_f32():
    """The temporal branch's fused int8 projection equals the three separate
    ones with q scaled afterwards, to f32 rounding."""
    from videollamb_torch.models.vision.clip_vit import CLIPAttention
    from videollamb_torch.ops.temporal_attention import _qkv_fused

    torch.manual_seed(0)
    attn = CLIPAttention(32)
    for p in attn.parameters():
        torch.nn.init.normal_(p, std=0.2)
    pvq._quantize_attn(attn)
    x = torch.randn(2, 8, 5, 32)
    s = 8 ** -0.5
    with torch.no_grad():
        fused = _qkv_fused(attn, x, s)
        want = torch.cat([attn.q_proj(x) * s, attn.k_proj(x), attn.v_proj(x)], dim=-1)
    np.testing.assert_allclose(fused.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)
