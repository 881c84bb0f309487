"""Gradients through the whole video tower: the port's ``vision_encode``
(whose attention cores are kernel-forward, plain-recompute-backward ops) against
``jax.grad`` of the JAX package's ``vision_encode``, at ModelConfig.tiny()
size in f32 on the CPU, from the same seeded parameters and pixels; and the
guard that keeps the forward-only kernels out of a graph."""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from test_torch_parity_utils import jax_params, port_config, port_model  # noqa: E402

from videollamb_tpu.config import ModelConfig  # noqa: E402

CFG = ModelConfig.tiny()
# f32 through two encoder layers and their backward, summed in other orders:
# relative 1e-4, and an absolute floor of 1e-5 of the gradient's largest entry
# (entries near zero are sums of terms in the hundreds).
GRAD_RTOL, GRAD_ATOL_OF_MAX = 1e-4, 1e-5


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL_OF_MAX * float(np.abs(want).max()))


@pytest.fixture(scope="module")
def towers():
    tree = jax_params(CFG, seed=3)
    return jax.tree.map(jnp.asarray, tree["video_tower"]), port_model(CFG, tree).video_tower


@pytest.mark.parametrize("frames,select_layer", [(8, -1), (16, -2), (1, -1)])
def test_vision_encode_grads_match_jax(towers, frames, select_layer):
    """d sum(features^2) / d (pixels, a temporal q weight, a spatial k weight).
    Eight and sixteen frames run the temporal branch (K2's op), one frame only
    the spatial core (K1's op)."""
    from videollamb_tpu.models.vision.clip_vit import vision_encode as jax_encode
    from videollamb_torch.models.vision.clip_vit import vision_encode

    jparams, tower = towers
    img = CFG.vision.image_size
    pixels = np.random.default_rng(frames).normal(size=(2, frames, 3, img, img)).astype(np.float32)

    def loss(params, px):
        feats = jax_encode(params, px, CFG.vision, select_layer=select_layer)
        return jnp.sum(feats.astype(jnp.float32) ** 2)

    g_params, g_pixels = jax.grad(loss, argnums=(0, 1))(jparams, jnp.asarray(pixels))

    tower.zero_grad(set_to_none=True)
    px = torch.from_numpy(pixels).requires_grad_(True)
    feats = vision_encode(tower, px, port_config(CFG).vision, select_layer=select_layer)
    (feats ** 2).sum().backward()
    _close(px.grad.numpy(), g_pixels)
    layers = tower.vision_model.encoder.layers
    _close(layers[0].self_attn.k_proj.weight.grad.numpy().T,
           g_params["layers"][0]["self_attn"]["k_proj"]["kernel"])
    if frames > 1:
        _close(layers[0].temporal_attn.q_proj.weight.grad.numpy().T,
               g_params["layers"][0]["temporal_attn"]["q_proj"]["kernel"])


def test_tower_weights_get_no_gradient_under_no_grad(towers):
    """Serving runs the tower under torch.no_grad(): no graph, no gradient."""
    from videollamb_torch.models.vision.clip_vit import vision_encode

    _, tower = towers
    img = CFG.vision.image_size
    px = torch.zeros((1, 8, 3, img, img), requires_grad=True)
    with torch.no_grad():
        feats = vision_encode(tower, px, port_config(CFG).vision)
    assert feats.grad_fn is None and not feats.requires_grad


def test_forward_only_guard():
    """The check every forward-only kernel wrapper runs before it launches on
    the card: it raises only where autograd would want a gradient."""
    from videollamb_torch.kernels.build import refuse_grad

    wants = torch.zeros(3, requires_grad=True)
    plain = torch.zeros(3)
    with pytest.raises(RuntimeError, match="forward-only.*torch.no_grad"):
        refuse_grad("kernel", plain, wants)
    with pytest.raises(RuntimeError, match="use the op"):
        refuse_grad("kernel", wants, route="use the op")
    refuse_grad("kernel", plain, None)
    with torch.no_grad():
        refuse_grad("kernel", wants)
