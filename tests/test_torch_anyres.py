"""Anyres images in the port against the JAX package, on the CPU in f32.

- ``mm_utils``' anyres and image helpers (best resolution, grid shape,
  unpad, expand-to-square, resize-and-pad, patch division, the patch
  stacks of ``process_anyres_image`` / ``process_images``) and
  ``anyres_spec``: byte-equal over the JAX anyres test's image sizes;
- ``anyres_merge``: equal outputs and masks for every merge type over those
  sizes, and with spare patches in a larger bucket (a pure scatter: exact);
- ``videollamb_forward`` on an anyres batch (a ``ModelConfig.tiny`` tower,
  an ``mlp2x_gelu`` projector, a learned ``image_newline``): logits within
  LOGITS_TOL for each merge type; greedy ``generate`` tokens equal;
- a projector that does not keep the grid raises, as in JAX;
- two prefix rows with equal pixels and different ``image_specs`` are two
  prefix-cache misses (the cache key hashes the specs), as in JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
PIL = pytest.importorskip("PIL")

import jax.numpy as jnp  # noqa: E402
from PIL import Image  # noqa: E402
from test_torch_parity_utils import drawn_tree, port_config  # noqa: E402

from videollamb_tpu import mm_utils as jmm  # noqa: E402
from videollamb_tpu.config import BridgeConfig, ModelConfig  # noqa: E402
from videollamb_tpu.models import anyres as janyres  # noqa: E402
from videollamb_torch import mm_utils as pmm  # noqa: E402
from videollamb_torch.models import anyres as panyres  # noqa: E402

# The JAX anyres test's sizes and pinpoints (tests/test_anyres.py).
SIZES = [(800, 1100), (1100, 500), (700, 680), (336, 1400), (250, 90), (90, 250)]
PINPOINTS = ((336, 672), (672, 336), (672, 672), (1008, 336), (336, 1008))
MERGES = ["spatial_unpad", "spatial", "flat"]
# The tiny model's grid: 56-pixel patches of a 56-pixel tower.
TINY_PINPOINTS = ((56, 112), (112, 56), (112, 112))
# f32 through the tower, projector and LM, summed in other orders than XLA.
LOGITS_TOL = dict(rtol=1e-5, atol=1e-5)


def _image(size, seed=0):
    w, h = size
    return Image.fromarray(np.random.default_rng(seed).integers(0, 255, (h, w, 3)).astype(np.uint8))


def _processors():
    from videollamb_torch.data.processing import ImageProcessor
    from videollamb_tpu.data.processing import ImageProcessor as JaxImageProcessor

    return JaxImageProcessor(size=56), ImageProcessor(size=56)


@pytest.mark.parametrize("size", SIZES)
def test_anyres_helpers_equal_jax(size):
    assert pmm.select_best_resolution(size, PINPOINTS) == jmm.select_best_resolution(
        size, PINPOINTS)
    assert pmm.get_anyres_image_grid_shape(size, list(PINPOINTS), 336) == \
        jmm.get_anyres_image_grid_shape(size, list(PINPOINTS), 336)
    assert pmm.get_anyres_image_grid_shape(size, str(list(PINPOINTS)), 336) == \
        jmm.get_anyres_image_grid_shape(size, str(list(PINPOINTS)), 336)
    grid = np.random.default_rng(1).normal(size=(3, 24, 48)).astype(np.float32)
    np.testing.assert_array_equal(pmm.unpad_image(grid, size), jmm.unpad_image(grid, size))
    for s in (4, 7, 24):
        np.testing.assert_array_equal(panyres.anyres_spec(size, PINPOINTS, 336, s),
                                      janyres.anyres_spec(size, PINPOINTS, 336, s))

    # PIL helpers at a tenth of the size (same aspect).
    small = (max(size[0] // 10, 3), max(size[1] // 10, 3))
    img = _image(small)
    for fn in ("expand2square",):
        np.testing.assert_array_equal(np.asarray(getattr(pmm, fn)(img, (10, 20, 30))),
                                      np.asarray(getattr(jmm, fn)(img, (10, 20, 30))))
    np.testing.assert_array_equal(np.asarray(pmm.resize_and_pad_image(img, (112, 56))),
                                  np.asarray(jmm.resize_and_pad_image(img, (112, 56))))
    for a, b in zip(pmm.divide_to_patches(img, 16), jmm.divide_to_patches(img, 16)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    jproc, pproc = _processors()
    np.testing.assert_array_equal(pmm.process_anyres_image(img, pproc, list(TINY_PINPOINTS)),
                                  jmm.process_anyres_image(img, jproc, list(TINY_PINPOINTS)))


@pytest.mark.parametrize("aspect", ["pad", "anyres", "square"])
def test_process_images_equal_jax(aspect):
    jproc, pproc = _processors()

    @dataclasses.dataclass
    class Cfg:
        image_aspect_ratio: str = aspect
        image_grid_pinpoints: list = dataclasses.field(default_factory=lambda: list(TINY_PINPOINTS))

    # Equal-shape anyres stacks stack; unequal ones stay a list, as in JAX.
    for sizes in ([(90, 40), (100, 44)], [(90, 40), (40, 90), (60, 60)]):
        images = [_image(s, i) for i, s in enumerate(sizes)]
        want = jmm.process_images(images, jproc, Cfg())
        got = pmm.process_images(images, pproc, Cfg())
        assert type(got) is type(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


# Under jit: op by op, every spec shape would compile each op of the merge.
_jax_merge = jax.jit(janyres.anyres_merge, static_argnums=(3, 4))


@pytest.mark.parametrize("merge_type", MERGES)
@pytest.mark.parametrize("image_size", SIZES)
def test_anyres_merge_equal_jax(merge_type, image_size):
    rng = np.random.default_rng(0)
    h = 4
    spec = janyres.anyres_spec(image_size, PINPOINTS, 336, h)
    p = 1 + int(spec[0]) * int(spec[1])
    tokens = rng.normal(size=(p, h * h, 5)).astype(np.float32)
    newline = rng.normal(size=(5,)).astype(np.float32)
    want, want_mask = _jax_merge(jnp.asarray(tokens), jnp.asarray(spec),
                                 jnp.asarray(newline), h, merge_type)
    got, mask = panyres.anyres_merge(torch.from_numpy(tokens), torch.from_numpy(spec),
                                     torch.from_numpy(newline), h, merge_type)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.shape[0] == panyres.anyres_max_tokens(p, h, merge_type) == \
        janyres.anyres_max_tokens(p, h, merge_type)


def test_anyres_merge_spare_patches_equal_jax():
    """A (1, 2) grid in a P = 5 bucket: the spare patches are dropped."""
    rng = np.random.default_rng(3)
    h = 3
    spec = janyres.anyres_spec((1100, 500), PINPOINTS, 336, h)
    tokens = rng.normal(size=(5, h * h, 4)).astype(np.float32)
    newline = rng.normal(size=(4,)).astype(np.float32)
    want, want_mask = _jax_merge(jnp.asarray(tokens), jnp.asarray(spec),
                                 jnp.asarray(newline), h, "spatial_unpad")
    got, mask = panyres.anyres_merge(torch.from_numpy(tokens), torch.from_numpy(spec),
                                     torch.from_numpy(newline), h, "spatial_unpad")
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


def _cfg(merge_type: str = "spatial_unpad", kind: str = "mlp") -> ModelConfig:
    base = ModelConfig.tiny(max_length=128)
    return dataclasses.replace(
        base, bridge=BridgeConfig(kind=kind, mlp_depth=2, hidden_size=base.vision.hidden_size),
        mm_patch_merge_type=merge_type, image_aspect_ratio="anyres",
        image_grid_pinpoints=TINY_PINPOINTS)


@pytest.fixture(scope="module")
def models():
    """A seeded JAX tree (with image_newline) and the port model holding it."""
    from videollamb_torch.models.assembly import VideoLLaMB
    from videollamb_torch.models.bridge.builder import bridge_module
    from videollamb_torch.models.convert import from_jax_params
    from videollamb_torch.models.lm.llama import LlamaForCausalLM
    from videollamb_torch.models.vision.clip_vit import CLIPVisionTower
    from videollamb_tpu.models.assembly import init_image_newline
    from videollamb_tpu.models.bridge.builder import init_bridge_params
    from videollamb_tpu.models.lm.llama import init_llama_params
    from videollamb_tpu.models.vision.clip_vit import init_vision_params

    cfg = _cfg()
    tree = drawn_tree(lambda k: {"video_tower": init_vision_params(k, cfg.vision),
                                 "mm_projector": init_bridge_params(k, cfg.bridge,
                                                                    cfg.lm.hidden_size),
                                 "lm": init_llama_params(k, cfg.lm),
                                 "image_newline": init_image_newline(k, cfg.lm.hidden_size)})
    pcfg = port_config(cfg)
    model = VideoLLaMB(CLIPVisionTower(pcfg.vision),
                       bridge_module(pcfg.bridge, cfg.lm.hidden_size),
                       LlamaForCausalLM(pcfg.lm), image_newline=torch.empty(cfg.lm.hidden_size))
    model.load_state_dict(from_jax_params(tree), strict=True)
    return jax.tree.map(jnp.asarray, tree), model.eval(), tree


def _batches(cfg, seed=0, sizes=((100, 40), (30, 70)), p=3, labels=False, t=10):
    """(jax batch, port batch): anyres rows with the IMAGE sentinel at 1."""
    from videollamb_torch.models.assembly import MultimodalBatch as PortBatch
    from videollamb_tpu.models.assembly import MultimodalBatch

    rng = np.random.default_rng(seed)
    b = len(sizes)
    specs = np.stack([janyres.anyres_spec(s, cfg.image_grid_pinpoints, cfg.vision.image_size,
                                          cfg.vision.num_patches_per_side) for s in sizes])
    ids = rng.integers(4, cfg.lm.vocab_size, size=(b, t)).astype(np.int32)
    ids[:, 1] = -200
    mask = np.ones((b, t), np.int32)
    images = rng.normal(size=(b, p, 3, 56, 56)).astype(np.float32)
    lab = np.where(np.arange(t)[None] >= 4, ids, -100).astype(np.int32) if labels else None
    jb = MultimodalBatch(jnp.asarray(ids), jnp.asarray(mask),
                         None if lab is None else jnp.asarray(lab), None,
                         jnp.asarray(images), image_specs=jnp.asarray(specs))
    pb = PortBatch(torch.from_numpy(ids).long(), torch.from_numpy(mask).long(),
                   None if lab is None else torch.from_numpy(lab).long(),
                   images=torch.from_numpy(images), image_specs=torch.from_numpy(specs))
    return jb, pb


@pytest.mark.parametrize("merge_type", MERGES)
def test_anyres_forward_logits_equal_jax(models, merge_type):
    from videollamb_torch.models.assembly import videollamb_forward
    from videollamb_tpu.models.assembly import videollamb_forward as jax_forward

    params, model, _ = models
    cfg = _cfg(merge_type)
    jb, pb = _batches(cfg, p=5 if merge_type == "flat" else 3)
    want, jspliced = jax_forward(params, cfg, jb)
    with torch.no_grad():
        got, spliced = videollamb_forward(model, port_config(cfg), pb)
    np.testing.assert_array_equal(spliced.attention_mask.numpy(),
                                  np.asarray(jspliced.attention_mask))
    valid = spliced.attention_mask.numpy().astype(bool)
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid], **LOGITS_TOL)


def test_anyres_greedy_tokens_equal_jax(models):
    from videollamb_torch.models.engine import generate
    from videollamb_tpu.models.engine import generate as jax_generate

    params, model, _ = models
    cfg = _cfg()
    jb, pb = _batches(cfg, seed=4, sizes=((90, 60),), p=5)
    max_seq = cfg.max_length + 16
    ref = jax_generate(params, cfg, jb, jax.random.PRNGKey(0), max_new_tokens=8,
                       do_sample=False, max_seq_len=max_seq)
    out = generate(model, port_config(cfg), pb, max_new_tokens=8, do_sample=False,
                   max_seq_len=max_seq)
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))


def test_anyres_needs_a_grid_preserving_projector(models):
    from videollamb_torch.models.assembly import encode_images_anyres
    from videollamb_tpu.models.assembly import encode_images_anyres as jax_encode

    params, model, _ = models
    cfg = _cfg(kind="rmt_r_transformer")
    jb, pb = _batches(cfg)
    with pytest.raises(ValueError, match="grid-preserving") as want:
        jax_encode(params, cfg, jb.images, jb.image_specs)
    with pytest.raises(ValueError, match="grid-preserving") as got:
        encode_images_anyres(model, port_config(cfg), pb.images, pb.image_specs)
    assert str(got.value) == str(want.value)


def test_image_newline_round_trips(models):
    from videollamb_torch.models.convert import to_jax_params

    _, model, tree = models
    np.testing.assert_array_equal(to_jax_params(model.state_dict())["image_newline"],
                                  tree["image_newline"])


def test_prefix_cache_keys_the_image_specs(models):
    """Equal pixels, different grids: two prefixes, not one reused wrongly."""
    from videollamb_torch.models.assembly import MultimodalBatch as PortBatch
    from videollamb_torch.serve.paged import PagedServingEngine
    from videollamb_torch.serve.server import Request
    from videollamb_tpu.models.assembly import MultimodalBatch
    from videollamb_tpu.serve.paged import PagedServingEngine as JPaged
    from videollamb_tpu.serve.server import Request as JRequest

    params, model, _ = models
    cfg = _cfg()
    prefix_j, prefix_p = _batches(cfg, seed=6, sizes=((100, 40),), t=6)
    rng = np.random.default_rng(7)
    suffix = rng.integers(4, cfg.lm.vocab_size, size=(1, 4)).astype(np.int32)
    other = janyres.anyres_spec((40, 100), TINY_PINPOINTS, 56, 4)[None]
    assert not np.array_equal(other, prefix_j.image_specs)
    out = {}
    for side in ("jax", "torch"):
        common = dict(num_slots=2, eos_token_id=-1, page_size=32, prefix_cache_size=1)
        if side == "jax":
            engine = JPaged(params, cfg, **common)
            prefixes = [prefix_j, prefix_j._replace(image_specs=jnp.asarray(other))]
            reqs = [JRequest(uid=i, batch=MultimodalBatch(
                jnp.asarray(suffix), jnp.ones((1, 4), jnp.int32), None, None, None),
                prefix_batch=pb, max_new_tokens=4, temperature=0.0)
                for i, pb in enumerate(prefixes)]
        else:
            engine = PagedServingEngine(model, port_config(cfg), **common)
            prefixes = [prefix_p, prefix_p._replace(image_specs=torch.from_numpy(other))]
            reqs = [Request(uid=i, batch=PortBatch(torch.from_numpy(suffix).long(),
                                                   torch.ones((1, 4), dtype=torch.long)),
                            prefix_batch=pb, max_new_tokens=4, temperature=0.0)
                    for i, pb in enumerate(prefixes)]
        for r in reqs:  # one at a time: the second may reuse the first's prefix
            engine.submit(r)
            engine.run_until_drained()
        out[side] = ([r.tokens for r in reqs], engine.prefix_misses, engine.prefix_hits)
    assert out["torch"] == out["jax"]
    assert out["torch"][1:] == (2, 0)
