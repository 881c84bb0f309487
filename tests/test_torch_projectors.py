"""Every projector kind of the factory against the JAX package, the bridge
alone, on the CPU in f32 at ``ModelConfig.tiny`` size, from the same seeded
JAX parameters carried across by ``models/convert.py``.

- ``bridge_apply`` of every kind (spatial_pool and the RMT-R cap variant
  included), video and image, and the token count the packing budget reads;
- the ``convert`` round trip of every kind's tree, and the seeded init;
- checkpoint projector weights, the streaming session and the retro encoder
  refuse a kind other than RMT-R, with the reason.

The whole model with each kind is ``test_torch_projector_models.py``; its
training, ``test_torch_projector_train.py``.

Tolerance: 1e-5 on one projector pass (f32, sums in other orders than
XLA's).
"""

from __future__ import annotations

import json
import os
import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from test_torch_parity_utils import (  # noqa: E402
    LM_PROJECTOR_KINDS,
    PROJECTOR_KINDS,
    base_lm_checkpoint,
    np_tree,
    port_config,
    port_projector,
    projector_config,
    projector_tree,
    write_reference_checkpoint,
)

BRIDGE_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind,modality", [
    (kind, modality) for kind in PROJECTOR_KINDS for modality in ("video", "image")
    if (kind, modality) != ("rmt_r_transformer_cap", "image")])  # a video-only variant
def test_bridge_apply_matches_jax(kind, modality):
    """8 frames of 1 + 4 x 4 tower tokens (CLS first), or one image's."""
    from videollamb_tpu.models.bridge.builder import bridge_apply as jax_apply
    from videollamb_torch.models.bridge.builder import bridge_apply, bridge_token_count

    cfg = projector_config(kind)
    tree = projector_tree(cfg)
    module = port_projector(cfg, tree)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(8, 17, 32) if modality == "video" else (17, 32)).astype(np.float32)
    want_tokens, want_mask = jax_apply(tree, cfg.bridge, jnp.asarray(x), modality=modality)
    with torch.no_grad():
        tokens, mask = bridge_apply(module, port_config(cfg).bridge, torch.from_numpy(x),
                                    modality=modality)
    np.testing.assert_allclose(tokens.numpy(), np.asarray(want_tokens), **BRIDGE_TOL)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    if kind != "rmt_r_transformer_cap":
        assert bridge_token_count(port_config(cfg).bridge, 17, 8, modality) == tokens.shape[0]


@pytest.mark.parametrize("kind", PROJECTOR_KINDS)
def test_convert_round_trip(kind):
    """JAX tree -> port module -> JAX tree, leaf for leaf; and the seeded
    port init has the tree's names and shapes."""
    from videollamb_torch.models.bridge.builder import init_bridge_params
    from videollamb_torch.models.convert import to_jax_params

    cfg = projector_config(kind)
    tree = projector_tree(cfg)
    module = port_projector(cfg, tree)
    back = to_jax_params({f"mm_projector.{k}": v for k, v in module.state_dict().items()})
    back = back.get("mm_projector", {})
    want = jax.tree_util.tree_leaves_with_path(tree)
    got = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(want, got):
        np.testing.assert_array_equal(b, a, err_msg=jax.tree_util.keystr(path))
    seeded = init_bridge_params(port_config(cfg).bridge, cfg.lm.hidden_size, seed=3)
    assert {k: v.shape for k, v in seeded.state_dict().items()} == {
        k: v.shape for k, v in module.state_dict().items()}
    assert all(torch.isfinite(p).all() for p in seeded.parameters())


@pytest.mark.parametrize("modality", ["video", "image"])
def test_measure_block_tokens_equals_jax(modality):
    """The packing budget unit of every LM kind: JAX traces the encoder for
    it, the port counts from the shapes."""
    from videollamb_tpu.models.assembly import measure_block_tokens as jax_measure
    from videollamb_tpu.models.vision.clip_vit import init_vision_params
    from videollamb_torch.models.assembly import measure_block_tokens

    tower = np_tree(init_vision_params(jax.random.PRNGKey(0), projector_config("mlp").vision))
    for kind in LM_PROJECTOR_KINDS:
        cfg = projector_config(kind)
        params = {"video_tower": tower, "mm_projector": projector_tree(cfg)}
        assert measure_block_tokens(port_config(cfg), modality) == jax_measure(
            params, cfg, modality), kind


def test_projector_keys_load_for_rmt_r_only(tmp_path):
    """A checkpoint whose config names another kind but carries projector
    weights is refused with the reason (the JAX loader converts them as
    RMT-R's); without the weights it starts a seeded projector of that kind."""
    from videollamb_torch.models.bridge.variants import QFormerProjector
    from videollamb_torch.models.builder import load_pretrained_model

    model_dir, tower_dir = write_reference_checkpoint(str(tmp_path / "a"), seed=1)
    path = os.path.join(model_dir, "config.json")
    with open(path) as f:
        raw = json.load(f)
    raw["mm_projector_type"] = "qformer1_8"
    with open(path, "w") as f:
        json.dump(raw, f)
    kw = dict(video_tower_path=tower_dir, dtype="float32", load_tokenizer=False, device="cpu")
    with pytest.raises(ValueError, match="rmt_r_transformer bridge only"):
        load_pretrained_model(model_dir, **kw)
    base_dir, _ = base_lm_checkpoint(str(tmp_path / "b"))
    _, model, cfg, _, _ = load_pretrained_model(base_dir, bridge_seed=0,
                                                projector_type="qformer1_8", **kw)
    assert cfg.bridge.kind == "qformer" and isinstance(model.mm_projector, QFormerProjector)


def test_rmt_r_only_paths_refuse_other_kinds():
    """The streaming session steps RMT-R's recurrence and the retro encoder
    reads its segments: another kind is refused with the reason."""
    from videollamb_torch.models.assembly import encode_videos_retro
    from videollamb_torch.serve.incremental import StreamingSession

    cfg = port_config(projector_config("mlp"))
    with pytest.raises(ValueError, match="rmt_r_transformer"):
        StreamingSession(types.SimpleNamespace(cfg=cfg))
    with pytest.raises(ValueError, match="rmt_r_transformer"):
        encode_videos_retro(None, cfg, torch.zeros(1, 8, 3, 56, 56))
