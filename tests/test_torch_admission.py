"""Admission's prompt lengths in the port against the JAX package, on the CPU
in f32 at ``ModelConfig.tiny`` size from one seeded parameter tree:

- ``spliced_prompt_len_host`` gives JAX's answer for every row kind (text,
  one image under an rmt-family projector or another kind, a video, an
  anyres stack, a mixed row, two images);
- the paged engine's convoy admission (``_prefetch_admissions``) of video
  requests that arrive together reads their prompt lengths back in ONE copy
  per convoy, counted by wrapping the engine's ``_readback``, and gives the
  JAX engine's tokens (one admission at a time costs a copy each: the
  image test below);
- single-image requests that carry ``prompt_len`` are checked against the
  device once per shape signature and then cost no readback; text rows
  with ``prompt_len`` cost none at all; tokens equal JAX's, dense and paged;
- a wrong ``prompt_len`` raises JAX's ``RuntimeError``, word for word.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from test_torch_parity_utils import drawn_params, port_config, port_model  # noqa: E402

from videollamb_tpu.config import ModelConfig  # noqa: E402

CFG = ModelConfig.tiny(max_length=128)
MAX_NEW = 4


@pytest.fixture(scope="module")
def models():
    tree = drawn_params(CFG, seed=0)
    return jax.tree.map(jnp.asarray, tree), port_model(CFG, tree), port_config(CFG)


def _row(kind: str, seed: int, text_len: int = 8):
    """(ids, mask, fields) numpy arrays of one B=1 row (B=2 for 'two_images')."""
    rng = np.random.default_rng(seed)
    b = 2 if kind == "two_images" else 1
    ids = rng.integers(4, CFG.lm.vocab_size, size=(b, text_len)).astype(np.int32)
    img = CFG.vision.image_size
    fields = {}
    if kind in ("image", "two_images"):
        ids[:, 2] = -200
        fields["images"] = rng.normal(size=(b, 3, img, img)).astype(np.float32)
    elif kind == "video":
        ids[:, 2] = -201
        fields["videos"] = rng.normal(size=(1, 8, 3, img, img)).astype(np.float32)
    elif kind == "anyres":
        ids[:, 2] = -200
        fields["images"] = rng.normal(size=(1, 3, 3, img, img)).astype(np.float32)
        fields["image_specs"] = np.array([[1, 2, 0, 0]], np.int32)
    elif kind == "mixed":
        ids[:, 2], ids[:, 5] = -201, -200
        fields["blocks"] = (("VIDEO", rng.normal(size=(8, 3, img, img)).astype(np.float32)),
                            ("IMAGE", rng.normal(size=(3, img, img)).astype(np.float32)))
    return ids, np.ones_like(ids), fields


def _batch(side: str, kind: str, seed: int, text_len: int = 8):
    ids, mask, fields = _row(kind, seed, text_len)
    if side == "jax":
        from videollamb_tpu.models.assembly import MultimodalBatch

        f = {k: (tuple((m, jnp.asarray(p)) for m, p in v) if k == "blocks" else jnp.asarray(v))
             for k, v in fields.items()}
        return MultimodalBatch(jnp.asarray(ids), jnp.asarray(mask), None,
                               f.pop("videos", None), f.pop("images", None), **f)
    from videollamb_torch.models.assembly import MultimodalBatch

    f = {k: (tuple((m, torch.from_numpy(p)) for m, p in v) if k == "blocks"
             else torch.from_numpy(v)) for k, v in fields.items()}
    return MultimodalBatch(torch.from_numpy(ids).long(), torch.from_numpy(mask).long(), **f)


@pytest.mark.parametrize("projector", ["rmt_r_transformer", "mlp"])
@pytest.mark.parametrize("kind", ["text", "image", "video", "anyres", "mixed", "two_images"])
def test_spliced_prompt_len_host_equal_jax(kind, projector):
    from videollamb_torch.serve.server import spliced_prompt_len_host
    from videollamb_tpu.serve.server import spliced_prompt_len_host as jax_host

    cfg = dataclasses.replace(CFG, bridge=dataclasses.replace(CFG.bridge, kind=projector))
    for text_len in (8, 126):
        want = jax_host(cfg, _batch("jax", kind, 0, text_len), text_len)
        got = spliced_prompt_len_host(port_config(cfg), _batch("torch", kind, 0, text_len),
                                      text_len)
        assert got == want
    assert (got is not None) == (kind == "image" and projector == "rmt_r_transformer")


def _requests(side: str, kind: str, seeds, prompt_len=None):
    if side == "jax":
        from videollamb_tpu.serve.server import Request
    else:
        from videollamb_torch.serve.server import Request
    return [Request(uid=i, batch=_batch(side, kind, s), max_new_tokens=MAX_NEW, temperature=0.0,
                    prompt_len=prompt_len) for i, s in enumerate(seeds)]


def _engine(side: str, models, paged: bool, num_slots: int):
    params, model, pcfg = models
    kw = dict(num_slots=num_slots, eos_token_id=-1)
    if paged:
        kw["page_size"] = 32
    if side == "jax":
        from videollamb_tpu.serve.paged import PagedServingEngine
        from videollamb_tpu.serve.server import ServingEngine

        return (PagedServingEngine if paged else ServingEngine)(params, CFG, **kw)
    from videollamb_torch.serve.paged import PagedServingEngine
    from videollamb_torch.serve.server import ServingEngine

    return (PagedServingEngine if paged else ServingEngine)(model, pcfg, **kw)


def _counting(engine) -> list:
    """Wrap the engine's readback; the list gets each copy's length."""
    copies = []
    inner = engine._readback

    def readback(t):
        copies.append(int(t.numel()))
        return inner(t)

    engine._readback = readback
    return copies


def _run(engine, requests, together: bool):
    if together:
        for r in requests:
            engine.submit(r)
        engine.run_until_drained()
    else:
        for r in requests:
            engine.submit(r)
            engine.run_until_drained()
    return [r.tokens for r in requests]


def test_convoy_admission_one_readback_per_convoy_equal_jax(models):
    seeds = (40, 41, 42)
    want = _run(_engine("jax", models, True, 3), _requests("jax", "video", seeds), True)
    convoy = _engine("torch", models, True, 3)
    copies = _counting(convoy)
    reqs = _requests("torch", "video", seeds)
    assert _run(convoy, reqs, True) == want
    assert copies == [3]  # the three mask sums in one copy
    assert all(r._spliced_cache is None for r in reqs)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_image_prompt_len_verified_once_equal_jax(models, paged):
    seeds = (20, 21)
    want = _run(_engine("jax", models, paged, 2), _requests("jax", "image", seeds, 8), False)
    engine = _engine("torch", models, paged, 2)
    copies = _counting(engine)
    assert _run(engine, _requests("torch", "image", seeds, 8), False) == want
    assert copies == [1]  # the first row checks the formula; the rest trust it
    assert engine._len_verified == {((1, 3, 56, 56), 8)}


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_text_prompt_len_costs_no_readback(models, paged):
    from test_torch_parity_utils import text_requests

    jreqs, preqs = text_requests(CFG.lm.vocab_size, (1, 2, 3), MAX_NEW, prompt_len=6)
    for r in jreqs + preqs:
        r.prompt_len = 6
    want = _run(_engine("jax", models, paged, 3), jreqs, True)
    engine = _engine("torch", models, paged, 3)
    copies = _counting(engine)
    assert _run(engine, preqs, True) == want
    assert copies == []


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_wrong_prompt_len_raises_jax_error(models, paged):
    errors = []
    for side in ("jax", "torch"):
        engine = _engine(side, models, paged, 1)
        engine.submit(_requests(side, "image", (5,), prompt_len=9)[0])
        with pytest.raises(RuntimeError) as err:
            engine.run_until_drained()
        errors.append(str(err.value))
    assert errors[0] == errors[1]
    assert "host spliced-length formula gave" in errors[1]
