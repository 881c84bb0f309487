"""The whole model with each LM projector kind against the JAX package, on
the CPU in f32 at ``ModelConfig.tiny`` size, from the same seeded JAX
parameters carried across by ``models/convert.py``:
``videollamb_forward`` logits for the eight kinds whose tokens feed the LM,
and greedy ``generate`` tokens for ``mlp``, ``qformer`` and ``retention``.

Tolerance: rtol = atol = 1e-4 on logits through tower, projector and LM (f32
through a few layers, sums in other orders than XLA's, as
``test_torch_models``); tokens exactly.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from test_torch_parity_utils import (  # noqa: E402
    LM_PROJECTOR_KINDS,
    port_config,
    projector_models,
    video_batch,
)

MODEL_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind", LM_PROJECTOR_KINDS)
def test_videollamb_forward_logits_match_jax(kind):
    from videollamb_tpu.models.assembly import videollamb_forward as jax_forward
    from videollamb_torch.models.assembly import videollamb_forward

    cfg, params, model = projector_models(kind)
    jbatch, batch = video_batch(cfg)
    want, jspliced = jax_forward(params, cfg, jbatch)
    with torch.no_grad():
        got, spliced = videollamb_forward(model, port_config(cfg), batch)
    np.testing.assert_array_equal(spliced.attention_mask.numpy(),
                                  np.asarray(jspliced.attention_mask))
    valid = spliced.attention_mask.numpy().astype(bool)
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid], **MODEL_TOL)


@pytest.mark.parametrize("kind", ["mlp", "qformer", "retention"])
def test_greedy_tokens_equal_jax(kind):
    from videollamb_tpu.models.engine import generate as jax_generate
    from videollamb_torch.models.engine import generate

    cfg, params, model = projector_models(kind, seed=2)
    jbatch, batch = video_batch(cfg, seed=3, t=12, labels=False)
    max_seq = cfg.max_length + 16
    ref = jax_generate(params, cfg, jbatch, jax.random.PRNGKey(0), max_new_tokens=8,
                       do_sample=False, max_seq_len=max_seq)
    out = generate(model, port_config(cfg), batch, max_new_tokens=8, do_sample=False,
                   max_seq_len=max_seq)
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(out.lengths.numpy(), np.asarray(ref.lengths))
