"""Sampling controls and logprobs in the port's serving engines against the
JAX package's, on the CPU, on ``ModelConfig.tiny`` in f32 with text-only
prompts (the same seeded parameters and ids on both sides).

- ``build_control_adjustments`` and ``build_control_tensors`` equal JAX's.
- Greedy tokens under logit_bias, presence / frequency penalties and
  min_tokens equal JAX's in the dense engine and the paged engine (f32 and
  int8 pools), through the device loop (k = 4) and the host path (k = 1).
- top_k / top_p leave the same support as JAX's ``sample_rows`` (sampled
  tokens differ by generator, so the test compares the sets of drawn tokens
  over many rows, not the tokens).
- Logprobs and top ids equal JAX's within 1e-5 (f32).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from test_torch_parity_utils import serve, text_requests, tiny_models  # noqa: E402

EOS = 2


@pytest.fixture(scope="module")
def models():
    return tiny_models()


def _engines(models, kind):
    from videollamb_torch.serve.paged import PagedServingEngine
    from videollamb_torch.serve.server import ServingEngine
    from videollamb_tpu.serve.paged import PagedServingEngine as JaxPaged
    from videollamb_tpu.serve.server import ServingEngine as JaxDense

    jcfg, params, model, cfg = models
    if kind == "dense":
        return (JaxDense(params, jcfg, num_slots=2, eos_token_id=EOS),
                ServingEngine(model, cfg, num_slots=2, eos_token_id=EOS))
    kw = dict(num_slots=2, page_size=16, eos_token_id=EOS, quantize_kv=kind == "paged_int8")
    return JaxPaged(params, jcfg, **kw), PagedServingEngine(model, cfg, **kw)


CONTROL_CASES = [
    dict(logit_bias={5: 3.0, 9: -2.0}),
    dict(presence_penalty=0.5, frequency_penalty=0.25),
    dict(min_tokens=4),
    dict(logit_bias={EOS: 5.0}, min_tokens=3, frequency_penalty=0.75),
]


@pytest.mark.parametrize("case", range(len(CONTROL_CASES)))
def test_control_adjustments_and_tensors_equal_jax(models, case):
    from videollamb_torch.serve import server as port
    from videollamb_tpu.serve import server as ref

    vocab = models[0].lm.vocab_size
    jreqs, preqs = text_requests(vocab, [case, case + 10], 8, **CONTROL_CASES[case])
    for r in jreqs + preqs:
        r.tokens = [7, 7, 9]
    jreqs.append(None)
    preqs.append(None)
    want = ref.build_control_adjustments(jreqs, vocab, EOS)
    got = port.build_control_adjustments(preqs, vocab, EOS)
    np.testing.assert_array_equal(got, want)
    for a, b in zip(port.build_control_tensors(preqs, vocab),
                    ref.build_control_tensors(jreqs, vocab)):
        np.testing.assert_array_equal(a, b)
    assert port.slot_sampling_vectors(preqs)[1].tolist() == ref.slot_sampling_vectors(
        jreqs)[1].tolist()


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("kind", ["dense", "paged_f32", "paged_int8"])
def test_greedy_tokens_with_controls_equal_jax(models, kind, k):
    vocab = models[0].lm.vocab_size
    jax_engine, engine = _engines(models, kind)
    jreqs, preqs = [], []
    for i, case in enumerate(CONTROL_CASES[:3 if k == 1 else 4]):
        j, p = text_requests(vocab, [20 + i], 7, **case)
        jreqs += j
        preqs += p
    for i, (j, p) in enumerate(zip(jreqs, preqs)):
        j.uid = p.uid = i
    want = serve(jax_engine, jreqs, k)
    got = serve(engine, preqs, k)
    assert got == want
    # min_tokens rows keep EOS out until their minimum.
    for r in preqs:
        assert EOS not in r.tokens[:r.min_tokens]


def test_min_tokens_holds_a_biased_eos(models):
    """EOS biased to +100 would stop the row at once; min_tokens 5 holds it
    to 5 tokens, then EOS."""
    from videollamb_torch.serve.server import ServingEngine

    _, _, model, cfg = models
    engine = ServingEngine(model, cfg, num_slots=1, eos_token_id=EOS)
    _, (req,) = text_requests(cfg.lm.vocab_size, [0], 10, min_tokens=5,
                              logit_bias={EOS: 100.0})
    serve(engine, [req], 4)
    assert req.tokens[-1] == EOS and EOS not in req.tokens[:-1] and len(req.tokens) == 6


@pytest.mark.parametrize("top_k,top_p", [(5, 1.0), (0, 0.6), (8, 0.7), (1, 1.0)])
def test_top_k_top_p_support_equals_jax(top_k, top_p):
    """Each row's logits repeated over 512 draws: the drawn tokens are the
    support the filters leave, on both sides."""
    import jax.numpy as jnp

    from videollamb_torch.serve.server import sample_rows
    from videollamb_tpu.serve.server import sample_rows as jax_sample_rows

    base = np.random.default_rng(top_k * 10 + int(top_p * 10)).normal(
        size=(3, 32)).astype(np.float32) * 2
    reps = 512
    logits = np.repeat(base, reps, axis=0)
    n = logits.shape[0]
    temps = np.full((n,), 1.3, np.float32)
    top_ks = np.full((n,), top_k, np.int32)
    top_ps = np.full((n,), top_p, np.float32)
    want = np.asarray(jax_sample_rows(jnp.asarray(logits), jax.random.PRNGKey(0),
                                      jnp.asarray(temps), jnp.asarray(top_ks),
                                      jnp.asarray(top_ps)))
    gen = torch.Generator().manual_seed(0)
    got = sample_rows(torch.from_numpy(logits), gen, temps, top_ks.astype(np.int64),
                      top_ps).numpy()
    for row in range(3):
        sl = slice(row * reps, (row + 1) * reps)
        assert set(got[sl].tolist()) == set(want[sl].tolist())
        if top_k:
            assert len(set(got[sl].tolist())) <= top_k


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("kind", ["dense", "paged_f32"])
def test_logprobs_equal_jax(models, kind, k):
    """Greedy logprob rows (one with a logit_bias, which must not change the
    reported base distribution): chosen logprobs within 1e-5 and the top
    ids equal to JAX's, the chosen token first in each unbiased row's top
    list."""
    vocab = models[0].lm.vocab_size
    jax_engine, engine = _engines(models, kind)
    j0, p0 = text_requests(vocab, [30], 6, logprobs=True, top_logprobs=5)
    j1, p1 = text_requests(vocab, [31], 6, logprobs=True, top_logprobs=3,
                           logit_bias={11: 4.0})
    j1[0].uid = p1[0].uid = 1
    want = serve(jax_engine, j0 + j1, k)
    got = serve(engine, p0 + p1, k)
    assert got == want
    for j, p in zip(j0 + j1, p0 + p1):
        assert len(p.token_logprobs) == len(p.tokens) == len(p.top_tokens)
        np.testing.assert_allclose(p.token_logprobs, j.token_logprobs, atol=1e-5, rtol=0)
        for pt, jt in zip(p.top_tokens, j.top_tokens):
            assert [t for t, _ in pt] == [t for t, _ in jt]
            np.testing.assert_allclose([v for _, v in pt], [v for _, v in jt], atol=1e-5,
                                       rtol=0)
            assert all(a[1] >= b[1] for a, b in zip(pt, pt[1:]))
        assert all(v <= 0 and np.isfinite(v) for v in p.token_logprobs)
    for tok, top, lp in zip(p0[0].tokens, p0[0].top_tokens, p0[0].token_logprobs):
        assert top[0][0] == tok and abs(top[0][1] - lp) < 1e-6
