"""The port's paged continuous-batching engine against the JAX package's, on
the CPU, on the seeded tiny reference-format checkpoint in f32.

Three 16-frame video requests on two slots (the third waits for a slot and
is admitted between decode steps), greedy, k=4 decode steps per host sync:
the tokens must equal ``videollamb_tpu.serve.paged.PagedServingEngine``'s
token for token, with the f32 head-major pool and with the int8 token-major
pool. On the CPU the port takes the JAX package's route off the TPU (the
XLA twins of K4 and K6 and the plain installs), so the comparison is exact
up to float sums. Also: pages of a released slot are reused.
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from test_torch_parity_utils import (  # noqa: E402
    jax_requests,
    load_both,
    port_requests,
    serve,
    video_rows,
    write_reference_checkpoint,
)

MAX_NEW, K = 6, 4


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    return load_both(*write_reference_checkpoint(str(tmp_path_factory.mktemp("ckpt")), seed=3))


@pytest.mark.parametrize("quantize_kv", [False, True], ids=["f32_pool", "int8_pool"])
def test_paged_engine_greedy_tokens_equal_jax(models, quantize_kv):
    from videollamb_tpu.serve.paged import PagedServingEngine as JaxEngine
    from videollamb_torch.serve.paged import PagedServingEngine

    params, jcfg, model, cfg = models
    rows = video_rows(cfg, [0, 1, 2])
    want = serve(JaxEngine(params, jcfg, num_slots=2, eos_token_id=-1,
                           quantize_kv=quantize_kv), jax_requests(rows, MAX_NEW), K)
    engine = PagedServingEngine(model, cfg, num_slots=2, eos_token_id=-1,
                                quantize_kv=quantize_kv)
    assert engine.pages_per_seq == 40 and engine.total_pages == 81
    assert engine.cache.quantized == quantize_kv
    got = serve(engine, port_requests(rows, MAX_NEW), K)
    assert got == want
    assert all(len(t) == MAX_NEW for t in got)
    assert engine.allocator.free_pages == engine.total_pages - 1
    assert not any(engine.slot_pages) and not engine._swapped


def test_released_pages_are_reused(models):
    """A pool that holds one request at a time: the second and third wait
    until the first releases, then run in its pages, with the tokens of an
    ample pool."""
    from videollamb_torch.serve.paged import PagedServingEngine

    _, _, model, cfg = models
    rows = video_rows(cfg, [3, 4, 5])
    ample = serve(PagedServingEngine(model, cfg, num_slots=2, eos_token_id=-1),
                  port_requests(rows, MAX_NEW), K)
    engine = PagedServingEngine(model, cfg, num_slots=2, eos_token_id=-1,
                                total_pages=1 + 12 + 1)  # 727-token prompts: 12 pages
    reqs = port_requests(rows, MAX_NEW)
    for r in reqs:
        engine.submit(r)
    pages_of = {}
    while engine.has_work():
        engine.step(K)
        active = [i for i, r in enumerate(engine.slots) if r is not None]
        assert len(active) <= 1
        for i in active:
            pages_of.setdefault(engine.slots[i].uid, set()).update(engine.slot_pages[i])
    assert [r.tokens for r in reqs] == ample
    assert pages_of[0] & pages_of[1] and pages_of[1] & pages_of[2]
    assert engine.allocator.free_pages == engine.total_pages - 1
    assert engine.preempted == 0


def test_rejects_a_prompt_over_the_sequence_budget(models):
    from videollamb_torch.serve.paged import PagedServingEngine

    _, _, model, cfg = models
    engine = PagedServingEngine(model, cfg, num_slots=2, eos_token_id=-1, pages_per_seq=8)
    reqs = port_requests(video_rows(cfg, [6]), MAX_NEW)
    done = serve(engine, reqs, K)
    assert done == [[]] and reqs[0].done and "per-sequence budget is 8" in reqs[0].error
    assert np.all(engine._host_len == 0)
