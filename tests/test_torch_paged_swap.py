"""Swap preemption in the port's paged engine, on the CPU, on the seeded tiny
reference-format checkpoint in f32.

Page 16 and a pool of trash + 2 x 46 prompt pages + 1 growth page: both
727-token prompts admit, and the second slot to cross a page boundary
forces a swap-out of the youngest request. Its pages go to host memory as
raw bytes (int8 pages with their scales) and come back when pages free.
The tokens must equal an ample pool's and the JAX package's engine under
the same pressure, with the f32 pool and with the int8 pool.
"""

from __future__ import annotations

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

PAGE, MAX_NEW, K = 16, 20, 4
PROMPT_PAGES = 46  # 727 spliced tokens
STARVED = dict(num_slots=2, page_size=PAGE, total_pages=1 + 2 * PROMPT_PAGES + 1,
               pages_per_seq=48, eos_token_id=-1)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    return load_both(*write_reference_checkpoint(str(tmp_path_factory.mktemp("ckpt")), seed=3))


@pytest.mark.parametrize("quantize_kv", [False, True], ids=["f32_pool", "int8_pool"])
def test_swap_preemption_tokens_equal_ample_pool_and_jax(models, quantize_kv):
    from videollamb_tpu.serve.paged import PagedServingEngine as JaxEngine
    from videollamb_torch.serve.paged import PagedServingEngine

    params, jcfg, model, cfg = models
    rows = video_rows(cfg, [0, 1, 2])
    ample = serve(PagedServingEngine(model, cfg, num_slots=2, page_size=PAGE, eos_token_id=-1,
                                     quantize_kv=quantize_kv),
                  port_requests(rows, MAX_NEW), K)
    starved = PagedServingEngine(model, cfg, quantize_kv=quantize_kv, **STARVED)
    reqs = port_requests(rows, MAX_NEW)
    assert serve(starved, reqs, K) == ample
    assert starved.preempted >= 1 and starved.resumed == starved.preempted
    assert starved.allocator.free_pages == STARVED["total_pages"] - 1
    assert not starved._swapped and not any(starved.slot_pages)
    jax_engine = JaxEngine(params, jcfg, quantize_kv=quantize_kv, **STARVED)
    assert serve(jax_engine, jax_requests(rows, MAX_NEW), K) == ample
    assert jax_engine.preempted == starved.preempted


def test_pool_too_small_for_one_request_raises(models):
    """The only active request cannot be swapped out to make room for itself."""
    from videollamb_torch.serve.paged import PagedServingEngine

    _, _, model, cfg = models
    engine = PagedServingEngine(model, cfg, **dict(STARVED, total_pages=1 + PROMPT_PAGES))
    engine.submit(port_requests(video_rows(cfg, [0]), MAX_NEW)[0])
    with pytest.raises(RuntimeError, match="pool exhausted"):
        engine.run_until_drained(k=K)


def test_cancelled_while_swapped_is_dropped(models):
    from videollamb_torch.serve.paged import PagedServingEngine

    _, _, model, cfg = models
    engine = PagedServingEngine(model, cfg, **STARVED)
    reqs = port_requests(video_rows(cfg, [0, 1]), MAX_NEW)
    for r in reqs:
        engine.submit(r)
    for _ in range(50):
        engine.step(K)
        if engine._swapped:
            break
    assert engine._swapped and engine._swapped[0]["req"] is reqs[1]
    assert engine.cancel(1)
    engine.run_until_drained(k=K)
    assert all(r.done for r in reqs) and len(reqs[0].tokens) == MAX_NEW
    assert engine.allocator.free_pages == STARVED["total_pages"] - 1
