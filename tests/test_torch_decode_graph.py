"""The paged engine's decode forward as one CUDA graph (``serve/paged.py``).

The engine's model is the benchmark's seeded build (``portbench/models.py``),
so this file imports nothing of JAX and its card cases run on the card as
they are: ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_decode_graph.py``.

On the CPU: the route predicate (``decode_graph_route``) refuses the CPU, a
tensor-parallel or FSDP-sharded LM, a multi-LoRA stack and quantised
projections; every decode forward of a busy scenario (admissions between
steps, swaps, grammar rewinds, slots released mid-batch) is eager and leaves
a ``decode.eager`` mark; ``set_adapters`` decides the route again; the
``decode_graph_share`` reader counts the marks.

On the card: the same scenario with the graph and with the eager route
forced through the predicate gives the same greedy tokens, the same logits
within 1e-3, the same cache lengths and the same kernel launches after every
step, on an int8 pool (K4, K5) and on a bf16 pool (K6); a reallocated table
drops the graph and the next forward captures it again; a multi-LoRA stack
loaded after the capture is decoded eagerly, as an engine built over it
decodes it, and once it is dropped the engine captures again.
"""

from __future__ import annotations

import os
import types
from typing import List, NamedTuple

import pytest
import torch

from portbench.tests import tiny

K = 4
EOS = 2
# A JSON piece vocabulary: grammar rows emit only these ids.
PIECES = {3: "{", 4: "}", 5: "[", 6: "]", 7: '"', 8: ":", 9: ",", 10: " ", 11: "0", 12: "1",
          13: "7", 14: "-", 15: ".", 16: "e", 17: "+", 18: "true", 19: "false", 20: "null",
          21: "t", 22: "r", 23: "u", 24: "a", 25: "l", 26: "s", 27: "n", 28: "f", 29: '"name"',
          30: '": ', 31: ', "', 32: "abc", 34: '{"', 35: '"}'}
# (prompt tokens, answer budget, grammar row): the free rows outgrow the pool,
# the grammar rows freeze on their cold table and finish early.
ROWS = [(48, 24, True), (48, 100, False), (40, 24, True), (56, 90, False), (48, 80, False),
        (36, 60, False)]
PAGE, PAGES_PER_SEQ, TOTAL_PAGES = 16, 16, 1 + 18


class Tok:
    eos_token_id = EOS


def _requests(vocab: int, device) -> list:
    from videollamb_torch.models.assembly import MultimodalBatch
    from videollamb_torch.serve.grammar import json_constraint
    from videollamb_torch.serve.server import Request

    strs = [None] * vocab
    for i, s in PIECES.items():
        strs[i] = s
    gen = torch.Generator().manual_seed(11)
    out = []
    for uid, (n, budget, grammar) in enumerate(ROWS):
        ids = torch.randint(40, vocab, (1, n), generator=gen).to(device)
        out.append(Request(uid=uid, batch=MultimodalBatch(ids, torch.ones_like(ids)),
                           max_new_tokens=budget,
                           grammar=json_constraint(Tok(), token_strs=strs) if grammar else None))
    return out


class StepRecord(NamedTuple):
    tokens: dict            # uid -> tokens so far
    active: List[int]       # slots holding a request after the step
    logits: torch.Tensor    # (active, V) on the host
    lengths: list           # cache.lengths after the step
    swapped: int            # requests swapped out after the step


class Scenario(NamedTuple):
    engine: object
    reqs: list
    steps: List[StepRecord]
    rewinds: int            # decode calls that rewound a frozen row
    saved: list             # (swap-out's saved logits row, its copy then)


def run_scenario(model, mcfg, device, quantize_kv: bool) -> Scenario:
    """Six requests through four slots of an 18-page pool at k = 4: admissions
    between steps, free rows swapped out when page growth runs dry and
    resumed later, grammar rows frozen and rewound, slots released while
    others decode."""
    from videollamb_torch.serve import grammar
    from videollamb_torch.serve.paged import PagedServingEngine

    grammar._CONTENT_TABLE_CACHE.clear()  # a cold table: first visits freeze rows
    engine = PagedServingEngine(model, mcfg, num_slots=4, page_size=PAGE,
                                pages_per_seq=PAGES_PER_SEQ, total_pages=TOTAL_PAGES,
                                eos_token_id=EOS, quantize_kv=quantize_kv)
    rewinds, saved = [], []
    rewind, swap_out = engine._rewind, engine._swap_out

    def counting_rewind(frozen, garbage):
        rewinds.append(int(garbage.sum()))
        rewind(frozen, garbage)

    def saving_swap_out(slot):
        swap_out(slot)
        ent = engine._swapped[-1]
        saved.append((ent["logits"], ent["logits"].clone()))

    engine._rewind, engine._swap_out = counting_rewind, saving_swap_out
    reqs = _requests(mcfg.lm.vocab_size, device)
    for r in reqs:
        engine.submit(r)
    steps = []
    with torch.no_grad():
        while engine.has_work():
            engine.step(K)
            active = [i for i, r in enumerate(engine.slots) if r is not None]
            steps.append(StepRecord({r.uid: list(r.tokens) for r in reqs}, active,
                                    engine.logits[active].cpu(), engine.cache.lengths.tolist(),
                                    len(engine._swapped)))
            assert len(steps) < 400
    grammar._CONTENT_TABLE_CACHE.clear()
    return Scenario(engine, reqs, steps, sum(g > 0 for g in rewinds), saved)


def check_scenario_ran(sc: Scenario) -> None:
    """The scenario did what it is for: every request answered, a swap-out
    with steps taken while the request was out, a rewind, and a slot
    released while another decoded on."""
    assert all(r.done and r.error is None for r in sc.reqs)
    assert all(0 < len(r.tokens) <= b for r, (_, b, _) in zip(sc.reqs, ROWS))
    assert sc.engine.preempted >= 1 and sc.engine.resumed == sc.engine.preempted
    assert any(s.swapped for s in sc.steps[:-1])
    assert sc.rewinds >= 1
    assert any(len(b.active) < len(a.active) and b.active
               for a, b in zip(sc.steps, sc.steps[1:]))
    for row, then in sc.saved:  # the saved rows outlived the steps after them
        assert torch.equal(row, then)


# --------------------------------------------------------------------------- the CPU
def _cpu_model():
    from portbench.models import build_videollamb

    return build_videollamb(tiny.videollamb_cfg(), 7, torch.device("cpu"))[:2]


@pytest.fixture(scope="module")
def cpu_model():
    return _cpu_model()


def _with_multi_lora(model, mcfg):
    from videollamb_torch.models.lm.mlora import add_multi_lora_params

    lm, d, r = model.lm, mcfg.lm.hidden_size, 2
    layers = mcfg.lm.num_hidden_layers
    adapter = {"q_proj_lora_a": torch.zeros(layers, d, r).numpy(),
               "q_proj_lora_b": torch.zeros(layers, r, lm.model.layers[0].self_attn.q_proj
                                            .out_features).numpy()}
    add_multi_lora_params(lm, {"a": adapter})


def _with_int8_weights(model, mcfg):
    from videollamb_torch.models.lm.quant import quantize_llama_params

    quantize_llama_params(model.lm)


@pytest.fixture
def one_rank(tmp_path):
    """A one-rank gloo group, and a ('data', 'model') mesh of one rank over it."""
    import torch.distributed as dist

    from videollamb_torch.parallel.mesh import create_mesh

    store = dist.FileStore(os.path.join(str(tmp_path), "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        yield create_mesh(1, 1)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("case", ["plain", "cpu", "multi_lora", "int8_weights",
                                  "tensor_parallel", "fsdp"])
def test_route_predicate(case, request):
    """True only for a plain LM on a CUDA device; the device is named, not
    touched, so the other conditions are checked here on the CPU."""
    from videollamb_torch.serve.paged import decode_graph_route

    model, mcfg = _cpu_model()
    if case == "multi_lora":
        _with_multi_lora(model, mcfg)
    elif case == "int8_weights":
        _with_int8_weights(model, mcfg)
    elif case in ("tensor_parallel", "fsdp"):
        from videollamb_torch.parallel.sharding import shard_params

        mesh = request.getfixturevalue("one_rank")
        shard_params(mesh, model, shard_params_over_data=case == "fsdp",
                     tensor_parallel=case == "tensor_parallel")
    device = torch.device("cpu" if case == "cpu" else "cuda")
    assert decode_graph_route(model.lm, device) == (case == "plain")


def test_set_adapters_decides_the_route_again():
    """An adapter stack loaded or dropped at run time (the HTTP server's
    adapter swap) re-decides the route and drops a captured graph."""
    from videollamb_torch.models.lm.mlora import drop_multi_lora_params
    from videollamb_torch.serve.paged import PagedServingEngine

    model, mcfg = _cpu_model()
    engine = PagedServingEngine(model, mcfg, num_slots=2, page_size=PAGE,
                                pages_per_seq=PAGES_PER_SEQ, total_pages=TOTAL_PAGES,
                                eos_token_id=EOS)
    assert not engine._graph_route
    engine.device = torch.device("cuda")  # named, not touched: the route as on the card
    engine._graph_route, engine._graph = True, "captured"
    _with_multi_lora(model, mcfg)
    engine.set_adapters(model, {"a": 0})
    assert (engine._graph_route, engine._graph) == (False, None)
    drop_multi_lora_params(model.lm)
    engine.set_adapters(model, None)
    assert (engine._graph_route, engine._graph) == (True, None)


@pytest.fixture(scope="module")
def cpu_scenarios(cpu_model):
    from videollamb_torch.utils.profiling import RECORDER

    out = {}
    for quantize_kv in (False, True):
        t0 = RECORDER.records()[-1].t1 if RECORDER.records() else float("-inf")
        sc = run_scenario(*cpu_model, torch.device("cpu"), quantize_kv)
        out[quantize_kv] = (sc, [r for r in RECORDER.records() if r.t0 > t0])
    return out


@pytest.mark.parametrize("quantize_kv", [False, True], ids=["f32_pool", "int8_pool"])
def test_every_cpu_decode_forward_is_eager(cpu_scenarios, quantize_kv):
    sc, recs = cpu_scenarios[quantize_kv]
    check_scenario_ran(sc)
    eager = [r for r in recs if r.name == "decode.eager"]
    by_id = {r.id: r for r in recs}
    assert not any(r.name in ("decode.graph", "decode.capture") for r in recs)
    assert len(eager) == sc.engine.decode_eager > 0
    assert sc.engine.decode_replays == sc.engine.decode_captures == 0
    assert sc.engine._graph is None
    assert all(by_id[r.parent].name == "decode.enqueue" for r in eager)


def test_metrics_export_the_decode_route_counts(cpu_scenarios):
    from videollamb_torch.serve.http_server import Metrics

    engine = cpu_scenarios[True][0].engine

    class Worker:
        def is_alive(self):
            return True

    vals = dict(line.rsplit(" ", 1) for line in Metrics().render(engine, Worker()).splitlines()
                if line and not line.startswith("#"))
    assert float(vals["videollamb_decode_eager_total"]) == engine.decode_eager > 0
    assert float(vals["videollamb_decode_graph_replays_total"]) == 0
    assert float(vals["videollamb_decode_graph_captures_total"]) == 0


def test_graph_share_reads_the_marks():
    from portbench import decode_route
    from videollamb_torch.utils.profiling import Record

    def recs(*names):
        return [Record(i + 1, 0, n, None, float(i), float(i)) for i, n in enumerate(names)]

    assert decode_route.graph_share(recs("decode.graph", "decode.graph", "decode.graph",
                                         "decode.eager", "decode.enqueue")) == 75.0
    assert decode_route.graph_share(recs("decode.eager", "decode.sync")) == 0.0
    assert decode_route.graph_share(recs("decode.graph", "decode.capture")) == 100.0
    assert decode_route.graph_share(recs("decode.enqueue", "decode.sync")) is None
    assert decode_route.graph_share([]) is None


def test_graph_share_metrics_read_a_cpu_run(cpu_model):
    """Both cells' metric files over a timed CPU run: every forward eager, 0 %;
    a window with no step reads nothing."""
    import time

    from portbench.cells.video_qa import StepRecord as BenchStep
    from portbench.readers import RunView, read_metric

    t0 = time.perf_counter()
    sc = run_scenario(*cpu_model, torch.device("cpu"), False)
    t1 = time.perf_counter()
    cell = types.SimpleNamespace(steps=[BenchStep(t0, t1, K, [], {}, {})])
    for name in ("decode_graph_share.mc", "decode_graph_share.sweep"):
        assert read_metric(name, RunView(cell, tiny.videollamb_cfg(), t0, t1, None)) == 0.0
        empty = types.SimpleNamespace(steps=[])
        assert read_metric(name, RunView(empty, tiny.videollamb_cfg(), t0, t1, None)) is None
    assert sc.engine.decode_eager > 0


# --------------------------------------------------------------------------- the card
def _card_model():
    """The benchmark's configuration at two LM layers, bf16 (the kernels' widths)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from portbench.models import build_videollamb, load_config

    cfg = load_config("videollamb-mistral-7b")
    cfg["lm"]["num_hidden_layers"] = 2
    cfg["vision"]["num_hidden_layers"] = 3
    return build_videollamb(cfg, 7, torch.device("cuda"))[:2]


@pytest.mark.cuda
@pytest.mark.parametrize("quantize_kv", [True, False], ids=["int8_pool", "bf16_pool"])
def test_graph_replay_equals_eager_on_the_card(quantize_kv, monkeypatch):
    """The scenario twice on the card: replayed and eager."""
    model, mcfg = _card_model()
    from videollamb_torch.ops.gathered_paged_attention import gathered_paged_attention_int8
    from videollamb_torch.ops.paged_attention_stats import paged_attention_with_stats
    from videollamb_torch.ops.paged_fresh_write import paged_fresh_write
    from videollamb_torch.serve import paged

    assert paged.decode_graph_route(model.lm, torch.device("cuda"))

    def launches():  # K4, K5, K6
        return [fn.launches for fn in (gathered_paged_attention_int8, paged_fresh_write,
                                       paged_attention_with_stats)]

    before = launches()
    graph = run_scenario(model, mcfg, torch.device("cuda"), quantize_kv)
    graph_launches = [b - a for a, b in zip(before, launches())]
    monkeypatch.setattr(paged, "decode_graph_route", lambda lm, device: False)
    before = launches()
    eager = run_scenario(model, mcfg, torch.device("cuda"), quantize_kv)
    eager_launches = [b - a for a, b in zip(before, launches())]

    check_scenario_ran(graph)
    check_scenario_ran(eager)
    forwards = graph.engine.decode_eager + graph.engine.decode_replays
    assert (graph.engine.decode_eager, graph.engine.decode_captures) == (1, 1)
    assert (eager.engine.decode_replays, eager.engine.decode_captures) == (0, 0)
    assert eager.engine.decode_eager == forwards
    # Every kernel of the eager forward runs in each replay, and is counted there.
    layers = mcfg.lm.num_hidden_layers
    want = [forwards * layers, forwards, 0] if quantize_kv else [0, 0, forwards * layers]
    assert graph_launches == eager_launches == want
    assert len(graph.steps) == len(eager.steps)
    for g, e in zip(graph.steps, eager.steps):
        assert g.tokens == e.tokens  # the first step's second forward is the capture's
        assert g.active == e.active and g.lengths == e.lengths and g.swapped == e.swapped
        torch.testing.assert_close(g.logits, e.logits, atol=1e-3, rtol=0)
    assert graph.engine.cache.quantized == quantize_kv
    # A reallocated table drops the graph: the next forward captures again.
    # Every row empty, so neither engine reads a page (the trash page's rows
    # are written by every released row at once, in no fixed order).
    for sc in (graph, eager):
        sc.engine.cache.page_table = torch.zeros_like(sc.engine.cache.page_table)
        sc.engine.cache.lengths.zero_()
    nxt = torch.arange(40, 44, device="cuda")
    with torch.no_grad():
        got, want = graph.engine._forward(nxt), eager.engine._forward(nxt)
    assert (graph.engine.decode_captures, eager.engine.decode_captures) == (2, 0)
    torch.testing.assert_close(got, want, atol=1e-3, rtol=0)


@pytest.mark.cuda
def test_adapters_loaded_after_capture_are_decoded_eagerly():
    """A multi-LoRA stack loaded into a graph-route engine's LM after its
    capture, as the HTTP server's adapter swap loads it: the adapter rows
    decode as in an engine built over the stack, and differ from the base
    rows of the same prompt; the stack dropped, the engine captures again
    and answers as before."""
    model, mcfg = _card_model()
    from videollamb_torch.models.assembly import MultimodalBatch
    from videollamb_torch.models.lm.mlora import add_multi_lora_params, drop_multi_lora_params
    from videollamb_torch.serve.paged import PagedServingEngine
    from videollamb_torch.serve.server import Request

    gen = torch.Generator().manual_seed(5)
    prompts = [torch.randint(40, mcfg.lm.vocab_size, (1, 40), generator=gen) for _ in range(2)]

    def engine(registry=None):
        return PagedServingEngine(model, mcfg, num_slots=4, page_size=PAGE,
                                  pages_per_seq=PAGES_PER_SEQ, total_pages=TOTAL_PAGES,
                                  eos_token_id=EOS, quantize_kv=True, adapter_registry=registry)

    def serve(eng, adapters):
        reqs = []
        for uid, name in enumerate(adapters):
            ids = prompts[uid // 2].cuda()
            reqs.append(Request(uid=uid, batch=MultimodalBatch(ids, torch.ones_like(ids)),
                                max_new_tokens=24, adapter=name))
            eng.submit(reqs[-1])
        with torch.no_grad():
            while eng.has_work():
                eng.step(K)
        assert all(r.done and r.error is None for r in reqs)
        return [list(r.tokens) for r in reqs]

    eng = engine()
    base = serve(eng, [None] * 4)
    assert eng._graph_route and eng.decode_captures == 1 and eng.decode_replays > 0
    layers, d = mcfg.lm.num_hidden_layers, mcfg.lm.hidden_size
    attn = model.lm.model.layers[0].self_attn
    adapter = {}
    for proj in ("q_proj", "v_proj"):
        out = getattr(attn, proj).out_features
        adapter[f"{proj}_lora_a"] = (torch.randn(layers, d, 8, generator=gen) / d ** 0.5).numpy()
        adapter[f"{proj}_lora_b"] = (torch.randn(layers, 8, out, generator=gen) * 0.5).numpy()
    _, registry = add_multi_lora_params(model.lm, {"a": adapter}, dtype=torch.bfloat16)
    eng.set_adapters(model, registry)
    replays, eager = eng.decode_replays, eng.decode_eager
    hot = serve(eng, ["a", None, "a", None])
    assert eng.decode_replays == replays and eng.decode_eager > eager
    assert hot == serve(engine(registry), ["a", None, "a", None])
    assert hot[0] != hot[1] or hot[2] != hot[3]  # the adapter rows took the adapter
    drop_multi_lora_params(model.lm)
    eng.set_adapters(model, None)
    assert serve(eng, [None] * 4) == base
    assert eng.decode_captures == 2 and eng.decode_replays > replays
