"""The span recorder (``videollamb_torch/utils/profiling.py``) and the spans
of the serving engine, on a tiny paged engine in f32.

The engine's model is the benchmark's seeded build at tiny widths
(``portbench/tests/tiny.py``), so this file imports nothing of JAX and its
card case runs on the card as it is: ``python -m pytest --noconftest -p
no:cacheprovider tests/test_torch_spans.py``. On the CPU: one admitting and
one decode step record the table's spans, well nested and under their
request's uid; tokens are the same with a profiler running, where the spans
are host ``cpu_op`` events and not user annotations; the ring drops its
oldest records and counts them; two threads' spans do not nest; the
benchmark's span readers read a tiny run; ``/metrics`` renders the span
histograms and the paged engine's counters.
"""

from __future__ import annotations

import json
import threading
import time
import types
from typing import NamedTuple

import pytest
import torch

from portbench import gen
from portbench.tests import tiny

K = 4
ENGINE_SPANS = {"engine.step", "engine.admit", "engine.pages", "admit.prefetch", "admit.splice",
                "encode.tower", "encode.bridge", "splice", "admit.readback", "admit.prefill",
                "engine.decode", "decode.enqueue", "decode.sync", "decode.commit",
                "request.queue", "request.first_token"}
REQUEST_SPANS = {"request.queue", "admit.splice", "encode.tower", "encode.bridge", "splice",
                 "admit.prefill", "request.first_token"}


def _model(cfg, device):
    from portbench.models import build_videollamb

    model, mcfg, _ = build_videollamb(cfg, 7, device)
    return cfg, model, mcfg


@pytest.fixture(scope="module")
def cpu_model():
    return _model(tiny.videollamb_cfg(), torch.device("cpu"))


def _requests(cfg, device, n=2, max_new=6):
    from videollamb_torch.models.assembly import MultimodalBatch
    from videollamb_torch.serve.server import Request

    tr = tiny.traffic("mistral7b-mc-longvideo")
    tr["frames"] = [32]
    per_frame = cfg["bridge"]["pool_h"] * cfg["bridge"]["pool_w"]
    out = []
    for i in range(n):
        plan = gen.video_request(tr, 7, i, cfg["lm"]["vocab_size"], per_frame)
        clip = gen.make_clip(plan, tr, cfg["vision"]["image_size"], device,
                             getattr(torch, cfg["dtype"]))
        ids = torch.tensor([plan.ids], device=device)
        out.append(Request(uid=f"r{i}", batch=MultimodalBatch(
            input_ids=ids, attention_mask=torch.ones_like(ids), videos=clip[None]),
            max_new_tokens=max_new))
    return out


class TwoSteps(NamedTuple):
    engine: object
    reqs: list
    steps: list  # the benchmark's step records (portbench/cells/video_qa.StepRecord)
    t0: float
    t1: float


def _two_steps(cfg, model, mcfg, device) -> TwoSteps:
    """Two requests through a 4-slot engine: one admitting step, one decode
    step, each timed and recorded as the benchmark's serving cells do."""
    from portbench.cells.video_qa import StepRecord
    from videollamb_torch.serve.paged import PagedServingEngine

    engine = PagedServingEngine(model, mcfg, num_slots=4, eos_token_id=-1)
    reqs = _requests(cfg, device)
    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r)
    steps = []
    with torch.no_grad():
        for _ in range(2):
            before = {r.uid: len(r.tokens) for r in reqs}
            s0 = time.perf_counter()
            engine.step(K)
            s1 = time.perf_counter()
            committed = {r.uid: len(r.tokens) - before[r.uid] for r in reqs}
            steps.append(StepRecord(s0, s1, K, [u for u, n in before.items() if n == 0],
                                    committed, before))
    return TwoSteps(engine, reqs, steps, t0, time.perf_counter())


@pytest.fixture(scope="module")
def two_steps(cpu_model):
    return _two_steps(*cpu_model, torch.device("cpu"))


def test_steps_record_the_span_table_well_nested(two_steps):
    from videollamb_torch.utils.profiling import RECORDER

    reqs = two_steps.reqs
    recs = RECORDER.records(two_steps.t0, two_steps.t1)
    by_id = {r.id: r for r in recs}
    assert {r.name for r in recs} == ENGINE_SPANS
    assert sum(r.name == "engine.step" for r in recs) == 2
    assert sum(r.name == "decode.enqueue" for r in recs) == 2
    prefetch = next(r for r in recs if r.name == "admit.prefetch")
    assert sum(r.name == "admit.splice" and r.parent == prefetch.id for r in recs) == 2
    for r in recs:
        assert r.t0 <= r.t1
        if r.parent:
            p = by_id[r.parent]  # every parent is recorded, and holds its child
            assert p.t0 <= r.t0 and r.t1 <= p.t1, (p, r)
            assert r.uid == p.uid or p.uid is None, (p, r)
        else:
            assert r.name in ("engine.step", "request.queue"), r
    for req in reqs:
        mine = [r for r in recs if r.uid == req.uid]
        assert {r.name for r in mine} == REQUEST_SPANS
        first = [r for r in mine if r.name == "request.first_token"]
        prefill = [r for r in mine if r.name == "admit.prefill"]
        assert len(first) == 1 and len(prefill) == 1
        assert prefill[0].t1 <= first[0].t0
        assert by_id[first[0].parent].name == "decode.commit"
    assert [len(r.tokens) for r in reqs] == [6, 6]


@pytest.fixture(scope="module")
def profiled(cpu_model, two_steps, tmp_path_factory):
    """The tokens of two engines, the second under a CPU profiler, and the
    profiler's Chrome trace events."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = _two_steps(*cpu_model, torch.device("cpu")).reqs
    path = tmp_path_factory.mktemp("trace") / "trace.json"
    prof.export_chrome_trace(str(path))
    return ([r.tokens for r in two_steps.reqs], [r.tokens for r in traced],
            json.loads(path.read_text())["traceEvents"])


def test_tokens_are_the_same_with_a_profiler_running(profiled):
    plain, traced, _ = profiled
    assert plain == traced and all(plain)


def test_spans_are_host_ops_in_a_profile_not_user_annotations(profiled):
    events = profiled[2]
    cats = {}
    for e in events:
        if e.get("name") in ENGINE_SPANS:
            cats.setdefault(e["name"], set()).add(e.get("cat"))
    marks = {"request.queue", "request.first_token"}  # recorded after the fact: no event
    assert set(cats) == ENGINE_SPANS - marks
    assert all(c == {"cpu_op"} for c in cats.values()), cats


def test_ring_drops_the_oldest_records_and_counts_them():
    from videollamb_torch.utils.profiling import CAPACITY, Recorder

    rec = Recorder()
    for i in range(CAPACITY + 3):
        rec.mark("m", i)
    assert rec.dropped == 3
    kept = rec.records()
    assert len(kept) == CAPACITY
    assert [kept[0].uid, kept[-1].uid] == [3, CAPACITY + 2]
    with rec.span("s", "u"):
        rec.mark("inner")
    assert rec.dropped == 5
    assert [(r.name, r.uid) for r in rec.records()[-2:]] == [("inner", "u"), ("s", "u")]
    agg = rec.aggregates()
    assert agg["s"].count == 1 and sum(agg["s"].buckets) == 1 and "m" not in agg


def test_spans_of_two_threads_do_not_nest():
    from videollamb_torch.utils.profiling import Recorder

    rec = Recorder()
    opened, closed = threading.Event(), threading.Event()

    def worker():
        with rec.span("worker", "w"):
            opened.set()
            assert closed.wait(30)

    t = threading.Thread(target=worker)
    t.start()
    try:
        assert opened.wait(30)
        with rec.span("handler"):
            rec.mark("tick")
    finally:
        closed.set()
        t.join(30)
    assert not t.is_alive()
    by_name = {r.name: r for r in rec.records()}
    assert by_name["handler"].parent == 0 and by_name["handler"].uid is None
    assert by_name["tick"].parent == by_name["handler"].id
    assert by_name["worker"].parent == 0 and by_name["worker"].uid == "w"


def test_the_benchmark_span_readers_read_a_tiny_run(cpu_model, two_steps):
    """The readers over the tiny run's step records: its first step admitted
    both requests (the mc readers' population), its second only decoded
    (the sweep readers')."""
    from portbench.readers import RunView, read_metric
    from videollamb_torch.utils.profiling import span

    cell = types.SimpleNamespace(steps=two_steps.steps)
    view = RunView(cell, cpu_model[0], two_steps.t0, two_steps.t1, None)
    got = {m: read_metric(m, view) for m in ("tower_ms.mc", "bridge_ms.mc", "prefill_ms.mc",
                                             "first_token_wait_ms.mc", "decode_enqueue_ms.sweep",
                                             "decode_sync_ms.sweep")}
    assert all(v is not None and v > 0 for v in got.values()), got
    assert got["decode_enqueue_ms.sweep"] < read_metric("decode_step_ms.sweep", view)
    assert got["first_token_wait_ms.mc"] < read_metric("admit_step_ms.mc", view)

    if read_metric("kernel_load_s", view) is None:  # no kernel library loads on the CPU
        with span("kernels.load"):
            pass
    assert read_metric("kernel_load_s", view) >= 0


def test_metrics_render_span_histograms_and_paged_counters(two_steps):
    from videollamb_torch.serve.http_server import Metrics
    from videollamb_torch.utils.profiling import BUCKETS

    engine, reqs = two_steps.engine, two_steps.reqs

    class Worker:
        def is_alive(self):
            return True

    vals = {}
    for line in Metrics().render(engine, Worker()).splitlines():
        if line and not line.startswith("#"):
            name, val = line.rsplit(" ", 1)
            vals[name] = float(val)
    for key in ("request_queue_seconds", "engine_step_seconds", "engine_admit_seconds",
                "splice_seconds", "admit_prefill_seconds", "engine_pages_seconds",
                "engine_decode_seconds", "decode_commit_seconds", "first_token_seconds"):
        buckets = [vals[f'videollamb_{key}_bucket{{le="{le}"}}'] for le in BUCKETS]
        assert buckets == sorted(buckets)
        assert vals[f'videollamb_{key}_bucket{{le="+Inf"}}'] == vals[f"videollamb_{key}_count"]
        assert vals[f"videollamb_{key}_count"] >= len(reqs)
    assert vals["videollamb_pages_in_use"] == engine.pages_in_use == 0  # both finished
    assert vals["videollamb_pages_in_use_peak"] == engine.peak_pages_in_use > 0
    for key in ("prefix_hits_total", "prefix_misses_total", "prefix_evictions_total",
                "preempted_total", "resumed_total", "spans_dropped_total"):
        assert vals[f"videollamb_{key}"] == 0


@pytest.mark.cuda
def test_a_profiled_step_on_the_card_leaves_no_span_on_the_device():
    """The benchmark's configuration at two LM and two tower layers, bf16
    (the kernels' widths): a profiled admitting and decode step keeps every
    span on the host."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from torch.profiler import ProfilerActivity, profile

    from portbench.models import load_config

    dev = torch.device("cuda")
    cfg = load_config("videollamb-mistral-7b")
    cfg["lm"]["num_hidden_layers"] = 2
    cfg["vision"]["num_hidden_layers"] = 3  # select_layer -2: two layers run
    built = _model(cfg, dev)
    reqs = _two_steps(*built, dev).reqs  # builds and loads the kernels first
    assert [len(r.tokens) for r in reqs] == [6, 6]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _two_steps(*built, dev)
        torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    on_device = [e.name() for e in events if str(e.device_type()).endswith("CUDA")]
    on_host = {e.name() for e in events if not str(e.device_type()).endswith("CUDA")}
    assert on_device, "the profiler recorded no device event"
    assert not ENGINE_SPANS & set(on_device), ENGINE_SPANS & set(on_device)
    assert {"engine.step", "admit.prefill", "decode.sync"} <= on_host
