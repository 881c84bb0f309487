"""The window's loop at tiny widths on the CPU: arrivals as the mix says,
step records read from the engine's slot table, and a traced part that
covers its full length."""

import copy

import pytest
import torch

from portbench.cells import clip_batches, video_qa
from portbench.harness import Spans
from portbench.tests import tiny


def test_an_open_loop_mix_runs_and_times_from_due_times(capsys):
    mix = copy.deepcopy(tiny.traffic("mistral7b-mc-longvideo"))
    mix["arrivals"] = {"kind": "open", "rate_per_s": 3.0, "burst": 2}
    res = tiny.run_tiny("mistral7b-mc-longvideo", 3.0, capsys=capsys, mix=mix)
    assert res["correct"] is True
    assert res["metrics"]["ttft_p90_ms"]["value"] > 0


def test_committed_tokens_from_the_slot_table_are_every_token_served():
    torch.set_grad_enabled(False)
    cell = video_qa.Cell(tiny.videollamb_cfg(), tiny.traffic("mistral7b-sweep-24slots"),
                         tiny.SEED, torch.device("cpu"), Spans())
    cell.warm_up()
    win = cell.window(2.0)
    assert cell.steps and all(win["t_start"] <= s.t0 for s in cell.steps)
    assert all(sum(s.committed.values()) <= s.k * 3 for s in cell.steps)
    hooked = sum(1 for r in cell.served.values() for t in r.token_times if t >= win["t_start"])
    assert sum(sum(s.committed.values()) for s in cell.steps) == hooked > 0


@pytest.mark.parametrize("seconds", [0.3, 1.0])
def test_the_traced_part_lasts_its_full_length(seconds):
    torch.set_grad_enabled(False)
    cell = clip_batches.Cell(tiny.languagebind_cfg(), tiny.traffic("languagebind-video-index"),
                             tiny.SEED, torch.device("cpu"), Spans())
    cell.warm_up()
    win = cell.window(seconds, trace_seconds=0.6)
    assert win["trace"].window_s >= 0.6
    assert win["t_end"] - win["t_start"] >= max(seconds, 0.6)
    assert cell.traced_encodes[win["trace"].attempt] >= 1


def test_an_incomplete_traced_part_is_traced_again(monkeypatch):
    from portbench import harness, trace

    real = trace.summarize
    calls = []

    def drops_the_first(events, window_s):
        s = real(events, window_s)
        calls.append(s)
        if len(calls) == 1:
            s.launches, s.records = 1000, 900
        return s

    monkeypatch.setattr(trace, "summarize", drops_the_first)
    torch.set_grad_enabled(False)
    cell = clip_batches.Cell(tiny.languagebind_cfg(), tiny.traffic("languagebind-video-index"),
                             tiny.SEED, torch.device("cpu"), Spans())
    cell.warm_up()
    win = cell.window(0.3, trace_seconds=0.4)
    assert len(calls) == 2 and win["trace"].attempt == 2 and win["trace"].complete
    assert set(cell.traced_encodes) == {1, 2}
    assert win["t_end"] - win["t_start"] >= 0.8
    assert harness.TRACE_ATTEMPTS >= 2


def test_reading_the_record_is_not_window(monkeypatch):
    import time

    from portbench import trace

    real = trace.summarize

    def slow(events, window_s):
        time.sleep(1.0)
        return real(events, window_s)

    monkeypatch.setattr(trace, "summarize", slow)
    torch.set_grad_enabled(False)
    cell = clip_batches.Cell(tiny.languagebind_cfg(), tiny.traffic("languagebind-video-index"),
                             tiny.SEED, torch.device("cpu"), Spans())
    cell.warm_up()
    t0 = time.perf_counter()
    win = cell.window(0.2, trace_seconds=0.3)
    assert time.perf_counter() - t0 >= 1.3
    assert win["t_end"] - win["t_start"] < win["trace"].window_s + 0.5
