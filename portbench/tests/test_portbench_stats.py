"""Percentiles and rates are taken over every request and the whole window."""

import numpy as np
import pytest

from portbench import gen, readers
from portbench.cells import video_qa
from portbench.harness import percentile


def test_percentile_is_numpys_linear_over_all_values():
    rng = np.random.default_rng(0)
    xs = list(rng.exponential(size=97))
    for q in (50, 90, 95):
        assert percentile(xs, q) == pytest.approx(float(np.percentile(xs, q)))
    assert percentile([3.0], 90) == 3.0


class _Cell:
    """A serving cell's request records, without an engine."""

    def __init__(self, records):
        self.served = {r.plan.index: r for r in records}
    in_window = video_qa.Cell.in_window
    tokens_in = video_qa.Cell.tokens_in


def _rec(i, submitted, first, done, token_times):
    plan = gen.VideoRequest(index=i, frames=16, ids=[1, -201], answer_tokens=len(token_times),
                            scene_frames=[16], strong_cuts=[], clip_seed=0, prompt_len=1)
    return video_qa.Served(plan=plan, submitted=submitted, first=first,
                             tokens=[5] * len(token_times), token_times=token_times, done=done)


def test_ttft_over_every_request_completed_in_the_window():
    recs = [_rec(i, 10.0 + i, 10.0 + i + 0.1 * (i + 1), 10.5 + i, [10.0 + i + 0.1 * (i + 1)])
            for i in range(20)]
    recs.append(_rec(20, 9.0, 9.5, 9.6, [9.5]))       # before the window
    recs.append(_rec(21, 40.0, 41.0, None, [41.0]))    # not completed
    cell = _Cell(recs)
    view = readers.RunView(cell, {}, 10.0, 35.0, None)
    want = [100.0 * (i + 1) for i in range(20)]
    assert readers.read_metric("ttft_p50_ms.mc", view) == pytest.approx(percentile(want, 50))
    assert readers.read_metric("ttft_p90_ms", view) == pytest.approx(percentile(want, 90))


def test_the_per_layer_median_leaves_out_requests_a_traced_step_admitted():
    recs = [_rec(i, 10.0 + i, 10.0 + i + 0.1 * (i + 1), 10.5 + i, [10.0 + i + 0.1 * (i + 1)])
            for i in range(20)]
    cell = _Cell(recs)
    cell.steps = [video_qa.StepRecord(10.0 + i, 10.5 + i, 4, [i], {i: 1}, {i: 0},
                                      traced=1 if i >= 15 else 0) for i in range(20)]
    view = readers.RunView(cell, {}, 10.0, 35.0, None)
    want = [100.0 * (i + 1) for i in range(15)]
    assert readers.read_metric("ttft_p50_ms.mc", view) == pytest.approx(percentile(want, 50))
    assert readers.read_metric("ttft_p90_ms", view) == pytest.approx(
        percentile([100.0 * (i + 1) for i in range(20)], 90))


def test_rate_counts_every_token_of_the_window_over_the_whole_window():
    recs = [_rec(0, 0.0, 1.0, 3.0, [1.0, 2.0, 3.0]),       # finished inside
            _rec(1, 0.0, 4.0, None, [4.0, 9.0, 11.0])]      # still running at the end
    cell = _Cell(recs)
    view = readers.RunView(cell, {}, 0.5, 10.0, None)
    assert readers.read_metric("output_tokens_per_s", view) == pytest.approx(5 / 9.5)


def test_slot_occupancy_is_tokens_per_decode_step():
    steps = [video_qa.StepRecord(0.0, 1.0, 8, [], {1: 8, 2: 3}, {1: 0, 2: 5}),
             video_qa.StepRecord(1.0, 2.0, 8, [3], {1: 8, 3: 8}, {1: 8, 3: 0}),
             video_qa.StepRecord(2.0, 3.0, 8, [], {}, {})]          # decoded nothing

    class Cell:
        pass

    cell = Cell()
    cell.steps = steps
    view = readers.RunView(cell, {}, 0.0, 3.0, None)
    assert readers.read_metric("slot_occupancy.sweep", view) == pytest.approx(27 / 16)
