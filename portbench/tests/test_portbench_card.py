"""On the card, at each cell's own size: a run with the float8 control in
the program's place comes out not correct through the harness's own
comparison, while the program's number of that window is inside the limit.
Runs on a CUDA card only (``python -m pytest portbench/tests -m card``)."""

import pytest

from portbench import control
from portbench.harness import load_json, traffic_path
from portbench.tests import tiny


@pytest.mark.card
@pytest.mark.parametrize("workload", tiny.WORKLOADS)
def test_program_inside_control_outside(card, workload):
    # A short window at the cell's own load, long enough to finish the mix's
    # longest answers and to compare as many requests as a run does.
    seconds = load_json(traffic_path(tiny.cell(workload)["traffic"]))["check"]["control_window_s"]
    row = control.readings(workload, 2 ** 31 + 991, seconds, True, card)
    assert row["correct"] is False, row
    failed = [k for k, c in row["checks"].items() if c["value"] > c["limit"]]
    assert failed, row
    for k in failed:
        assert row["program"][k] <= row["checks"][k]["limit"], row
