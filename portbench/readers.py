"""What the metrics read: the window's request records and spans, the traced
part's summary, and the work counts. Each function returns None where its
cell gives it nothing to read."""

from __future__ import annotations

import importlib.util
from dataclasses import dataclass
from typing import Optional

from portbench import work
from portbench.harness import (
    HBM_BYTES_PER_S,
    PEAK_BF16_FLOPS,
    PEAKS,
    load_json,
    metric_path,
    op_path,
    percentile,
)
from portbench.trace import TraceSummary


@dataclass
class RunView:
    """One run's records, as the metric readers see them."""

    cell: object            # a ``portbench.cells`` module's Cell
    cfg: dict
    t_start: float
    t_end: float
    trace: Optional[TraceSummary]

    @property
    def window_s(self) -> float:
        return self.t_end - self.t_start

    def steps(self, untraced: bool = False):
        """The window's engine steps; ``untraced``: those the profiler did not slow."""
        return [s for s in getattr(self.cell, "steps", ())
                if self.t_start <= s.t0 and s.t1 <= self.t_end and not (untraced and s.traced)]


def read_metric(name: str, view: RunView) -> Optional[float]:
    """``portbench/metrics/<name>.py``'s ``read(view)``."""
    spec = importlib.util.spec_from_file_location("portbench_metric_" + name.replace(".", "_"),
                                                  metric_path(name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(view)


# --------------------------------------------------------------------------- end to end
def ttft_ms(view: RunView, q: float, untraced: bool = False) -> Optional[float]:
    """The q-th percentile of submit (or due time) to first token, in ms, over
    every request submitted and completed in the window; ``untraced``: over
    those of them that a step the profiler did not slow admitted."""
    done = view.cell.in_window(view.t_start, view.t_end)
    if untraced:
        slowed = {uid for s in view.steps() if s.traced for uid in s.admitted}
        done = [r for r in done if r.plan.index not in slowed]
    ttft = [1e3 * (r.first - r.submitted) for r in done]
    return percentile(ttft, q) if ttft else None


def output_tokens_per_s(view: RunView) -> Optional[float]:
    """Every token committed in the window, running requests' too, over the window."""
    return view.cell.tokens_in(view.t_start, view.t_end) / view.window_s


def frames_per_s(view: RunView) -> Optional[float]:
    """Every frame embedded in the window, over the window."""
    return view.cell.frames_done() / view.window_s


# --------------------------------------------------------------------------- per layer
def roofline(view: RunView, op: str) -> Optional[float]:
    """Percent of the least time the traced launches of ``op`` could take
    (bytes at the HBM rate or operations at the peak of its type, whichever
    is longer) in the device time its kernels took."""
    if view.trace is None:
        return None
    spec = load_json(op_path(op))
    ops, nbytes = getattr(work, spec["work"])(view.cell.trace_facts(view.trace.attempt), view.cfg)
    kernel_s = view.trace.matching(spec["kernels"])
    if ops <= 0 or kernel_s <= 0:
        return None
    least = max(nbytes / HBM_BYTES_PER_S, ops / PEAKS[spec["peak"]])
    return 100.0 * least / kernel_s


def idle_share(view: RunView) -> Optional[float]:
    """Percent of the traced window in which no device operation ran."""
    if view.trace is None or view.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - view.trace.busy_s / view.trace.window_s)


def mfu(view: RunView) -> Optional[float]:
    """The window's model operations, counted from shapes, in percent of the
    window at the card's dense bf16 peak."""
    ops = view.cell.model_ops(view.t_start, view.t_end)
    if ops <= 0:
        return None
    return 100.0 * ops / (view.window_s * PEAK_BF16_FLOPS)


def step_ms(view: RunView, admitting: bool, per_decode_step: bool) -> Optional[float]:
    """Mean host wall of the window's untraced step calls that admitted a
    request (``admitting``) or admitted none, per call or per decode step in it."""
    steps = [s for s in view.steps(untraced=True) if bool(s.admitted) == admitting]
    if not steps:
        return None
    total = sum(s.t1 - s.t0 for s in steps)
    n = sum(s.k for s in steps) if per_decode_step else len(steps)
    return 1e3 * total / n


def slot_occupancy(view: RunView) -> Optional[float]:
    """Mean number of slots that committed a token in a decode step: the
    tokens the untraced steps committed, read from the engine's slot table,
    over their decode steps. A slot that finishes early in a step, or waits
    out an admission, counts only for the tokens it committed."""
    steps = [s for s in view.steps(untraced=True) if s.committed]
    if not steps:
        return None
    return sum(sum(s.committed.values()) for s in steps) / sum(s.k for s in steps)
