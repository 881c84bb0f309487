"""The traced part of a window: torch.profiler over whole calls, reduced to
device busy time, time per kernel name, and idle gaps by host activity."""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

from portbench.harness import Spans, now

NAME_CHARS = 160
# Host calls each of which puts one operation on the device: the profiler's
# record of a traced part is complete when it holds a device event for each.
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpyAsync", "cudaMemsetAsync")


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernel_s: Dict[str, float]                      # device seconds by kernel name
    gaps: List[Tuple[str, float]] = field(default_factory=list)  # idle seconds by host activity
    clock_ratio: float = 1.0  # the device timeline's reading of the window over the host's
    launches: int = 0         # host calls that launch a device operation
    records: int = 0          # device events the profiler kept
    attempt: int = 1          # which traced part of the window this is

    @property
    def complete(self) -> bool:
        """The profiler kept a device event for (nearly) every launch: it drops
        whole stretches of records at times, which would read as idle time and
        shorten every kernel's total."""
        return self.records >= self.launches - max(2, self.launches // 500)

    def matching(self, patterns) -> float:
        """Device seconds of the kernels whose name holds any of ``patterns``."""
        return sum(s for name, s in self.kernel_s.items() if any(p in name for p in patterns))


class Tracer:
    """Profiles from :meth:`start` to :meth:`stop`, both at call boundaries
    after a device synchronisation, so the work of the calls in between is
    inside the trace whole.

    A one-element fill on the device opens and closes the traced part: the
    two marker kernels are its first and last device events, so the device
    timeline's span between them is the window as the device's clock reads
    it. Device durations are put on the host clock by the ratio of the two
    readings of that window, whatever the rate at which the profiler's
    device timestamps run (``clock_ratio``: device reading over host)."""

    def __init__(self, spans: Spans):
        self.spans = spans
        self.prof = None
        self.t0 = self.t1 = 0.0
        self.summary: Optional[TraceSummary] = None
        self._marker = torch.zeros(1, device="cuda") if torch.cuda.is_available() else None

    @property
    def active(self) -> bool:
        return self.prof is not None

    def _mark(self) -> None:
        if self._marker is not None:
            self._marker.fill_(1.0)

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=activities)
        self.prof.__enter__()
        self.spans.annotate = True
        self.t0 = now()
        self._mark()

    def stop(self) -> None:
        """Close the traced part at ``t1``, then read the profiler's record
        (which takes seconds, and is no part of the traced work)."""
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            self._mark()
            torch.cuda.synchronize()
        self.t1 = now()
        self.spans.annotate = False
        self.prof.__exit__(None, None, None)
        self.summary = summarize(self.prof.profiler.kineto_results.events(), self.t1 - self.t0)
        self.prof = None


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _on_device(e) -> bool:
    return str(e.device_type()).endswith("CUDA")


def summarize(events, window_s: float) -> TraceSummary:
    """Device events (kernels, copies, sets) against host events (operators,
    runtime calls, the benchmark's ``pb:`` spans); device-side copies of the
    spans are not work. ``window_s`` is the host clock's reading of the
    traced part; device time is converted to it by the span of the device
    events, which the tracer's marker kernels open and close."""
    kernel_ns: Dict[str, int] = defaultdict(int)
    launches = 0
    device: List[Tuple[int, int]] = []
    host: List[Tuple[int, int, str]] = []
    spans: List[Tuple[int, int, str]] = []
    for e in events:
        name = e.name()
        a, b = e.start_ns(), e.end_ns()
        if _on_device(e):
            if name.startswith("pb:"):
                continue
            device.append((a, b))
            kernel_ns[name[:NAME_CHARS]] += b - a
        elif name.startswith("pb:"):
            spans.append((a, b, name[3:]))
        else:
            host.append((a, b, name))
            launches += name.startswith(LAUNCH_CALLS)
    merged = _merge(device)
    busy_ns = sum(b - a for a, b in merged)
    span_ns = merged[-1][1] - merged[0][0] if merged else 0
    to_s = window_s / span_ns if span_ns > 0 else 1e-9
    gaps = [(k, v * to_s * 1e9) for k, v in _gaps(merged, host, spans)]
    return TraceSummary(window_s=window_s, busy_s=busy_ns * to_s,
                        kernel_s={k: v * to_s for k, v in kernel_ns.items()}, gaps=gaps,
                        clock_ratio=span_ns / 1e9 / window_s if window_s > 0 else 1.0,
                        launches=launches, records=len(device))


def _gaps(merged, host, spans) -> List[Tuple[str, float]]:
    """Idle seconds between device work, summed by the innermost host
    activity at each gap's middle, under the benchmark's own span there.
    One sweep over the gaps and the host events, both in time order; host
    events of one thread nest, so the open ones form a stack."""
    gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)]
    host.sort()
    spans.sort()
    by_name: Dict[str, float] = defaultdict(float)
    stack: List[Tuple[int, int, str]] = []
    i = j = 0
    for a, b in gaps:
        mid = (a + b) // 2
        while i < len(host) and host[i][0] <= mid:
            while stack and stack[-1][1] < host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        while j < len(spans) and spans[j][1] < mid:
            j += 1
        span = spans[j][2] if j < len(spans) and spans[j][0] <= mid else "outside spans"
        inner = stack[-1][2] if stack else "no host activity"
        by_name[f"{span} > {inner}"[:NAME_CHARS]] += (b - a) / 1e9
    return sorted(by_name.items(), key=lambda kv: -kv[1])
