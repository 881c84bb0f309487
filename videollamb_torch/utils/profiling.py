"""Spans: where the program's host time goes, recorded as it runs.

``span(name, uid=None)`` times a block on ``time.perf_counter`` and records
``(id, parent id, name, uid, t0, t1)``. The parent is the innermost span
open in the same thread (each thread keeps its own stack, so the HTTP
worker's spans and a handler thread's never nest into each other). ``uid``
is the request's ``Request.uid``; a span given none takes its parent's, so
every span below a request's span carries the request's identifier.
``mark(name, uid)`` records a zero-length event.

Recording is always on. A span takes no tensor and never waits for the
device: its times are host times, and the device may still be running the
work a span queued when the span closes. Spans sit at the serving engine's
and the model's layer boundaries, never inside a per-layer or per-kernel
loop; the device trace covers those.

Records go into a ring of ``CAPACITY`` entries in memory, the oldest dropped
first and counted (:attr:`Recorder.dropped`). :meth:`Recorder.records`
returns the records between two times; :meth:`Recorder.aggregates` the count,
sum and histogram buckets of every name's seconds, for ``/metrics``.

Device counters. What a replayed CUDA graph does on the device cannot be
spanned from the host, so the DeepSeek-V3 family's MoE blocks count in
place on the device (``models/lm/mla.py``: tokens routed to each expert, and
the forwards in which each had any); the paged engine reads them between
steps (``PagedServingEngine.expert_load``) and :func:`expert_load_summary`
reduces them for ``/metrics``. The engine's pool reports its bytes a token
(``kv_bytes_per_token``) beside the pages in use.

While a ``torch.profiler`` is recording, each span is also a host event in
its record (``_RecordFunctionFast``, a plain CPU op with no device-side
copy), so the trace's idle gaps can be put under the program's innermost
span.
"""

from __future__ import annotations

import bisect
import functools
import itertools
import threading
import time
from collections import deque
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

CAPACITY = 1 << 16
# Upper bounds (seconds) of the histogram buckets, as Prometheus' ``le``.
BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
           10.0, 30.0)

_now = time.perf_counter
_profiler_enabled = torch._C._autograd._profiler_enabled
_Annotation = torch._C._profiler._RecordFunctionFast


class Record(NamedTuple):
    id: int
    parent: int  # 0: no parent
    name: str
    uid: Any
    t0: float
    t1: float


class Aggregate(NamedTuple):
    count: int
    total: float
    buckets: Tuple[int, ...]  # per bucket of BUCKETS, then the overflow; not cumulative


class Span:
    """One open span; a context manager. Use :func:`span` or :meth:`Recorder.span`."""

    __slots__ = ("_recorder", "_stack", "name", "uid", "id", "parent", "t0", "_annotation")

    def __init__(self, recorder: "Recorder", name: str, uid: Any = None):
        self._recorder = recorder
        self.name = name
        self.uid = uid

    def __enter__(self) -> "Span":
        rec = self._recorder
        try:
            stack = rec._local.stack
        except AttributeError:
            stack = rec._stack()
        self._stack = stack
        if stack:
            top = stack[-1]
            self.parent = top.id
            if self.uid is None:
                self.uid = top.uid
        else:
            self.parent = 0
        self.id = next(rec._ids)
        stack.append(self)
        self._annotation = None
        if _profiler_enabled():
            self._annotation = _Annotation(self.name)
            self._annotation.__enter__()
        self.t0 = _now()
        return self

    def __exit__(self, *exc) -> None:
        t1 = _now()
        if self._annotation is not None:
            self._annotation.__exit__(None, None, None)
        self._stack.pop()
        self._recorder._add((self.id, self.parent, self.name, self.uid, self.t0, t1),
                            t1 - self.t0)


class Recorder:
    """The ring of records and the per-name aggregates; thread-safe."""

    def __init__(self):
        self._ring: deque = deque(maxlen=CAPACITY)  # Record fields as plain tuples
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._written = 0
        self._aggregates: Dict[str, list] = {}  # name -> [seconds, *bucket counts]

    def _stack(self) -> List[Span]:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def _add(self, rec: tuple, seconds: Optional[float]) -> None:
        with self._lock:
            self._ring.append(rec)
            self._written += 1
            if seconds is not None:
                agg = self._aggregates.get(rec[2])
                if agg is None:
                    agg = self._aggregates[rec[2]] = [0.0] + [0] * (len(BUCKETS) + 1)
                agg[0] += seconds
                agg[1 + bisect.bisect_left(BUCKETS, seconds)] += 1

    def span(self, name: str, uid: Any = None) -> Span:
        return Span(self, name, uid)

    def mark(self, name: str, uid: Any = None, since: Optional[float] = None) -> None:
        """A zero-length record now, under the innermost open span; with
        ``since`` (a ``perf_counter`` time) the name's aggregate takes the
        seconds from then to now, else the mark is in no aggregate."""
        t = _now()
        stack = self._stack()
        parent = stack[-1] if stack else None
        if uid is None and parent is not None:
            uid = parent.uid
        self._add((next(self._ids), parent.id if parent is not None else 0, name, uid, t, t),
                  None if since is None else t - since)

    def add(self, name: str, uid: Any, t0: float, t1: float) -> None:
        """A span that began before anything could open it (a request's wait
        in the queue), recorded when it ends; it has no parent."""
        self._add((next(self._ids), 0, name, uid, t0, t1), t1 - t0)

    @property
    def dropped(self) -> int:
        """Records the ring has dropped to make room."""
        with self._lock:
            return self._written - len(self._ring)

    def records(self, t0: float = float("-inf"), t1: float = float("inf")) -> List[Record]:
        """The records that lie wholly between ``t0`` and ``t1``, oldest first."""
        with self._lock:
            ring = list(self._ring)
        return [Record(*r) for r in ring if t0 <= r[4] and r[5] <= t1]

    def aggregates(self) -> Dict[str, Aggregate]:
        """Every name's count, sum of seconds and histogram buckets so far."""
        with self._lock:
            return {k: Aggregate(sum(a[1:]), a[0], tuple(a[1:]))
                    for k, a in self._aggregates.items()}


RECORDER = Recorder()
span = functools.partial(Span, RECORDER)  # span(name, uid=None), into RECORDER
mark = RECORDER.mark


def expert_load_summary(load) -> Tuple[int, List[float]]:
    """(tokens routed over every MoE layer and expert, each layer's busiest
    expert's tokens over the mean expert's, 0 before any token) from the
    (2, layers, experts) counters of ``PagedServingEngine.expert_load``."""
    tokens = load[0]
    ratios = []
    for row in tokens:
        mean = float(row.sum()) / len(row)
        ratios.append(float(row.max()) / mean if mean > 0 else 0.0)
    return int(tokens.sum()), ratios
