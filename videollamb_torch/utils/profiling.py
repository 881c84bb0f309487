"""Profiling: ``torch.profiler`` traces and per-stage wall-clock timers.

Port of ``videollamb_tpu/utils/profiling.py``:

- ``profile_trace`` records the host and, on a card, the device activity of
  its block with ``torch.profiler`` and writes a Chrome trace
  (``trace.json`` under ``log_dir``; open it in chrome://tracing or
  Perfetto);
- ``StageTimer`` sums named host-side stage times. A stage's ``sync`` (a
  tensor, or a CUDA stream) is synchronised on before its clock stops, so
  device work queued in the stage counts to it, as JAX's
  ``block_until_ready`` does.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional, Union

import torch


@contextlib.contextmanager
def profile_trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _synchronize(sync: Union[torch.Tensor, "torch.cuda.Stream"]) -> None:
    if isinstance(sync, torch.Tensor):
        if sync.device.type == "cuda":
            torch.cuda.current_stream(sync.device).synchronize()
    else:
        sync.synchronize()


class StageTimer:
    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, sync: Optional[Union[torch.Tensor, "torch.cuda.Stream"]] = None
              ) -> Iterator[None]:
        start = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                _synchronize(sync)
            self.totals[name] += time.perf_counter() - start
            self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "total_s": round(self.totals[name], 4),
                "count": self.counts[name],
                "mean_ms": round(1e3 * self.totals[name] / max(self.counts[name], 1), 2),
            }
            for name in self.totals
        }

    def report(self) -> str:
        return "\n".join(f"{k}: {v['total_s']}s over {v['count']} calls "
                         f"({v['mean_ms']} ms/call)" for k, v in self.summary().items())
