"""What every cell's run shares: paths, the card check, spans, statistics,
the modules check, and the result line."""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)

# NVIDIA H100 SXM data sheet, dense rates: bf16 tensor cores, int8 tensor
# cores, HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
HBM_BYTES_PER_S = 3.35e12
PEAKS = {"bf16": PEAK_BF16_FLOPS, "int8": PEAK_INT8_OPS}

# Top-level module names that must not be loaded by a run: JAX and the JAX
# package the program was ported from.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "videollamb_tpu")

now = time.perf_counter


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def config_path(name: str) -> str:
    return os.path.join(PKG, "configs", name + ".json")


def traffic_path(name: str) -> str:
    return os.path.join(PKG, "traffic", name + ".json")


def limits_path(workload: str) -> str:
    return os.path.join(PKG, "limits", workload + ".json")


def op_path(name: str) -> str:
    return os.path.join(PKG, "ops", name + ".json")


def metric_path(name: str) -> str:
    return os.path.join(PKG, "metrics", name + ".py")


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def forbidden_loaded() -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is forbidden."""
    return sorted({m for m in list(sys.modules) if m.split(".", 1)[0] in FORBIDDEN_MODULES})


def card_name_and_limit() -> str:
    """``name, power.limit`` of the first card as nvidia-smi reads it."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable ({exc.__class__.__name__})"
    return out.strip().splitlines()[0] if out.strip() else "nvidia-smi gave nothing"


# --------------------------------------------------------------------------- statistics
def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0..100) by linear interpolation between order
    statistics (numpy's default), over every value given."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


# --------------------------------------------------------------------------- spans
@dataclass
class Span:
    name: str
    t0: float
    t1: float


class Spans:
    """Host spans recorded by the benchmark around its calls into the program.
    While a profiler runs, each span is also a profiler annotation, so that
    the trace's idle gaps can be told apart by what the host was doing."""

    def __init__(self):
        self.annotate = False

    @contextlib.contextmanager
    def span(self, name: str):
        rec = Span(name, now(), 0.0)
        ctx = contextlib.nullcontext()
        if self.annotate:
            import torch

            ctx = torch.profiler.record_function("pb:" + name)
        with ctx:
            try:
                yield rec
            finally:
                rec.t1 = now()


# --------------------------------------------------------------------------- the window
TRACE_ATTEMPTS = 3


def traced_window(one: Callable[[float, int], None], seconds: float, trace_seconds: float,
                  spans: Spans, device) -> dict:
    """Call ``one(t_start, traced)``, one whole call into the program, until
    ``seconds`` have passed. With ``trace_seconds`` the profiler covers the
    calls from the first boundary ``trace_seconds`` before the close, and the
    window runs on past the close until the traced part has lasted that long,
    so every traced run covers the same length of whole calls. A traced part
    whose record misses device events is traced again, up to
    ``TRACE_ATTEMPTS`` times; ``traced`` is the number of the traced part a
    call belongs to, 0 for none, and the summary says which one it kept."""
    from portbench.trace import Tracer

    tracer = Tracer(spans) if trace_seconds > 0 else None
    attempt = 0
    t_end = None
    t_start = now()
    deadline = t_start + seconds
    while True:
        t = now()
        if tracer is None:
            if t >= deadline:
                break
        elif tracer.active:
            if t - tracer.t0 >= trace_seconds:
                tracer.stop()
                tr = tracer.summary
                if tr.complete or attempt == TRACE_ATTEMPTS:
                    t_end = tracer.t1  # reading the record is not window
                    break
                log(f"[trace] part {attempt} kept {tr.records} device events of "
                    f"{tr.launches} launches: traced again")
        elif t >= deadline - trace_seconds:
            attempt += 1
            tracer.start()
        one(t_start, attempt if tracer is not None and tracer.active else 0)
    if t_end is None:
        if device.type == "cuda":
            import torch

            torch.cuda.synchronize()
        t_end = now()
    summary = None
    if tracer is not None:
        summary = tracer.summary
        summary.attempt = attempt
    return {"t_start": t_start, "t_end": t_end, "trace": summary}


# --------------------------------------------------------------------------- the result
def result_line(*, correct: bool, attempted: int, failed: int, metrics: Dict[str, dict],
                device: dict, checks: Dict[str, dict],
                breakdown: Optional[dict] = None) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks  # last: each compared number beside its limit
    return json.dumps(out)


def metric(value: float, unit: str) -> dict:
    return {"value": float(value), "unit": unit}
