"""The trace reduction: busy time is the union of device intervals, kernels
sum by name, and idle gaps go to the host activity at their middle."""

import pytest

from portbench import readers, trace


class _Ev:
    def __init__(self, name, a, b, device):
        self._n, self._a, self._b, self._d = name, a, b, device

    def name(self):
        return self._n

    def start_ns(self):
        return self._a

    def end_ns(self):
        return self._b

    def duration_ns(self):
        return self._b - self._a

    def device_type(self):
        return "DeviceType.CUDA" if self._d else "DeviceType.CPU"


def test_busy_kernels_and_gaps():
    events = [
        _Ev("FillFunctor", 0, 10, True),     # the tracer's opening marker
        _Ev("FillFunctor", 990, 1000, True),  # and its closing one
        _Ev("pb:engine.step", 0, 1000, False),
        _Ev("aten::mm", 0, 100, False),
        _Ev("cudaStreamSynchronize", 500, 900, False),
        _Ev("gemm", 100, 300, True),
        _Ev("gemm", 250, 400, True),         # overlaps the first
        _Ev("resident_kernel<false>", 900, 950, True),
        _Ev("pb:engine.step", 100, 950, True),  # a device copy of the span: not work
    ]
    s = trace.summarize(events, window_s=1e-6)
    assert s.busy_s == pytest.approx(370e-9)
    assert s.kernel_s["gemm"] == pytest.approx(350e-9)
    assert s.matching(["resident_kernel"]) == pytest.approx(50e-9)
    assert s.gaps[0] == ("engine.step > cudaStreamSynchronize", pytest.approx(500e-9))
    assert s.clock_ratio == pytest.approx(1.0)
    assert s.complete  # no launch calls in these events


def test_a_record_that_misses_device_events_is_incomplete():
    launches = [_Ev("cudaLaunchKernel", 10 * i, 10 * i + 2, False) for i in range(1000)]
    kernels = [_Ev("gemm", 10 * i + 3, 10 * i + 8, True) for i in range(1000)]
    assert trace.summarize(launches + kernels, 1e-5).complete
    assert trace.summarize(launches + kernels[:998], 1e-5).complete  # within 1 in 500
    kept = kernels[:400] + kernels[470:]  # a stretch of 70 records dropped
    s = trace.summarize(launches + kept, 1e-5)
    assert not s.complete and (s.launches, s.records) == (1000, 930)


def test_device_time_is_read_on_the_host_clock():
    """A device timeline that runs 3 % fast against the host: durations are
    scaled back, so busy time never exceeds the window."""
    events = [_Ev("FillFunctor", 0, 10, True), _Ev("gemm", 10, 1020, True),
              _Ev("FillFunctor", 1020, 1030, True)]
    s = trace.summarize(events, window_s=1000e-9)
    assert s.clock_ratio == pytest.approx(1.03)
    assert s.busy_s == pytest.approx(s.window_s)
    assert s.kernel_s["gemm"] == pytest.approx(1010e-9 / 1.03)


def test_roofline_and_idle_readers():
    s = trace.TraceSummary(window_s=2.0, busy_s=0.5, kernel_s={"resident_kernel<false>": 1e-3})

    class Cell:
        def trace_facts(self, part):
            return {"encodes": [(64, 1)]}

    cfg = {"vision": {"image_size": 224, "patch_size": 14, "hidden_size": 1024,
                      "num_attention_heads": 16, "num_frames": 8}}
    view = readers.RunView(Cell(), cfg, 0.0, 2.0, s)
    # (64, 257, 1024): 134.7 MB at 3.35 TB/s, 0.0402 ms, in 1 ms of kernel time.
    assert readers.roofline(view, "k1") == pytest.approx(100 * 134.7e6 / 3.35e12 / 1e-3, rel=1e-3)
    assert readers.idle_share(view) == pytest.approx(75.0)
    assert readers.roofline(readers.RunView(Cell(), cfg, 0.0, 2.0, None), "k1") is None
