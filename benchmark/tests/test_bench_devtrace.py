"""The profiler reduction: device time as the union of the device
operations, host spans' shadows on the device's timeline left out, and
idle gaps named by the innermost host span."""

from types import SimpleNamespace as NS

import bench_cells  # noqa: F401  (the benchmark on the import path)
import devtrace


def _ev(name, a, b, device):
    return NS(name=name, time_range=NS(start=a, end=b),
              device_type="DeviceType.CUDA" if device else "DeviceType.CPU")


def test_busy_ops_and_gaps():
    events = [_ev("FusedRunner.run", 0, 1000, False),
              _ev("FusedRunner.run", 0, 900, True),       # a span's shadow
              _ev("kernel<float>", 100, 400, True),
              _ev("kernel<float>", 300, 500, True),
              _ev("copy", 800, 900, True),
              _ev("aten::copy_", 600, 700, False)]
    busy, ops, gaps = devtrace.reduce(events, skip=("FusedRunner.run",))
    assert abs(busy - 500e-6) < 1e-12
    assert ops[0][0] == "kernel" and abs(ops[0][1] - 500e-6) < 1e-12
    assert [g[0] for g in gaps] == ["aten::copy_"]
    assert abs(gaps[0][1] - 300e-6) < 1e-12
