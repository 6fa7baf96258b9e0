"""The trace's reduction: busy time, kernel names, idle gaps by host range."""

import _paths  # noqa: F401
import pytest
import torch

from bench import devtrace

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Ev:
    def __init__(self, name, start, dur, dev, user=False):
        self._n, self._a, self._d, self._dev, self._u = name, start, dur, dev, user

    def name(self):
        return self._n

    def start_ns(self):
        return self._a

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._dev

    def is_user_annotation(self):
        return self._u


def test_reduce_events():
    events = [
        Ev(devtrace.WINDOW, 0, 1000, CPU, True),
        Ev("bench.step", 100, 300, CPU, True),
        Ev("bench.step", 100, 300, CUDA, True),              # the range mirrored on the device
        Ev("void (anonymous namespace)::reach_group_kernel<9, 4>(int const*)", 150, 200, CUDA),
        Ev("semiring_mm_tc_kernel<64>(float const*)", 300, 100, CUDA),
        Ev("Memcpy HtoD (Pageable -> Device)", 900, 200, CUDA),   # runs past the window's end
        Ev("bench.wait", 500, 350, CPU, True),
    ]
    s = devtrace.reduce_events(events)
    assert s.window_s == pytest.approx(1e-6)
    assert s.busy_s == pytest.approx(350e-9)          # 150–400 and 900–1000
    assert s.kernels == pytest.approx({"reach_group_kernel": 200e-9, "semiring_mm_tc_kernel": 100e-9,
                                       "Memcpy HtoD": 100e-9})
    assert s.kernel_seconds("reach_") == pytest.approx(200e-9)
    gaps = dict(s.idle_gaps)
    # 0–150 (its middle, 75, before any step) and 400–900 (middle 650, in the wait)
    assert gaps == pytest.approx({devtrace.WINDOW: 150e-9, "bench.wait": 500e-9})


def test_a_trace_needs_its_window():
    with pytest.raises(RuntimeError):
        devtrace.reduce_events([Ev("x", 0, 1, CUDA)])
