"""The traced window: ``torch.profiler`` over the window, reduced to device numbers.

``Window(traced)`` is a context manager around the measured window.  Traced, it
runs ``torch.profiler`` with CPU and CUDA activities and one host range,
``bench.window``, over the whole window; the harness's own ranges
(``annotate``) and the program's (its spans, where tracing is on) mark what the
host was doing.  After the window, ``summary()`` gives:

  busy_s      the union of the intervals in which a device operation (kernel,
              copy, set) ran, inside the window;
  window_s    the window's length on the trace's clock;
  kernels     device seconds by kernel name (the function name, without
              template arguments or parameters);
  device_ops  the ten names that took most device time;
  idle_gaps   the device's idle time inside the window by the innermost host
              range open at the middle of each gap, the ten largest.

Untraced, ``Window`` only brackets the window and ``summary()`` is None.
"""

from __future__ import annotations

import contextlib
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

WINDOW = "bench.window"


def annotate(name: str):
    """A host range on the profiler's timeline (nearly free when no profiler runs)."""
    return torch.profiler.record_function(name)


def base_name(name: str) -> str:
    """``void (anonymous namespace)::reach_group_kernel<9, 4>(unsigned int const*, …)``
    → ``reach_group_kernel``: no return type, namespace, template arguments or
    parameters."""
    bare = re.sub(r"^void\s+", "", name.strip()).replace("(anonymous namespace)::", "")
    bare = re.split(r"[<(]", bare, maxsplit=1)[0].strip()
    return bare.rsplit("::", 1)[-1] or name


@dataclass
class Summary:
    busy_s: float
    window_s: float
    kernels: Dict[str, float]
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)

    def kernel_seconds(self, prefix: str) -> float:
        return sum(s for name, s in self.kernels.items() if name.startswith(prefix))


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def reduce_events(events) -> Summary:
    """The summary of a list of kineto events (``name()``, ``device_type()``,
    ``start_ns()``, ``duration_ns()``, ``is_user_annotation()``)."""
    window = None
    ranges: List[Tuple[int, int, str]] = []
    on_device = []
    for e in events:
        a, d = e.start_ns(), e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            on_device.append(e)
        elif e.is_user_annotation():
            if e.name() == WINDOW:
                window = (a, a + d)
            ranges.append((a, a + d, e.name()))
    # the host's ranges are mirrored on the device's timeline: not operations
    marks = {name for _, _, name in ranges}
    device = [(e.start_ns(), e.start_ns() + e.duration_ns(), base_name(e.name()))
              for e in on_device if not e.is_user_annotation() and e.name() not in marks]
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW!r} range")
    w0, w1 = window
    kernels: Dict[str, float] = {}
    inside = []
    for a, b, name in device:
        a, b = max(a, w0), min(b, w1)
        if b > a:
            kernels[name] = kernels.get(name, 0.0) + (b - a) * 1e-9
            inside.append((a, b))
    busy = _union(inside)
    gaps: Dict[str, float] = {}
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    ranges.sort()
    i, open_ = 0, []
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        mid = (g0 + g1) // 2
        while i < len(ranges) and ranges[i][0] <= mid:
            open_.append(ranges[i])
            i += 1
        open_ = [r for r in open_ if r[1] >= mid]
        label = max(open_)[2] if open_ else WINDOW
        gaps[label] = gaps.get(label, 0.0) + (g1 - g0) * 1e-9
    top = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:10]
    return Summary(busy_s=sum(b - a for a, b in busy) * 1e-9, window_s=(w1 - w0) * 1e-9,
                   kernels=kernels, device_ops=top(kernels), idle_gaps=top(gaps))


class Window:
    def __init__(self, traced: bool):
        self.traced = traced
        self._stack = contextlib.ExitStack()
        self._prof = None

    def __enter__(self) -> "Window":
        if self.traced:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = self._stack.enter_context(torch.profiler.profile(activities=acts))
            self._stack.enter_context(annotate(WINDOW))
        return self

    def __exit__(self, *exc) -> None:
        if self.traced and torch.cuda.is_available():
            torch.cuda.synchronize()
        self._stack.close()

    def summary(self) -> Optional[Summary]:
        if self._prof is None:
            return None
        return reduce_events(self._prof.profiler.kineto_results.events())
