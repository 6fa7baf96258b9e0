"""Device intervals for spans: CUDA events, read without a synchronize.

A live span around work the card runs asynchronously times its launches.
``DeviceTimer`` times the work itself: the caller records an event at each
boundary of the device work (``phase``, ``record``), and the interval becomes
an emitted span once both events have completed — found with
``Event.query()`` at a later point of the program (``resolve``), never waited
for.

Events give device time only relative to each other.  An *anchor* places them
on the host's clock: an event recorded, at a known host time, on a stream that
has nothing left to run, so that it completes as it is recorded.  The program
knows two such moments without a synchronize: a device → host copy has just
returned (``anchor``), or the last event this timer recorded has completed
(``anchor_if_idle``; work enqueued after it without an event would make the
anchor late).  Each interval is placed by the newest anchor that has
completed, so its ``t_start_s`` and ``t_trace_ns`` sit on the clocks of the
live spans.
"""

from __future__ import annotations

import contextlib
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, Optional, Tuple

import torch

# a recorded event and its place in the order of this timer's records
Mark = Tuple[int, "torch.cuda.Event"]


@dataclass
class _Interval:
    name: str
    start: Mark
    end: Mark
    trace_id: Optional[str]
    parent_id: Optional[str]
    attrs: Dict[str, Any] = field(default_factory=dict)
    waited_from: Optional[float] = None   # host time its wait for ``start`` began


class DeviceTimer:
    """Event pairs on one CUDA device, emitted as spans once completed.

    Intervals parent to the span open when they are queued.  At most
    ``max_pending`` wait for their events; older ones are dropped
    (``dropped``), as are those still pending at ``close``.
    """

    def __init__(self, tracer, device: torch.device, max_pending: int = 4096):
        self.tracer = tracer
        self.device = device
        self.max_pending = max_pending
        self.dropped = 0
        self._pending: Deque[_Interval] = deque()
        self._anchors: Deque[Tuple[Mark, float]] = deque(maxlen=2)
        self._seq = 0
        self._last: Optional[Mark] = None

    def record(self) -> Mark:
        """An event recorded now on the device's current stream."""
        event = torch.cuda.Event(enable_timing=True)
        event.record(torch.cuda.current_stream(self.device))
        self._seq += 1
        self._last = (self._seq, event)
        return self._last

    def interval(self, name: str, start: Mark, end: Mark, *,
                 waited_from: Optional[float] = None, **attrs: Any) -> None:
        """Queue ``start`` → ``end`` as the span ``name``, a child of the
        span open now."""
        parent = self.tracer.current_span()
        self._pending.append(_Interval(
            name, start, end,
            parent.trace_id if parent else None,
            parent.span_id if parent else None,
            attrs, waited_from,
        ))
        if len(self._pending) > self.max_pending:
            self._pending.popleft()
            self.dropped += 1

    @contextlib.contextmanager
    def phase(self, name: str, *, drains: bool = False, **attrs: Any):
        """The device work enqueued in the block, as the span ``name``, with
        the bytes the caching allocator holds when the block ends.  A block
        that ``drains`` the stream (a device → host copy) ends in an anchor,
        and its span gets ``host_wait_ms``: how long the host waited, from
        the block's start, for the device to reach the block's work."""
        waited_from = time.perf_counter() if drains else None
        start = self.record()
        yield
        if drains:
            end = self.anchor()
        else:
            end = self.record()
            attrs["mem_allocated_bytes"] = torch.cuda.memory_allocated(self.device)
        self.interval(name, start, end, waited_from=waited_from, **attrs)

    def anchor(self) -> Mark:
        """Record an anchor event: the caller has just seen the stream drain
        (a device → host copy returned), so the event completes as it is
        enqueued, and its host time is read as the record returns."""
        mark = self.record()
        self._anchors.append((mark, time.perf_counter()))
        return mark

    def anchor_if_idle(self) -> None:
        """Anchor now if the last event recorded here has completed and is
        not an anchor already."""
        last = self._last
        if last is None or (self._anchors and self._anchors[-1][0] is last):
            return
        if last[1].query():
            self.anchor()

    def _host_s(self, anchor: Tuple[Mark, float], mark: Mark) -> float:
        (a_seq, a_event), t_host = anchor
        seq, event = mark
        if seq >= a_seq:
            return t_host + a_event.elapsed_time(event) / 1e3
        return t_host - event.elapsed_time(a_event) / 1e3

    def resolve(self) -> None:
        """Emit, in order, every queued interval whose events have
        completed; stop at the first that has not.  Never waits."""
        anchor = next((a for a in reversed(self._anchors) if a[0][1].query()), None)
        if anchor is None:
            return
        while self._pending and self._pending[0].end[1].query():
            iv = self._pending.popleft()
            start = self._host_s(anchor, iv.start)
            end = self._host_s(anchor, iv.end)
            if iv.waited_from is not None:
                iv.attrs["host_wait_ms"] = max(0.0, (start - iv.waited_from) * 1e3)
            self.tracer.emit(iv.name, t_start_s=start, duration_s=max(0.0, end - start),
                             trace_id=iv.trace_id, parent_id=iv.parent_id, **iv.attrs)

    def close(self) -> None:
        """Emit what has completed; drop what has not."""
        self.resolve()
        self.dropped += len(self._pending)
        self._pending.clear()
