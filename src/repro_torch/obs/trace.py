"""Tracing: per-request trace IDs, monotonic-clock spans, a narrow record seam.

The port's copy of ``repro/obs/trace.py``: the same spans, IDs, parenting
and sinks, with ``torch.profiler`` where the reference annotates for
``jax.profiler``.

  ``Span``     one timed operation: name, trace/span/parent IDs, a
               monotonic-clock start, a duration, and a small attribute
               dict.  A live span (``Tracer.span``) times the host's work
               between its ends; work the card runs asynchronously is timed
               by CUDA events instead and emitted once they have completed
               (``obs/device.py``), with no synchronize.

  ``Tracer``   mints trace IDs (one per ``Parser.parse``/``submit``/
               ``append``/stream step), opens spans as context managers
               (parenting via a ``contextvars`` stack, so nested spans attach
               to the span around them), and ``emit``\\ s retroactive spans
               (queue-wait is only known when a batch picks the request up;
               a device interval once its events complete).  Finished spans
               go to a bounded ring buffer and to every registered sink —
               ``obs/export.py``'s ``SpanJsonlWriter`` is the standard one.

  clocks       ``t_start_s`` is on ``time.perf_counter``; every span also
               carries ``attrs["t_trace_ns"]``, its start on the clock of the
               profiler's timeline (the system clock, ``time.time_ns``),
               from one (perf_counter, system clock) pair the tracer reads
               when it is made — so any span, live or emitted, can be placed
               against the device's work in a ``torch.profiler`` trace.

  profiler     with ``profiler=True`` every live span also enters a
               ``torch.profiler.record_function``, so the same names show
               up on profiler timelines as host ranges.

A disabled tracer (``Tracer(enabled=False)`` — the default every engine
carries) makes ``span``/``emit`` near-free no-ops; the hot paths test
``enabled`` once and build no span at all when it is off.

Span taxonomy.  A parse (``Parser.parse``, ``submit``, ``parse_batch``):

  parse.request            root — submit → collection (live in ``Parser.parse``)
  parse.plan               ``classes_of_text`` + the bucket (``n_chars``)
  parse.admit              deadline / budget admission (``bucket``)
  parse.queue_wait         submit → batch pickup (service queue residency)
  parse.batch_compute      the batch's ``_execute``, live, in the head request's
                           trace (``batch_size``); each rider gets an emitted
                           copy (``batch_trace_id``: the trace holding the phases)
  phase.pad                the batch grid, the class-id check, host → device
                           (``bytes``)
  phase.reach              chunk-product reach         } the fused core's calls:
  phase.join               exclusive scan + C₀         } device intervals on the
  phase.build_merge        builder&merger, packed      } card (``bucket``,
                                                       } ``mem_allocated_bytes``)
  phase.d2h                the forest's columns unpacked (on the card: one
                           launch) and copied back into a fresh array a text
                           (``bytes``: the columns' bytes; on the card
                           ``host_wait_ms``: the host's wait before it began)
  phase.host_build         one text's SLPF around its columns (``n_chars``,
                           ``minor_faults``, ``unpacked_on``: "device" on the
                           card, else "host")
  phase.device_parse       a mesh engine's whole distributed parse (queue-free)

A stream (``ParserStream``, ``StreamService``):

  stream.append            root — one append lifetime
  stream.append_admit      classes, admission and enqueue of the append
  stream.append_queue_wait append → piece-batch pickup
  stream.append_compute    pickup → the end of the step's host work (the
                           card may still be running the step's reach)
  stream.step              root — one service step's host time (``sessions``,
                           ``pieces``, ``chars``, ``composes``, ``seals``)
  stream.pack              the step's piece grid, host → device
  stream.reach             the batched reach: a device interval on the card,
                           emitted at the service's next step / drain / query
  stream.absorb            the per-session compose / seal loop
  stream.query             SLPF / acceptance materialization of a prefix
  stream.edit              one mid-text splice (segment-tree recompose path)
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional

# Span dict schema — the JSONL contract ``export.validate_span_dict`` checks.
SPAN_SCHEMA_KEYS = (
    "name", "trace_id", "span_id", "parent_id", "t_start_s", "duration_s",
    "attrs",
)


def new_trace_id() -> str:
    """A fresh 16-hex-char trace ID (random — process-unique is enough)."""
    return uuid.uuid4().hex[:16]


@dataclass
class Span:
    """One finished (or in-flight) timed operation."""

    name: str
    trace_id: Optional[str]
    span_id: str
    parent_id: Optional[str]
    t_start_s: float              # monotonic (time.perf_counter) origin
    duration_s: float = 0.0
    attrs: Dict[str, Any] = field(default_factory=dict)

    def set_attr(self, key: str, value: Any) -> None:
        self.attrs[key] = value

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "t_start_s": self.t_start_s,
            "duration_s": self.duration_s,
            "attrs": self.attrs,
        }


class _NullSpan:
    """Attribute sink for disabled tracers (``set_attr`` is a no-op)."""

    __slots__ = ()

    def set_attr(self, key: str, value: Any) -> None:
        pass


_NULL_SPAN = _NullSpan()
def _clock_pair() -> tuple:
    """(``perf_counter_ns``, ``time_ns``) read together: the profiler's
    timeline is on the system clock, spans on ``perf_counter``."""
    before = time.perf_counter_ns()
    wall = time.time_ns()
    return (before + time.perf_counter_ns()) // 2, wall


class Tracer:
    """Span factory + ring buffer + sink fan-out (thread-safe on record)."""

    def __init__(
        self,
        *,
        enabled: bool = True,
        max_spans: int = 4096,
        profiler: bool = False,
    ):
        self.enabled = enabled
        self.profiler = profiler
        self.spans: Deque[Span] = deque(maxlen=max(1, max_spans))
        self._sinks: List[Callable[[Span], None]] = []
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        # the innermost open span of the current context — nested ``span()``
        # calls parent to it without explicit plumbing
        self._current: contextvars.ContextVar[Optional[Span]] = (
            contextvars.ContextVar("repro_torch_obs_current_span", default=None)
        )
        self._perf_ns, self._wall_ns = _clock_pair()

    # ------------------------------------------------------------------ ids

    def new_trace_id(self) -> Optional[str]:
        """Trace ID for one request — None when tracing is disabled, so
        callers can propagate the field unconditionally."""
        return new_trace_id() if self.enabled else None

    def _new_span_id(self) -> str:
        return f"{next(self._ids):08x}"

    def current_span(self) -> Optional[Span]:
        return self._current.get()

    def trace_ns(self, t_s: float) -> int:
        """A ``time.perf_counter`` reading on the profiler timeline's clock
        (nanoseconds of the system clock)."""
        return self._wall_ns + round(t_s * 1e9) - self._perf_ns

    # ---------------------------------------------------------------- spans

    @contextlib.contextmanager
    def span(
        self,
        name: str,
        *,
        trace_id: Optional[str] = None,
        parent_id: Optional[str] = None,
        **attrs: Any,
    ):
        """Open a timed span around a block; parents to the context span.

        The yielded object supports ``set_attr``.  Timing is monotonic
        (``time.perf_counter``) and of the host: a block that launches
        device work and does not wait for it times the launches (device
        intervals: ``obs/device.py``).
        """
        if not self.enabled:
            yield _NULL_SPAN
            return
        parent = self._current.get()
        t0 = time.perf_counter()
        attrs["t_trace_ns"] = self.trace_ns(t0)
        sp = Span(
            name=name,
            trace_id=trace_id or (parent.trace_id if parent else None),
            span_id=self._new_span_id(),
            parent_id=parent_id or (parent.span_id if parent else None),
            t_start_s=t0,
            attrs=attrs,
        )
        token = self._current.set(sp)
        try:
            if self.profiler:
                import torch.profiler  # lazy: only the profiler path pays torch

                with torch.profiler.record_function(name):
                    yield sp
            else:
                yield sp
        finally:
            sp.duration_s = time.perf_counter() - sp.t_start_s
            self._current.reset(token)
            self._record(sp)

    def emit(
        self,
        name: str,
        *,
        t_start_s: float,
        duration_s: float,
        trace_id: Optional[str] = None,
        parent_id: Optional[str] = None,
        span_id: Optional[str] = None,
        **attrs: Any,
    ) -> Optional[Span]:
        """Record a retroactive span from already-measured times.

        The queue-wait seam: a request's wait is only known when a batch
        picks it up, so the service emits the span after the fact with the
        original enqueue time as ``t_start_s``.  ``span_id`` may be a
        pre-minted id (services mint the root id at submit so mid-flight
        children can parent to a root written later).
        """
        if not self.enabled:
            return None
        attrs["t_trace_ns"] = self.trace_ns(t_start_s)
        sp = Span(
            name=name,
            trace_id=trace_id,
            span_id=span_id if span_id is not None else self._new_span_id(),
            parent_id=parent_id,
            t_start_s=t_start_s,
            duration_s=duration_s,
            attrs=attrs,
        )
        self._record(sp)
        return sp

    # ---------------------------------------------------------------- sinks

    def add_sink(self, sink: Callable[[Span], None]) -> None:
        """Register a sink called with every finished span (e.g.
        ``SpanJsonlWriter.record``)."""
        self._sinks.append(sink)

    def _record(self, sp: Span) -> None:
        with self._lock:
            self.spans.append(sp)
        for sink in self._sinks:
            sink(sp)

    def drain(self) -> List[Span]:
        """Return and clear the buffered spans (ring-buffer snapshot)."""
        with self._lock:
            out = list(self.spans)
            self.spans.clear()
        return out


#: Shared disabled tracer for layers constructed without observability.
NULL_TRACER = Tracer(enabled=False, max_spans=1)
