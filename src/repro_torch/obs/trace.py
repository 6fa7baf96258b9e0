"""Tracing: per-request trace IDs, monotonic-clock spans, a narrow record seam.

The port's copy of ``repro/obs/trace.py``: the same spans, IDs, parenting
and sinks, with ``torch.profiler`` where the reference annotates for
``jax.profiler``.

  ``Span``     one timed operation: name, trace/span/parent IDs, a
               monotonic-clock start, a duration, and a small attribute
               dict.  Spans are plain host-side records; a span around
               device work times it only if the caller synchronizes the
               device before the span closes (``torch.cuda.synchronize``),
               as the engine's phase spans do.

  ``Tracer``   mints trace IDs (one per ``Parser.parse``/``submit``/
               ``append``), opens spans as context managers (parenting via a
               ``contextvars`` stack, so nested phase spans attach to the
               request span automatically), and ``emit``\\ s retroactive
               spans (queue-wait is only known when a batch picks the
               request up).  Finished spans go to a bounded ring buffer and
               to every registered sink — ``obs/export.py``'s
               ``SpanJsonlWriter`` is the standard one.

  profiler     with ``profiler=True`` every span also enters a
               ``torch.profiler.record_function``, so the same phase names
               show up on profiler timelines next to the kernels they wrap.

A disabled tracer (``Tracer(enabled=False)`` — the default every engine
carries) makes ``span``/``emit`` near-free no-ops: instrumentation stays in
place permanently and costs one predicate when off.

Span taxonomy (the reference's):

  parse.request            root — one submit/parse lifetime (queue + device + host)
  parse.queue_wait         submit → batch pickup (service queue residency)
  parse.batch_compute      the batched device program serving the bucket
  stream.append            root — one append lifetime
  stream.append_queue_wait append → piece-batch pickup
  stream.append_compute    the batched tail reach + compose
  stream.query             SLPF / acceptance materialization of a prefix
  stream.edit              one mid-text splice (segment-tree recompose path)
  phase.reach              chunk-product reach (device)
  phase.join               exclusive scan over stacked products (device)
  phase.build_merge        builder&merger over join entries (device)
  phase.host_build         host-side SLPF assembly (unpack + wrap)
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

    # ------------------------------------------------------------------ ids

    def new_trace_id(self) -> Optional[str]:
        """Trace ID for one request — None when tracing is disabled, so
        callers can propagate the field unconditionally."""
        return new_trace_id() if self.enabled else None

    def _new_span_id(self) -> str:
        return f"{next(self._ids):08x}"

    def current_span(self) -> Optional[Span]:
        return self._current.get()

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
        (``time.perf_counter``); callers wrapping device work must
        synchronize the device inside the span (``torch.cuda.synchronize``)
        or the span measures only the launches.
        """
        if not self.enabled:
            yield _NULL_SPAN
            return
        parent = self._current.get()
        sp = Span(
            name=name,
            trace_id=trace_id or (parent.trace_id if parent else None),
            span_id=self._new_span_id(),
            parent_id=parent_id or (parent.span_id if parent else None),
            t_start_s=time.perf_counter(),
            attrs=dict(attrs),
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
        sp = Span(
            name=name,
            trace_id=trace_id,
            span_id=span_id if span_id is not None else self._new_span_id(),
            parent_id=parent_id,
            t_start_s=t_start_s,
            duration_s=duration_s,
            attrs=dict(attrs),
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
