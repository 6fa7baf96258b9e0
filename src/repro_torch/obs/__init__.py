"""Observability: tracing spans, a metrics registry, exporters.

The port's copy of ``repro/obs``.  Every ``ParserEngine`` carries an
``ObsHandle`` — a (tracer, metrics registry) pair — and every layer built
over that engine (phase spans, ``StreamingParser``, both services, the
``Parser`` facade) records into it through narrow seams:

    with engine.obs.span("parse.plan", n_chars=n):          # host work
        ...
    with engine.obs.phase(engine.device, "phase.reach"):    # device work
        ...launches, not waited for...
    engine.obs.metrics.counter("stream_evictions_total").inc()

The handle is always present (a disabled tracer + live registry by default);
the hot paths test ``enabled`` once and, when it is off, build no span and
record no event.  ``ParserConfig(obs=ObsConfig(enabled=True,
span_log=...))`` switches a parser's handle to a recording tracer with a
JSONL sink and, with ``profiler=True``, ``torch.profiler.record_function``
ranges.

Submodules:

  trace.py     ``Span``/``Tracer`` — monotonic spans, trace IDs, the span
               taxonomy, the profiler timeline's clock (``t_trace_ns``).
  device.py    ``DeviceTimer`` — device intervals from CUDA events, emitted
               as spans once complete, with no synchronize.
  metrics.py   ``MetricsRegistry`` — cataloged counters/gauges/bounded
               histograms; process-wide ``aggregate_snapshot``.
  export.py    JSONL span logs and Prometheus text.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .device import DeviceTimer
from .export import (
    SpanJsonlWriter,
    prometheus_text,
    read_spans_jsonl,
    validate_span_dict,
    validate_span_tree,
)
from .metrics import (
    METRIC_CATALOG,
    MetricsRegistry,
    aggregate_snapshot,
    validate_metric_names,
)
from .trace import NULL_TRACER, SPAN_SCHEMA_KEYS, Span, Tracer, new_trace_id


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """Declarative observability knobs (a ``ParserConfig`` field).

    ``enabled`` switches tracing on (metrics are ALWAYS collected — they are
    O(1) host mutations); a traced parse runs the route an untraced one
    does, with a span at each layer boundary and the device's phases timed
    by CUDA events, never by a synchronize.  ``span_log`` adds a JSONL sink
    for finished spans; ``profiler`` wraps every live span in a
    ``torch.profiler.record_function`` so its name appears on profiler
    timelines as a host range; ``max_spans`` bounds the
    tracer's in-memory ring buffer.  ``hlo`` attaches the phase programs'
    static modeled cost to ``Parser.stats()["hlo"]`` when tracing is on
    (``ParserEngine.phase_static_cost``: one trace of each phase a bucket).
    """

    enabled: bool = False
    span_log: Optional[str] = None
    profiler: bool = False
    hlo: bool = True
    max_spans: int = 4096

    def __post_init__(self):
        if self.max_spans < 1:
            raise ValueError(f"max_spans must be >= 1, got {self.max_spans}")
        if self.span_log is not None and not isinstance(self.span_log, str):
            raise ValueError("span_log must be a path string or None")


class ObsHandle:
    """The (tracer, registry) pair every engine carries.

    Construction is cheap; the default handle has a disabled tracer, so
    un-configured engines pay one predicate per would-be span.
    """

    def __init__(
        self,
        *,
        tracer: Optional[Tracer] = None,
        registry: Optional[MetricsRegistry] = None,
        config: Optional[ObsConfig] = None,
    ):
        self.config = config if config is not None else ObsConfig()
        self.tracer = tracer if tracer is not None else Tracer(enabled=False)
        self.registry = registry if registry is not None else MetricsRegistry()
        self._span_sink: Optional[SpanJsonlWriter] = None
        self._timer: Optional[DeviceTimer] = None

    @classmethod
    def from_config(cls, cfg: Optional[ObsConfig]) -> "ObsHandle":
        if cfg is None:
            cfg = ObsConfig()
        tracer = Tracer(
            enabled=cfg.enabled, max_spans=cfg.max_spans, profiler=cfg.profiler
        )
        handle = cls(tracer=tracer, config=cfg)
        if cfg.enabled and cfg.span_log:
            handle._span_sink = SpanJsonlWriter(cfg.span_log)
            tracer.add_sink(handle._span_sink)
        if cfg.enabled:
            spans = handle.registry.counter("spans_recorded_total")
            tracer.add_sink(lambda _sp: spans.inc())
        return handle

    # ---------------------------------------------------------- delegation

    @property
    def enabled(self) -> bool:
        return self.tracer.enabled

    @property
    def metrics(self) -> MetricsRegistry:
        return self.registry

    def span(self, name: str, **kw):
        return self.tracer.span(name, **kw)

    def emit(self, name: str, **kw):
        return self.tracer.emit(name, **kw)

    def new_trace_id(self) -> Optional[str]:
        return self.tracer.new_trace_id()

    def device_timer(self, device: torch.device) -> Optional[DeviceTimer]:
        """The CUDA-event timer of ``device``; None when tracing is off or
        the device is not a card (each call there has finished when it
        returns, so a live span times it)."""
        if not self.tracer.enabled or device.type != "cuda":
            return None
        if self._timer is None:
            self._timer = DeviceTimer(self.tracer, device)
        return self._timer

    def phase(self, device: torch.device, name: str, *, drains: bool = False, **attrs):
        """A span over device work enqueued in the block: CUDA events on
        the card (``DeviceTimer.phase``; ``drains`` for a block that
        returns with the stream drained, a device → host copy), a live span
        on a host device, nothing when tracing is off."""
        timer = self.device_timer(device)
        if timer is None:
            return self.span(name, **attrs)
        return timer.phase(name, drains=drains, **attrs)

    def settle(self, device: torch.device) -> None:
        """Emit the device intervals that have completed, without waiting."""
        timer = self.device_timer(device)
        if timer is not None:
            timer.anchor_if_idle()
            timer.resolve()

    def close(self) -> None:
        """Emit the device intervals that have completed, then flush and
        close the JSONL sink, if any."""
        if self._timer is not None:
            self._timer.close()
        if self._span_sink is not None:
            self._span_sink.close()


__all__ = [
    "METRIC_CATALOG",
    "MetricsRegistry",
    "NULL_TRACER",
    "ObsConfig",
    "ObsHandle",
    "SPAN_SCHEMA_KEYS",
    "Span",
    "SpanJsonlWriter",
    "Tracer",
    "aggregate_snapshot",
    "new_trace_id",
    "prometheus_text",
    "read_spans_jsonl",
    "validate_metric_names",
    "validate_span_dict",
    "validate_span_tree",
]
