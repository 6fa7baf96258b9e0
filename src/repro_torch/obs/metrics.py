"""Metrics registry: counters, gauges, bounded histograms.

The port's copy of ``repro/obs/metrics.py``, ``METRIC_CATALOG`` name for
name.  One registry per engine (every layer over that engine — both
services, the streaming parsers — records into it), plus a process-wide
aggregation over the port's live registries for export.
``Parser.stats()["metrics"]`` is a view over it.

  host-only     every update is a tiny host-side mutation; nothing here
                touches torch or the device.
  bounded       histograms hold fixed bucket counts + count/sum — O(1)
                memory per metric regardless of traffic (the per-bucket
                p50/p99 *windows* stay in ``serve/parse_service.py``'s
                ``BucketStats``, a sliding-window estimator, not a metric).
  cataloged     every metric name must be declared in ``METRIC_CATALOG``;
                creating an unknown name raises immediately, so a renamed
                metric fails loudly instead of going quiet.

Metric identity is (name, frozen label set); the same name may carry many
label sets (e.g. ``admission_rejects_total{service="parse", cause="deadline"}``).
"""

from __future__ import annotations

import threading
import weakref
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple

# --------------------------------------------------------------- catalog

#: Default histogram bounds (seconds-ish / count-ish; per-metric overrides
#: below).  Upper-open last bucket is implicit (+Inf).
_DEFAULT_BOUNDS = (0.001, 0.01, 0.1, 1.0, 10.0)

#: name -> (kind, help text[, histogram bounds])
METRIC_CATALOG: Dict[str, Tuple] = {
    # request / append flow
    "requests_total": ("counter", "parse requests submitted"),
    "appends_total": ("counter", "stream appends queued"),
    "served_total": ("counter", "requests/appends fully served"),
    "batches_total": ("counter", "batched device programs dispatched"),
    "cancelled_total": ("counter", "queued requests cancelled"),
    "chars_total": ("counter", "input characters accepted into the queue"),
    "queue_depth": ("gauge", "live queued requests/appends"),
    "peak_queue_depth": ("gauge", "high-water queue depth"),
    # admission / SLO
    "admission_rejects_total": (
        "counter",
        "admission rejections by cause (deadline|budget|tenant_budget|pathological)",
    ),
    # static analysis (the analyzer, leg 1)
    "analyzer_verdicts_total": (
        "counter", "static pattern analyses by verdict (ok|pathological)",
    ),
    "auto_backend_selected_total": (
        "counter", 'backend="auto" resolutions by chosen backend',
    ),
    # engine program cache
    "compiled_programs_total": ("counter", "device programs traced (re-jit events)"),
    "bucket_cache_hits_total": ("counter", "parses served by an already-compiled bucket"),
    "bucket_cache_misses_total": ("counter", "parses that compiled a new bucket shape"),
    # fleet transition-table compile cache (core/fleet.py)
    "table_cache_hits_total": (
        "counter", "tenant table compiles served from the process-wide cache",
    ),
    "table_cache_misses_total": (
        "counter", "tenant table compiles that built matrices from the regex",
    ),
    "fleet_tenants": ("gauge", "tenants registered on a FleetEngine"),
    "fleet_buckets": ("gauge", "distinct (backend, class, ℓp) automaton buckets"),
    # streaming cache
    "stream_sessions": ("gauge", "open streaming sessions"),
    "stream_bytes_cached": ("gauge", "device bytes resident in prefix caches"),
    "stream_evictions_total": ("counter", "sealed products / caches evicted"),
    "stream_bytes_reclaimed_total": ("counter", "device bytes freed by eviction"),
    "stream_rebuilds_total": (
        "counter", "evicted chunk products re-reached (counted per chunk)",
    ),
    # streaming edits (product segment tree)
    "stream_edits_total": ("counter", "mid-text splices served by streams"),
    "stream_edit_recompose_depth": (
        "histogram", "internal products re-composed per edit (tree spine depth)",
        (0, 1, 2, 4, 8, 16, 32, 64),
    ),
    # distribution
    "allgather_payload_bytes_total": (
        "counter", "product-stack bytes moved through the mesh all-gather",
    ),
    # speculation (sparse backend)
    "speculation_width": (
        "histogram", "observed feasible-start width per parse",
        (1, 2, 4, 8, 16, 32, 64, 128, 256, 512),
    ),
    # static modeled cost (launch/op_stats.py, per traced bucket + phase; the
    # help texts are the reference's, which the port's catalog equals)
    "hlo_flops": ("gauge", "static flops of one compiled phase program"),
    "hlo_bytes": ("gauge", "static HBM-model bytes of one compiled phase program"),
    "hlo_collective_bytes": (
        "gauge", "static collective bytes of one compiled phase program",
    ),
    # tracing plumbing
    "spans_recorded_total": ("counter", "finished spans recorded by the tracer"),
}


def _label_key(labels: Mapping[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


# --------------------------------------------------------------- metrics


@dataclass
class Counter:
    """Monotonic counter — ``inc`` only, never decremented (tested)."""

    name: str
    labels: Tuple[Tuple[str, str], ...]
    value: float = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError(f"counter {self.name} cannot decrease (inc {v})")
        self.value += v


@dataclass
class Gauge:
    name: str
    labels: Tuple[Tuple[str, str], ...]
    value: float = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, v: float = 1.0) -> None:
        self.value += v

    def dec(self, v: float = 1.0) -> None:
        self.value -= v


class Histogram:
    """Fixed-bound cumulative histogram (Prometheus semantics, +Inf implicit)."""

    def __init__(self, name: str, labels, bounds: Iterable[float]):
        self.name = name
        self.labels = labels
        self.bounds = tuple(float(b) for b in bounds)
        if list(self.bounds) != sorted(self.bounds):
            raise ValueError(f"histogram {name} bounds must be sorted")
        self.bucket_counts = [0] * (len(self.bounds) + 1)   # last = +Inf
        self.count = 0
        self.sum = 0.0

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        for i, b in enumerate(self.bounds):
            if v <= b:
                self.bucket_counts[i] += 1
                return
        self.bucket_counts[-1] += 1

    @property
    def value(self) -> Dict[str, Any]:
        cum, out = 0, []
        for b, c in zip(self.bounds, self.bucket_counts[:-1]):
            cum += c
            out.append([b, cum])
        return {"count": self.count, "sum": self.sum, "buckets": out}


_KIND = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


# -------------------------------------------------------------- registry

#: Every live registry, for the process-wide aggregated export.
_REGISTRIES: "weakref.WeakSet[MetricsRegistry]" = weakref.WeakSet()


class MetricsRegistry:
    """Get-or-create metric store validated against ``METRIC_CATALOG``."""

    def __init__(self):
        self._metrics: Dict[Tuple[str, Tuple], Any] = {}
        self._lock = threading.Lock()
        _REGISTRIES.add(self)

    def _get(self, kind: str, name: str, labels: Mapping[str, str], **kw):
        spec = METRIC_CATALOG.get(name)
        if spec is None:
            raise KeyError(
                f"unknown metric {name!r} — declare it in "
                f"repro_torch.obs.metrics.METRIC_CATALOG (instrumentation-rot guard)"
            )
        if spec[0] != kind:
            raise TypeError(f"metric {name!r} is a {spec[0]}, not a {kind}")
        key = (name, _label_key(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                if kind == "histogram":
                    bounds = kw.get("bounds") or (
                        spec[2] if len(spec) > 2 else _DEFAULT_BOUNDS
                    )
                    m = Histogram(name, key[1], bounds)
                else:
                    m = _KIND[kind](name, key[1])
                self._metrics[key] = m
        return m

    def counter(self, name: str, **labels: str) -> Counter:
        return self._get("counter", name, labels)

    def gauge(self, name: str, **labels: str) -> Gauge:
        return self._get("gauge", name, labels)

    def histogram(
        self, name: str, *, bounds: Optional[Iterable[float]] = None, **labels: str
    ) -> Histogram:
        return self._get("histogram", name, labels, bounds=bounds)

    # ------------------------------------------------------------ reading

    def names(self) -> List[str]:
        with self._lock:
            return sorted({name for name, _ in self._metrics})

    def snapshot(self) -> Dict[str, List[Dict[str, Any]]]:
        """{name: [{"labels": {...}, "kind": ..., "value": ...}, ...]} —
        plain JSON-able values (histograms expand to count/sum/buckets)."""
        with self._lock:
            items = list(self._metrics.items())
        out: Dict[str, List[Dict[str, Any]]] = {}
        for (name, labels), m in sorted(items, key=lambda kv: kv[0]):
            out.setdefault(name, []).append(
                {
                    "labels": dict(labels),
                    "kind": METRIC_CATALOG[name][0],
                    "value": m.value,
                }
            )
        return out


def aggregate_snapshot() -> Dict[str, List[Dict[str, Any]]]:
    """Process-wide view: merged snapshots of every live registry of the port."""
    out: Dict[str, List[Dict[str, Any]]] = {}
    for reg in list(_REGISTRIES):
        for name, series in reg.snapshot().items():
            out.setdefault(name, []).extend(series)
    return out


def validate_metric_names(names: Iterable[str]) -> None:
    """Raise on any metric name missing from the catalog."""
    unknown = sorted(set(names) - set(METRIC_CATALOG))
    if unknown:
        raise KeyError(f"unknown metric names in snapshot: {unknown}")
