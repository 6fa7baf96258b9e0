"""Exporters: JSONL span logs and Prometheus text snapshots.

The port's copy of ``repro/obs/export.py``; two machine-readable formats,
host-only (the port's benchmark, ``bench/``, prints its own result lines):

  span JSONL        one span dict per line (``trace.SPAN_SCHEMA_KEYS``) —
                    ``SpanJsonlWriter`` is a tracer sink that appends+flushes
                    per span, so a crashed process still leaves a valid log.

  Prometheus text   ``prometheus_text(snapshot)`` renders a registry
                    snapshot in the exposition format (``repro_``-prefixed,
                    as the reference's, HELP/TYPE headers, label escaping,
                    histogram ``_bucket``/``_sum``/``_count`` expansion).
"""

from __future__ import annotations

import json
import threading
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Union

from .metrics import METRIC_CATALOG, MetricsRegistry
from .trace import SPAN_SCHEMA_KEYS, Span


# ----------------------------------------------------------- span JSONL


class SpanJsonlWriter:
    """Tracer sink appending one JSON line per finished span (flushed)."""

    def __init__(self, path: Union[str, Path]):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = self.path.open("a", encoding="utf-8")
        self._lock = threading.Lock()

    def record(self, span: Span) -> None:
        line = json.dumps(span.to_dict(), sort_keys=True)
        with self._lock:
            self._fh.write(line + "\n")
            self._fh.flush()

    # the object itself is a valid sink callable
    __call__ = record

    def close(self) -> None:
        with self._lock:
            if not self._fh.closed:
                self._fh.close()


def read_spans_jsonl(path: Union[str, Path]) -> List[Dict[str, Any]]:
    out = []
    for line in Path(path).read_text(encoding="utf-8").splitlines():
        if line.strip():
            out.append(json.loads(line))
    return out


def validate_span_dict(d: Mapping[str, Any]) -> None:
    """Schema check for one exported span line (raises ValueError)."""
    missing = set(SPAN_SCHEMA_KEYS) - set(d)
    if missing:
        raise ValueError(f"span missing keys {sorted(missing)}: {dict(d)!r}")
    if not isinstance(d["name"], str) or not d["name"]:
        raise ValueError(f"span name must be a non-empty string: {d['name']!r}")
    for key in ("t_start_s", "duration_s"):
        if not isinstance(d[key], (int, float)):
            raise ValueError(f"span {key} must be numeric: {d[key]!r}")
    if d["duration_s"] < 0:
        raise ValueError(f"span duration_s must be >= 0: {d['duration_s']!r}")
    if not isinstance(d["attrs"], dict):
        raise ValueError(f"span attrs must be a dict: {d['attrs']!r}")


def validate_span_tree(spans: List[Mapping[str, Any]], trace_id: str) -> Dict[str, Any]:
    """Structural check of one trace: exactly one root, every parent
    resolves, child durations fit inside the root span.  Returns
    ``{"root": ..., "children": [...]}`` for further assertions."""
    mine = [s for s in spans if s.get("trace_id") == trace_id]
    if not mine:
        raise ValueError(f"no spans for trace {trace_id!r}")
    ids = {s["span_id"] for s in mine}
    roots = [s for s in mine if s["parent_id"] is None]
    if len(roots) != 1:
        raise ValueError(
            f"trace {trace_id!r} has {len(roots)} roots (want exactly 1): "
            f"{[s['name'] for s in roots]}"
        )
    root = roots[0]
    children = [s for s in mine if s is not root]
    for s in children:
        if s["parent_id"] not in ids:
            raise ValueError(
                f"span {s['name']!r} parent {s['parent_id']!r} not in trace"
            )
    direct = [s for s in children if s["parent_id"] == root["span_id"]]
    # sequential direct children must fit inside the root wall-clock (small
    # tolerance: span exit bookkeeping happens after the clock read)
    total = sum(s["duration_s"] for s in direct)
    if total > root["duration_s"] * 1.05 + 1e-3:
        raise ValueError(
            f"trace {trace_id!r}: child durations {total:.6f}s exceed root "
            f"span {root['duration_s']:.6f}s"
        )
    return {"root": root, "children": children}


# ------------------------------------------------------- Prometheus text


def _prom_labels(labels: Mapping[str, str], extra: Optional[Dict[str, str]] = None) -> str:
    items = dict(labels)
    if extra:
        items.update(extra)
    if not items:
        return ""
    body = ",".join(
        f'{k}="{str(v).replace(chr(92), chr(92) * 2).replace(chr(34), chr(92) + chr(34))}"'
        for k, v in sorted(items.items())
    )
    return "{" + body + "}"


def prometheus_text(
    snapshot: Union[MetricsRegistry, Mapping[str, List[Dict[str, Any]]]],
    *,
    prefix: str = "repro_",
) -> str:
    """Render a registry (or its ``snapshot()``) in Prometheus exposition
    format.  Accepts the aggregated process-wide snapshot too."""
    if isinstance(snapshot, MetricsRegistry):
        snapshot = snapshot.snapshot()
    lines: List[str] = []
    for name in sorted(snapshot):
        series = snapshot[name]
        kind, help_text = METRIC_CATALOG[name][0], METRIC_CATALOG[name][1]
        pname = prefix + name
        lines.append(f"# HELP {pname} {help_text}")
        lines.append(f"# TYPE {pname} {kind}")
        for s in series:
            labels, value = s["labels"], s["value"]
            if kind == "histogram":
                cum = 0
                for bound, cum in value["buckets"]:
                    lines.append(
                        f"{pname}_bucket{_prom_labels(labels, {'le': repr(bound)})} {cum}"
                    )
                lines.append(
                    f"{pname}_bucket{_prom_labels(labels, {'le': '+Inf'})} "
                    f"{value['count']}"
                )
                lines.append(f"{pname}_sum{_prom_labels(labels)} {value['sum']}")
                lines.append(f"{pname}_count{_prom_labels(labels)} {value['count']}")
            else:
                lines.append(f"{pname}{_prom_labels(labels)} {value}")
    return "\n".join(lines) + "\n"
