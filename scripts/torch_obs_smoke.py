"""Observability smoke gate for the PyTorch port: the obs layer end to end on tiny inputs.

    PYTHONPATH=src python scripts/torch_obs_smoke.py [--device cuda|cpu]

Checks 1–6 of ``scripts/obs_smoke.py``, all through the public facade
(``repro_torch.Parser`` with ``ParserConfig(obs=...)``):

  1. traced parse on every backend the device runs — on ``cpu`` ``torch``,
     ``packed`` and ``sparse``; on ``cuda`` the kernel paths ``cuda``,
     ``packed`` and ``sparse`` (``kernel=True``) and ``torch`` — the direct
     ``parse`` route and the ``submit``/ticket route both leave a complete
     span tree in the JSONL log (one root, parents resolve, child durations
     bounded by the root: ``validate_span_tree``);
  2. the span taxonomy holds — ``parse.request`` roots with phase spans
     (reach/join/build&merge/host build) on the direct route, queue-wait +
     batch-compute spans on the ticket route (both routes run the service,
     so each carries the other's spans too);
  3. metric-name rot guard — every name in every registry snapshot is in
     ``METRIC_CATALOG`` (``validate_metric_names``), and ``prometheus_text``
     renders the snapshot;
  4. stream edits — mid-text splices through ``ParserStream.edit`` leave
     ``stream.edit`` span trees and move the ``stream_edits_total`` counter
     and ``stream_edit_recompose_depth`` histogram, all rendering in the
     Prometheus text;
  5. fleet compile economy — a ``ParserFleet`` with many tenants over few
     (backend, ℓp-bucket) pairs runs one program per BUCKET (not per
     tenant), and the table-compile cache counters
     (``table_cache_hits_total`` / ``table_cache_misses_total``) count
     distinct (pattern, backend) builds and render in the snapshot;
  6. analyzer metrics — construction-time analysis verdict counters
     (``analyzer_verdicts_total``) and ``backend="auto"`` selection counters
     (``auto_backend_selected_total``) stay inside ``METRIC_CATALOG`` and
     render in the Prometheus text.

Check 7 of the reference (every ``BENCH_*.json`` against the perf-trajectory
schema) has no port: the port's benchmark (``bench/``) prints one JSON result
line a run, and the port keeps no ``BENCH_*.json`` exporter.

Exits non-zero on the first violated invariant, printing which one.
"""

import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parents[1] / "src"))

import repro_torch
from repro_torch.core.engine import resolve_device
from repro_torch.obs import (
    prometheus_text,
    read_spans_jsonl,
    validate_metric_names,
    validate_span_tree,
)

PHASE_SPANS = {"phase.reach", "phase.join", "phase.build_merge",
               "phase.host_build"}


def device_backends(device) -> list:
    """(backend, kernel) pairs the device runs: the kernel paths on the
    card, the plain ones on the CPU."""
    if device.type == "cuda":
        return [("cuda", False), ("packed", True), ("sparse", True), ("torch", False)]
    return [("torch", False), ("packed", False), ("sparse", False)]


def check_backend(backend: str, kernel: bool, device, workdir: Path) -> None:
    label = backend + ("+kernel" if kernel else "")
    log = workdir / f"spans_{label}.jsonl"
    cfg = repro_torch.ParserConfig(
        regex="(a|b|ab)+", backend=backend, kernel=kernel, n_chunks=4,
        obs={"enabled": True, "span_log": str(log)},
    )
    with repro_torch.Parser(cfg, device=device) as p:
        direct = p.parse("abab" * 8)
        assert direct.ok, f"{label}: traced parse rejected a valid text"
        assert direct.trace_id, f"{label}: traced parse has no trace_id"

        ticket = p.submit("abab" * 4)
        served = ticket.result()
        assert served.ok and served.trace_id, \
            f"{label}: ticket route lost its trace"
        assert served.trace_id != direct.trace_id, \
            f"{label}: trace_id reused across requests"

        snap = p.stats()["metrics"]
        validate_metric_names(snap)
        assert prometheus_text(snap).strip(), \
            f"{label}: empty prometheus rendering"
        p.obs.close()

    spans = read_spans_jsonl(log)
    for tid, route in ((direct.trace_id, "direct"),
                       (served.trace_id, "ticket")):
        tree = validate_span_tree(spans, tid)
        root = tree["root"]
        assert root["name"] == "parse.request", \
            f"{label}/{route}: root span is {root['name']!r}"
        children = {s["name"] for s in spans
                    if s["trace_id"] == tid and s["parent_id"] is not None}
        want = (PHASE_SPANS if route == "direct"
                else {"parse.queue_wait", "parse.batch_compute"})
        missing = want - children
        assert not missing, f"{label}/{route}: missing spans {sorted(missing)}"
    print(f"ok: {label:14s} — {len(spans)} spans, both routes form valid trees")


def check_stream_edit(device, workdir: Path) -> None:
    log = workdir / "spans_edit.jsonl"
    cfg = repro_torch.ParserConfig(
        regex="(a|b|ab)+", backend=device_backends(device)[0][0], n_chunks=4,
        first_seal_len=4, max_seal_len=8,
        obs={"enabled": True, "span_log": str(log)},
    )
    with repro_torch.Parser(cfg, device=device) as p:
        with p.open_stream() as stream:
            stream.append("ab" * 12)
            assert stream.accepted, "edit: stream rejected a valid prefix"
            stream.edit(5, 9, "ba")           # mid-text splice
            stream.delete(0, 2)               # pure delete
            stream.insert(4, "ab")            # zero-width insert
            assert stream.result().ok, "edit: edited stream rejected"
        snap = p.stats()["metrics"]
        validate_metric_names(snap)
        flat = {str(k): v for k, v in snap.items()}
        edits = flat["stream_edits_total"][0]["value"]
        assert edits == 3, f"edit: stream_edits_total={edits}, expected 3"
        depth = flat["stream_edit_recompose_depth"][0]["value"]
        assert depth["count"] == 3, \
            f"edit: recompose-depth histogram count={depth['count']}, expected 3"
        rendered = prometheus_text(snap)
        for name in ("stream_edits_total", "stream_edit_recompose_depth"):
            assert name in rendered, f"edit: {name} missing from rendering"
        p.obs.close()
    spans = read_spans_jsonl(log)
    roots = [s for s in spans if s["name"] == "stream.edit"]
    assert len(roots) == 3, f"edit: {len(roots)} stream.edit spans, expected 3"
    for root in roots:
        assert root["parent_id"] is None, "edit: stream.edit span not a root"
        for attr in ("lo", "hi", "repl_chars", "n_chars"):
            assert attr in root["attrs"], f"edit: span missing attr {attr!r}"
        assert root["duration_s"] >= 0.0, "edit: span never closed"
    print("ok: edit           — 3 splices traced, recompose-depth histogram + "
          "counter rendered")


def check_fleet(device) -> None:
    from repro_torch.core.fleet import clear_table_cache

    dense = device_backends(device)[0][0]
    kernel = device.type == "cuda"
    clear_table_cache()
    # 8 tenants, but only 3 (backend, class, ℓp) automaton buckets: six
    # dense tenants share one pattern/bucket, one dense tenant has a long
    # pattern (own ℓp bucket), one runs the shared pattern on sparse
    tenants = {
        f"t{i}": repro_torch.ParserConfig(regex="(a|b)*abb", backend=dense, n_chunks=4)
        for i in range(6)
    }
    tenants["long"] = repro_torch.ParserConfig(regex="a" * 40, backend=dense, n_chunks=4)
    tenants["sp"] = repro_torch.ParserConfig(
        regex="(a|b)*abb", backend="sparse", kernel=kernel, n_chunks=4
    )
    with repro_torch.ParserFleet(tenants, device=device) as fleet:
        fleet.parse_batch([(tid, "ababb") for tid in tenants])
        n_buckets = fleet.engine.n_buckets
        assert n_buckets == 3, f"fleet: expected 3 buckets, got {n_buckets}"
        assert fleet.compile_count == n_buckets, (
            f"fleet: {fleet.compile_count} programs for "
            f"{n_buckets} buckets and {len(tenants)} tenants — the program "
            f"count must scale with buckets, not tenants"
        )
        snap = fleet.stats()["metrics"]
        validate_metric_names(snap)
        flat = {str(k): v for k, v in snap.items()}
        misses = flat["table_cache_misses_total"][0]["value"]
        hits = flat["table_cache_hits_total"][0]["value"]
        # 3 distinct (pattern, backend) builds; the 5 repeat dense tenants hit
        assert misses == 3, f"fleet: {misses} table builds, expected 3"
        assert hits == 5, f"fleet: {hits} table-cache hits, expected 5"
        assert flat["fleet_tenants"][0]["value"] == len(tenants)
        assert flat["fleet_buckets"][0]["value"] == n_buckets
        rendered = prometheus_text(snap)
        for name in ("table_cache_misses_total", "table_cache_hits_total"):
            assert name in rendered, f"fleet: {name} missing from rendering"
    print(f"ok: fleet          — {len(tenants)} tenants -> {n_buckets} buckets, "
          f"{int(misses)} table builds (+{int(hits)} cache hits)")


def check_analyzer(device) -> None:
    """Analyzer metrics (``repro_torch.analyze``) stay inside
    METRIC_CATALOG and render in the Prometheus text: verdict counters from
    construction-time analysis, auto-backend selection counters from
    backend="auto"."""
    with repro_torch.Parser(
        repro_torch.ParserConfig(regex="(a|b|ab)+", backend="auto", n_chunks=4),
        device=device,
    ) as p:
        assert p.parse("abab").ok, "analyzer: auto-backend parse rejected"
        snap = p.stats()["metrics"]
        validate_metric_names(snap)
        flat = {str(k): v for k, v in snap.items()}
        verdicts = flat.get("analyzer_verdicts_total")
        assert verdicts and verdicts[0]["labels"].get("verdict") == "ok", \
            "analyzer: analyzer_verdicts_total{verdict=ok} not recorded"
        selected = flat.get("auto_backend_selected_total")
        assert selected and selected[0]["value"] == 1, \
            "analyzer: auto_backend_selected_total not recorded"
        chosen = selected[0]["labels"].get("backend")
        assert chosen == p.backend_name, (
            f"analyzer: selection counter says {chosen!r} but the parser "
            f"runs {p.backend_name!r}"
        )
        rendered = prometheus_text(snap)
        for name in ("analyzer_verdicts_total", "auto_backend_selected_total"):
            assert name in rendered, f"analyzer: {name} missing from rendering"
    print(f"ok: analyze        — verdict + auto-selection counters "
          f"(backend={chosen!r}) in catalog and rendering")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"torch_obs_smoke: {e}", file=sys.stderr)
        return 1
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for backend, kernel in device_backends(device):
                check_backend(backend, kernel, device, Path(tmp))
            check_stream_edit(device, Path(tmp))
        check_fleet(device)
        check_analyzer(device)
    except AssertionError as e:
        print(f"torch_obs_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print("obs smoke gate: all checks passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
