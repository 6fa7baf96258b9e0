"""repro_torch's observability layer (``repro_torch.obs``) against repro's.

The port keeps its own copy of ``repro/obs``: the metric catalog must be
the reference's name for name; the same counter / gauge / histogram
operations must give equal ``snapshot()`` and Prometheus text; the span
tree check and the BENCH schema must accept and reject the same inputs; and
a traced ``Parser.parse`` must leave the reference's span names and
parent/child tree in the JSONL log, with columns equal to the fused route's.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_corpus import artifacts  # noqa: E402

import repro  # noqa: E402
import repro.obs as ref_obs  # noqa: E402
import repro_torch  # noqa: E402
import repro_torch.obs as port_obs  # noqa: E402
from repro_torch import ObsConfig, Parser, ParserConfig  # noqa: E402

AMBIG = "(a|b|ab)+"
PACKAGES = [("port", port_obs), ("ref", ref_obs)]


def test_metric_catalog_and_schemas_equal_reference():
    assert port_obs.METRIC_CATALOG == ref_obs.METRIC_CATALOG
    assert port_obs.SPAN_SCHEMA_KEYS == ref_obs.SPAN_SCHEMA_KEYS
    assert port_obs.BENCH_SCHEMA_KEYS == ref_obs.BENCH_SCHEMA_KEYS
    assert sorted(port_obs.__all__) == sorted(ref_obs.__all__)
    assert repro_torch.ObsConfig is port_obs.ObsConfig
    assert repro_torch.api.ObsConfig is port_obs.ObsConfig
    assert ObsConfig().hlo is True                 # the reference's default


def _drive(obs):
    reg = obs.MetricsRegistry()
    a = reg.counter("requests_total", service="parse")
    a.inc()
    a.inc(2.5)
    reg.counter("requests_total", service="stream").inc()
    reg.counter("admission_rejects_total", service="parse", cause="deadline").inc(3)
    g = reg.gauge("queue_depth", service="stream")
    g.set(7)
    g.dec(2)
    g.inc(0.5)
    h = reg.histogram("speculation_width")
    for v in (1, 3, 3, 40, 900):
        h.observe(v)
    h2 = reg.histogram("stream_edit_recompose_depth", bounds=(1, 10))
    h2.observe(0)
    h2.observe(11)
    reg.gauge("hlo_flops", bucket="8x16", phase="reach").set(1e9)
    return reg


def test_registry_snapshots_and_prometheus_text_equal_reference():
    port, ref = _drive(port_obs), _drive(ref_obs)
    assert port.snapshot() == ref.snapshot()
    assert port.names() == ref.names()
    assert port_obs.prometheus_text(port) == ref_obs.prometheus_text(ref)
    assert port_obs.prometheus_text(port.snapshot(), prefix="x_") == \
        ref_obs.prometheus_text(ref.snapshot(), prefix="x_")
    agg = port_obs.aggregate_snapshot()
    assert all(s in agg["requests_total"] for s in port.snapshot()["requests_total"])


@pytest.mark.parametrize("bad", [
    lambda reg: reg.counter("requests_totl"),
    lambda reg: reg.gauge("requests_total"),
    lambda reg: reg.histogram("queue_depth"),
    lambda reg: reg.counter("requests_total").inc(-1),
    lambda reg: reg.histogram("speculation_width", bounds=(3, 1)),
])
def test_registry_rejects_what_the_reference_rejects(bad):
    with pytest.raises((KeyError, TypeError, ValueError)) as e:
        bad(port_obs.MetricsRegistry())
    with pytest.raises(type(e.value)):
        bad(ref_obs.MetricsRegistry())
    with pytest.raises(KeyError):
        port_obs.validate_metric_names(["requests_total", "made_up"])
    port_obs.validate_metric_names(port_obs.METRIC_CATALOG)


def _span(name, sid, parent=None, trace="t", dur=1.0):
    return {"name": name, "trace_id": trace, "span_id": sid, "parent_id": parent,
            "t_start_s": 0.0, "duration_s": dur, "attrs": {}}


SPAN_TREES = [
    [],
    [_span("a", "1")],
    [_span("a", "1"), _span("b", "2")],
    [_span("a", "1"), _span("b", "2", parent="missing")],
    [_span("root", "1"), _span("c1", "2", parent="1"), _span("c2", "3", parent="1")],
    [_span("root", "1", dur=3.0), _span("c1", "2", parent="1"), _span("c2", "3", parent="2")],
    [_span("root", "1", trace="u"), _span("c", "2", parent="1")],
]


@pytest.mark.parametrize("i", range(len(SPAN_TREES)))
def test_span_tree_check_accepts_and_rejects_as_reference(i):
    spans = SPAN_TREES[i]

    def verdict(obs):
        try:
            tree = obs.validate_span_tree(spans, "t")
        except ValueError as e:
            return ("error", str(e))
        return ("ok", tree["root"]["span_id"], [c["span_id"] for c in tree["children"]])

    assert verdict(port_obs) == verdict(ref_obs)


BENCH = [
    {"name": "x", "timestamp": 1.0, "config": {}, "metrics": {}},
    {"name": "x", "timestamp": 1.0, "config": {}},
    {"name": "x", "timestamp": 1.0, "config": {}, "metrics": {}, "extra": 1},
    {"name": "", "timestamp": 1.0, "config": {}, "metrics": {}},
    {"name": "x", "timestamp": 0, "config": {}, "metrics": {}},
    {"name": "x", "timestamp": 1.0, "config": [], "metrics": {}},
    {"name": "x", "timestamp": 1.0, "config": {}, "metrics": {"v": object()}},
]


@pytest.mark.parametrize("i", range(len(BENCH)))
def test_bench_schema_accepts_and_rejects_as_reference(i, tmp_path):
    def verdict(obs):
        try:
            obs.validate_bench_report(BENCH[i])
        except (ValueError, TypeError) as e:
            return type(e).__name__
        return "ok"

    assert verdict(port_obs) == verdict(ref_obs)
    out = port_obs.write_bench_json("unit", config={"quick": True}, metrics={"rows": [1]},
                                    out_dir=tmp_path, timestamp=123.0)
    (tmp_path / "ref").mkdir()
    ref_out = ref_obs.write_bench_json("unit", config={"quick": True}, metrics={"rows": [1]},
                                       out_dir=tmp_path / "ref", timestamp=123.0)
    assert json.loads(out.read_text()) == json.loads(ref_out.read_text())


def test_tracer_mechanics_equal_reference():
    out = {}
    for name, obs in PACKAGES:
        tr = obs.Tracer(enabled=True, max_spans=3)
        tid = tr.new_trace_id()
        with tr.span("parse.request", trace_id=tid, n=1):
            with tr.span("phase.reach") as sp:
                sp.set_attr("k", 2)
        root = tr._new_span_id()
        tr.emit("parse.queue_wait", t_start_s=1.0, duration_s=0.5, trace_id=tid,
                parent_id=root)
        tr.emit("parse.request", t_start_s=1.0, duration_s=2.0, trace_id=tid, span_id=root)
        spans = [s.to_dict() for s in tr.drain()]
        out[name] = [(s["name"], s["span_id"], s["parent_id"], s["attrs"]) for s in spans]
        assert len(tid) == 16
        off = obs.Tracer(enabled=False)
        assert off.new_trace_id() is None and off.emit("x", t_start_s=0, duration_s=0) is None
    assert out["port"] == out["ref"]


@pytest.fixture()
def traced(tmp_path):
    art, port_m, _ = artifacts(AMBIG)
    logs = {"port": tmp_path / "port.jsonl", "ref": tmp_path / "ref.jsonl"}
    cfg = {"regex": "<obs>", "n_chunks": 4}
    p = Parser.from_matrices(
        port_m, ParserConfig(backend="torch", obs={"enabled": True, "span_log": str(logs["port"])},
                             **cfg), device="cpu")
    r = repro.Parser.from_matrices(
        art.matrices, repro.ParserConfig(obs={"enabled": True, "span_log": str(logs["ref"]),
                                              "hlo": False}, **cfg))
    yield p, r, logs
    p.close()
    r.close()


def _tree(log, trace_id, obs):
    spans = obs.read_spans_jsonl(log)
    for d in spans:
        obs.validate_span_dict(d)
    tree = obs.validate_span_tree(spans, trace_id)
    by_id = {s["span_id"]: s["name"] for s in [tree["root"]] + tree["children"]}
    return tree["root"]["name"], sorted((c["name"], by_id[c["parent_id"]])
                                        for c in tree["children"])


def test_traced_parse_span_tree_equals_reference(traced):
    p, r, logs = traced
    text = "abab" * 8
    got, want = p.parse(text), r.parse(text)
    assert got.trace_id is not None and want.trace_id is not None
    assert _tree(logs["port"], got.trace_id, port_obs) == _tree(logs["ref"], want.trace_id,
                                                                 ref_obs)
    root, children = _tree(logs["port"], got.trace_id, port_obs)
    assert root == "parse.request"
    assert {c for c, _ in children} == {"phase.reach", "phase.join", "phase.build_merge",
                                        "phase.host_build"}
    plain = Parser.from_matrices(artifacts(AMBIG)[1], ParserConfig(
        regex="<plain>", backend="torch", n_chunks=4), device="cpu")
    for t in (text, "ab" * 37, "", "axb"):
        assert np.array_equal(p.parse(t).forest.pack(), plain.parse(t).forest.pack())
        assert np.array_equal(p.parse(t).forest.pack(), r.parse(t).forest.pack())


def test_traced_submit_and_stream_span_trees_equal_reference(traced):
    p, r, logs = traced
    got, want = p.submit("abab" * 4).result(), r.submit("abab" * 4).result()
    assert _tree(logs["port"], got.trace_id, port_obs) == _tree(logs["ref"], want.trace_id,
                                                                 ref_obs)
    for parser in (p, r):
        with parser.open_stream() as st:
            st.append("abab")
            st.append("ab" * 10)
            st.edit(0, 2, "ba")
            assert st.result().ok
    for name, obs in PACKAGES:
        spans = obs.read_spans_jsonl(logs[name])
        roots = [s for s in spans if s["name"] == "stream.append"]
        assert len(roots) == 2
        for root in roots:
            tree = obs.validate_span_tree(spans, root["trace_id"])
            assert {c["name"] for c in tree["children"]} == {
                "stream.append_queue_wait", "stream.append_compute"}
    names = {n: sorted({s["name"] for s in obs.read_spans_jsonl(logs[n])})
             for n, obs in PACKAGES}
    assert names["port"] == names["ref"]


def test_metrics_follow_the_reference(traced):
    p, r, _ = traced
    for parser in (p, r):
        parser.parse("abab")
        parser.parse("abab")
        parser.submit("abab").result()
        parser.parse_batch(["ab", "ab" * 20])
    sp, sr = p.stats()["metrics"], r.stats()["metrics"]
    port_obs.validate_metric_names(sp)
    for name in ("requests_total", "served_total", "batches_total", "chars_total",
                 "spans_recorded_total", "bucket_cache_hits_total",
                 "bucket_cache_misses_total"):
        assert sp[name] == sr[name], name
    assert sp["compiled_programs_total"][0]["value"] >= 1


def test_profiler_ranges_and_close_flushes(tmp_path):
    log = tmp_path / "s.jsonl"
    p = Parser(ParserConfig(regex=AMBIG, backend="torch", n_chunks=4,
                            obs=ObsConfig(enabled=True, span_log=str(log), profiler=True)),
               device="cpu")
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r = p.parse("abab")
    keys = {e.key for e in prof.key_averages()}
    assert {"parse.request", "phase.reach", "phase.join", "phase.build_merge"} <= keys
    p.close()
    assert p.obs._span_sink._fh.closed
    assert port_obs.validate_span_tree(port_obs.read_spans_jsonl(log), r.trace_id)
