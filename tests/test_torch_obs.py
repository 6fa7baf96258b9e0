"""repro_torch's observability layer (``repro_torch.obs``) against repro's.

The port keeps its own copy of ``repro/obs``: the metric catalog must be
the reference's name for name; the same counter / gauge / histogram
operations must give equal ``snapshot()`` and Prometheus text; the span
tree check must accept and reject the same inputs; and a traced
``Parser.parse`` must leave every span name of the reference's tree in the
JSONL log, with columns equal to the untraced route's.

The port traces the route an untraced call runs (the parse service, the
fused core), with a span at each layer boundary: the tests hold its span
trees, that it never synchronizes, that tracing off builds no span, and the
spans' start on the profiler's clock.
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_corpus import artifacts  # noqa: E402

import repro  # noqa: E402
import repro.obs as ref_obs  # noqa: E402
import repro_torch  # noqa: E402
import repro_torch.obs as port_obs  # noqa: E402
from repro_torch import ObsConfig, Parser, ParserConfig  # noqa: E402
from repro_torch.core.engine import ParserEngine  # noqa: E402
from repro_torch.obs import trace as port_trace  # noqa: E402
from repro_torch.obs.device import DeviceTimer  # noqa: E402

AMBIG = "(a|b|ab)+"
PACKAGES = [("port", port_obs), ("ref", ref_obs)]
# the reference's BENCH_*.json exporters and its one-shot span dump: the
# port's benchmark prints result lines, and nothing calls the dump
NOT_PORTED = {"BENCH_SCHEMA_KEYS", "validate_bench_report", "write_bench_json",
              "write_spans_jsonl"}


def test_metric_catalog_and_schemas_equal_reference():
    assert port_obs.METRIC_CATALOG == ref_obs.METRIC_CATALOG
    assert port_obs.SPAN_SCHEMA_KEYS == ref_obs.SPAN_SCHEMA_KEYS
    assert sorted(port_obs.__all__) == sorted(set(ref_obs.__all__) - NOT_PORTED)
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
        if name == "port":
            # the port's spans also carry their start on the profiler's clock
            assert all(isinstance(s["attrs"].pop("t_trace_ns"), int) for s in spans)
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


def _names(tree):
    root, children = tree
    return {root} | {c for c, _ in children} | {p for _, p in children}


def test_traced_parse_span_tree_equals_reference(traced):
    p, r, logs = traced
    text = "abab" * 8
    got, want = p.parse(text), r.parse(text)
    assert got.trace_id is not None and want.trace_id is not None
    port = _tree(logs["port"], got.trace_id, port_obs)
    ref = _tree(logs["ref"], want.trace_id, ref_obs)
    assert port[0] == ref[0] == "parse.request"
    assert _names(ref) == {"parse.request", "phase.reach", "phase.join", "phase.build_merge",
                           "phase.host_build"}
    assert _names(ref) <= _names(port)
    plain = Parser.from_matrices(artifacts(AMBIG)[1], ParserConfig(
        regex="<plain>", backend="torch", n_chunks=4), device="cpu")
    for t in (text, "ab" * 37, "", "axb"):
        assert np.array_equal(p.parse(t).forest.pack(), plain.parse(t).forest.pack())
        assert np.array_equal(p.parse(t).forest.pack(), r.parse(t).forest.pack())


def test_traced_submit_and_stream_span_trees_equal_reference(traced):
    p, r, logs = traced
    got, want = p.submit("abab" * 4).result(), r.submit("abab" * 4).result()
    assert _names(_tree(logs["port"], got.trace_id, port_obs)) >= \
        _names(_tree(logs["ref"], want.trace_id, ref_obs))
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
            assert {c["name"] for c in tree["children"]} >= {
                "stream.append_queue_wait", "stream.append_compute"}
    names = {n: {s["name"] for s in obs.read_spans_jsonl(logs[n])} for n, obs in PACKAGES}
    assert names["port"] >= names["ref"]


def test_metrics_follow_the_reference(traced):
    p, r, _ = traced
    plain = repro.Parser.from_matrices(artifacts(AMBIG)[0].matrices,
                                       repro.ParserConfig(regex="<obs>", n_chunks=4))
    for parser in (p, r, plain):
        parser.parse("abab")
        parser.parse("abab")
        parser.submit("abab").result()
        parser.parse_batch(["ab", "ab" * 20])
    sp, sr, su = p.stats()["metrics"], r.stats()["metrics"], plain.stats()["metrics"]
    port_obs.validate_metric_names(sp)
    for name in ("requests_total", "served_total", "chars_total"):
        assert sp[name] == sr[name], name
    # the port's traced calls run the untraced route: batches and bucket
    # shapes as the reference's untraced parser counts them (its traced
    # parse runs queue-free)
    for name in ("batches_total", "bucket_cache_hits_total", "bucket_cache_misses_total"):
        assert sp[name] == su[name], name
    assert sp["spans_recorded_total"][0]["value"] == len(p.obs.tracer.spans)
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


# ------------------------------------------------- the route a trace follows

TEXTS = ["abab" * 8, "ab" * 37, "", "axb"]
PHASES = {"phase.pad", "phase.reach", "phase.join", "phase.build_merge", "phase.d2h",
          "phase.host_build"}
REQUEST = {"parse.plan", "parse.admit", "parse.queue_wait", "parse.batch_compute"}


def _parser(obs=None, **kw):
    return Parser.from_matrices(artifacts(AMBIG)[1], ParserConfig(
        regex="<obs>", backend="torch", n_chunks=4, obs=obs, **kw), device="cpu")


@pytest.mark.parametrize("text", TEXTS)
def test_traced_parse_runs_the_service_route(text):
    p, plain = _parser({"enabled": True}), _parser()
    r = repro.Parser.from_matrices(artifacts(AMBIG)[0].matrices,
                                   repro.ParserConfig(regex="<obs>", n_chunks=4))
    got = p.parse(text)
    assert p.parse_service.batches_run == 1
    assert np.array_equal(got.forest.pack(), plain.parse(text).forest.pack())
    assert np.array_equal(got.forest.pack(), r.parse(text).forest.pack())


def _inside(child, parent):
    eps = 1e-6
    return (parent["t_start_s"] - eps <= child["t_start_s"]
            and child["t_start_s"] + child["duration_s"]
            <= parent["t_start_s"] + parent["duration_s"] + eps)


@pytest.mark.parametrize("route", ["parse", "submit", "parse_batch"])
def test_traced_span_tree_follows_the_route(route, tmp_path):
    log = tmp_path / "spans.jsonl"
    p = _parser({"enabled": True, "span_log": str(log)})
    texts = ["abab" * 8, "ab" * 16]                 # one bucket: one batch
    if route == "parse":
        results = [p.parse(texts[0])]
    elif route == "submit":
        results = [p.submit(texts[0]).result()]
    else:
        results = p.parse_batch(texts)
    p.close()
    spans = port_obs.read_spans_jsonl(log)
    by_id = {s["span_id"]: s for s in spans}
    computes = []
    for r in results:
        tree = port_obs.validate_span_tree(spans, r.trace_id)
        root = tree["root"]
        assert root["name"] == "parse.request"
        direct = [c for c in tree["children"] if c["parent_id"] == root["span_id"]]
        assert sorted(c["name"] for c in direct) == sorted(REQUEST)
        for c in tree["children"]:
            assert _inside(c, by_id[c["parent_id"]]), (c["name"], by_id[c["parent_id"]]["name"])
        computes += [c for c in direct if c["name"] == "parse.batch_compute"]
    # the batch's phases hang under its head's live batch_compute span
    phases = [s for s in spans if s["parent_id"] in {c["span_id"] for c in computes}]
    assert {s["name"] for s in phases} == PHASES
    assert sum(s["name"] == "phase.host_build" for s in phases) == len(results)
    for s in phases:
        assert all(key in s["attrs"] for key in {
            "phase.pad": ("bytes",), "phase.d2h": ("bytes",),
            "phase.host_build": ("n_chars", "minor_faults"),
        }.get(s["name"], ("bucket",)))
    riders = [c for c in computes if "batch_trace_id" in c["attrs"]]
    assert len(riders) == len(results) - 1
    assert all(c["attrs"]["batch_trace_id"] == results[0].trace_id for c in riders)


def _boom(*args, **kwargs):
    raise AssertionError("tracing synchronized the device")


def test_tracing_never_synchronizes(monkeypatch):
    monkeypatch.setattr(ParserEngine, "_sync", _boom, raising=False)
    monkeypatch.setattr(torch.cuda, "synchronize", _boom)
    p = _parser({"enabled": True})
    assert p.parse("abab" * 8).ok
    with p.open_stream() as st:
        st.append("abab")
        assert p.stream_service.step()
        assert st.accepted
    names = {s.name for s in p.obs.tracer.spans}
    assert {"phase.reach", "stream.step", "stream.reach"} <= names


def test_tracing_off_builds_no_span_and_no_event(monkeypatch):
    made = []

    class CountedSpan(port_trace.Span):
        def __init__(self, *args, **kwargs):
            made.append("span")
            super().__init__(*args, **kwargs)

    def counted_event(*args, **kwargs):
        made.append("event")
        raise AssertionError("an event was made with tracing off")

    monkeypatch.setattr(port_trace, "Span", CountedSpan)
    monkeypatch.setattr(torch.cuda, "Event", counted_event)
    p = _parser()
    assert p.parse("abab" * 8).ok
    with p.open_stream() as st:
        st.append("abab")
        assert p.stream_service.step()
        assert st.accepted
    assert made == []
    traced = _parser({"enabled": True})
    traced.parse("abab")
    assert "span" in made                   # the counter does see spans


def test_span_start_is_on_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile

    p = _parser(ObsConfig(enabled=True, profiler=True))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        p.parse("abab" * 8)
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            ranges.setdefault(e.name(), []).append(e.start_ns())
    live = [s for s in p.obs.tracer.spans if s.name in ranges]
    assert {s.name for s in live} >= {"parse.request", "parse.plan", "parse.batch_compute",
                                     "phase.reach", "phase.host_build"}
    for s in live:
        off = min(abs(s.attrs["t_trace_ns"] - t) for t in ranges[s.name])
        assert off < 1_000_000, (s.name, off)


def test_traced_stream_spans(tmp_path):
    log = tmp_path / "spans.jsonl"
    p = _parser({"enabled": True, "span_log": str(log)}, max_batch=4)
    streams = [p.open_stream() for _ in range(3)]
    for i, st in enumerate(streams):
        st.append("ab" * (i + 1))
    assert p.stream_service.step()
    assert not p.stream_service.step()
    p.close()
    spans = port_obs.read_spans_jsonl(log)
    for root in (s for s in spans if s["name"] == "stream.append"):
        tree = port_obs.validate_span_tree(spans, root["trace_id"])
        assert "stream.append_admit" in {c["name"] for c in tree["children"]}
    (step,) = [s for s in spans if s["name"] == "stream.step"]
    tree = port_obs.validate_span_tree(spans, step["trace_id"])
    assert {c["name"] for c in tree["children"]} == {"stream.pack", "stream.reach",
                                                     "stream.absorb"}
    assert step["attrs"]["pieces"] == step["attrs"]["composes"] == len(streams)
    assert step["attrs"]["chars"] == sum(2 * (i + 1) for i in range(len(streams)))
    for c in tree["children"]:
        assert _inside(c, step)


class FakeEvent:
    """A CUDA event on a fake device clock: ``query`` is True once the test
    has run the device past it."""

    device_ms = 0.0
    recorded = []

    def __init__(self, enable_timing=False):
        self.at = None

    def record(self, stream=None):
        FakeEvent.recorded.append(self)

    def query(self):
        return self.at is not None

    def elapsed_time(self, other):
        assert self.query() and other.query()
        return other.at - self.at

    @classmethod
    def run_device(cls, until_ms):
        for e in cls.recorded:
            if e.at is None:
                cls.device_ms = max(cls.device_ms, until_ms)
                e.at = cls.device_ms
        cls.recorded = []


def test_device_timer_places_intervals_without_waiting(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda device=None: 123)
    monkeypatch.setattr(torch.cuda, "synchronize", _boom)
    FakeEvent.recorded, FakeEvent.device_ms = [], 0.0
    tracer = port_obs.Tracer(enabled=True)
    timer = DeviceTimer(tracer, torch.device("cuda"))
    with tracer.span("parse.batch_compute", trace_id="t") as parent:
        with timer.phase("phase.reach", bucket=[4, 8]):
            pass
        timer.resolve()                         # nothing complete: nothing emitted
        assert [s.name for s in tracer.spans] == []
        FakeEvent.run_device(2.0)               # reach ends at 2.0 ms device time
        timer.anchor_if_idle()                  # idle: an anchor at host time now
        t_anchor = time.perf_counter()
        timer.resolve()                         # the anchor itself is still pending
        assert [s.name for s in tracer.spans] == []
        FakeEvent.run_device(5.0)               # the anchor completes at 5.0 ms
        timer.resolve()
    (reach,) = [s for s in tracer.spans if s.name == "phase.reach"]
    assert reach.parent_id == parent.span_id and reach.trace_id == "t"
    assert reach.attrs["mem_allocated_bytes"] == 123 and reach.attrs["bucket"] == [4, 8]
    assert reach.duration_s == pytest.approx(0.0)
    # 2.0 ms of device time before an anchor read at about t_anchor
    assert reach.t_start_s == pytest.approx(t_anchor - 3e-3, abs=1e-3)
    assert reach.attrs["t_trace_ns"] == tracer.trace_ns(reach.t_start_s)
    with timer.phase("phase.join"):
        pass
    timer.close()                               # never completed: dropped
    assert timer.dropped == 1 and "phase.join" not in {s.name for s in tracer.spans}


def test_device_timer_copy_back_ends_in_an_anchor(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda device=None: 123)
    monkeypatch.setattr(torch.cuda, "synchronize", _boom)
    FakeEvent.recorded, FakeEvent.device_ms = [], 0.0
    tracer = port_obs.Tracer(enabled=True)
    timer = DeviceTimer(tracer, torch.device("cuda"))
    with tracer.span("parse.batch_compute", trace_id="t"):
        with timer.phase("phase.build_merge"):
            pass
        with timer.phase("phase.d2h", drains=True, bytes=8):
            FakeEvent.run_device(4.0)           # the copy returns once the device is past it
        t_back = time.perf_counter()
        timer.anchor_if_idle()                  # the copy's end is an anchor already
        assert len(FakeEvent.recorded) == 1
        FakeEvent.run_device(4.0)               # the drained stream completes the anchor at once
        timer.resolve()
    spans = {s.name: s for s in tracer.spans}
    d2h, build = spans["phase.d2h"], spans["phase.build_merge"]
    assert d2h.attrs["bytes"] == 8 and "mem_allocated_bytes" not in d2h.attrs
    assert build.attrs["mem_allocated_bytes"] == 123
    assert d2h.attrs["host_wait_ms"] >= 0.0
    assert d2h.t_start_s == pytest.approx(t_back, abs=1e-3)
    assert build.t_start_s + build.duration_s <= d2h.t_start_s + 1e-9
