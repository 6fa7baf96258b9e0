"""repro_torch's parse and stream services, and the facade over them, against
repro's, on the CPU.

The flows of ``tests/test_parse_service.py`` and
``tests/test_stream_service.py`` run through both packages: weighted-fair
serve order, ``max_batch`` and FIFO, cancellation, admission errors and
budgets, eviction order and exactness under a bytes budget, and the
``stats`` keys.  Serve orders, counts, errors and SLPF bits must be equal;
latency-valued fields are compared by key and type only.  The facade's
``submit`` / ``ParseTicket``, ``deadline_s``, ``trace_id`` and ``stats()``
keys are held against ``repro.Parser``'s.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_corpus import artifacts  # noqa: E402

import repro  # noqa: E402
from repro.core.engine import ParserEngine as RefEngine  # noqa: E402
from repro.serve.parse_service import ParseService as RefParseService  # noqa: E402
from repro.serve.stream_service import StreamService as RefStreamService  # noqa: E402
from repro_torch import (  # noqa: E402
    AdmissionError,
    ParseTicket,
    Parser,
    ParserConfig,
    SessionNotFound,
)
from repro_torch.core.engine import ParserEngine  # noqa: E402
from repro_torch.serve.parse_service import LATENCY_WINDOW, BucketStats, ParseService  # noqa: E402
from repro_torch.serve.stream_service import StreamService  # noqa: E402

AMBIG = "(a|b|ab)+"
BACKENDS = {"torch": "jnp", "packed": "packed"}

_engines: dict = {}


def engines(backend="torch"):
    if backend not in _engines:
        art, port_m, _ = artifacts(AMBIG)
        _engines[backend] = (ParserEngine(port_m, backend=backend, device="cpu"),
                             RefEngine(art.matrices, backend=BACKENDS[backend]))
    return _engines[backend]


def services(cls_pair, backend="torch", **kw):
    port_eng, ref_eng = engines(backend)
    port_cls, ref_cls = cls_pair
    return port_cls._internal(port_eng, **kw), ref_cls._internal(ref_eng, **kw)


PARSE = (ParseService, RefParseService)
STREAM = (StreamService, RefStreamService)


def same_shape(got, want, path="stats"):
    """Equal nested keys; equal values except floats, which need only be
    floats (latencies differ between runs), and ``compile_count``, which
    counts shapes run in the port and traces in the reference (engines
    shared across tests run different shape sets)."""
    if path.endswith("['compile_count']"):
        assert isinstance(got, int) and got >= 1, path
    elif isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            same_shape(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, float):
        assert isinstance(got, float), path
    elif isinstance(want, str) and path.endswith("['backend']"):
        assert {"jnp": "torch"}.get(want, want) == got, path
    else:
        assert got == want, (path, got, want)


# ------------------------------------------------------------ parse service


def test_mixed_lengths_exact_and_same_completion_order():
    p, r = services(PARSE, max_batch=4, n_chunks=4)
    texts = ["abab", "", "b", "a" * 23, "ab" * 40, "ba", "ababab"]
    assert [p.submit(t) for t in texts] == [r.submit(t) for t in texts]
    got, want = p.run(), r.run()
    assert [q.rid for q in got] == [q.rid for q in want]
    for a, b in zip(got, want):
        assert np.array_equal(a.slpf.pack(), b.slpf.pack())
        assert a.bucket == b.bucket
    assert p.batches_run == r.batches_run
    same_shape(p.stats, r.stats)


@pytest.mark.parametrize("max_batch,n,batches", [(8, 8, 1), (2, 5, 3)])
def test_max_batch_and_fifo(max_batch, n, batches):
    p, r = services(PARSE, max_batch=max_batch, n_chunks=4)
    for i in range(n):
        p.submit("ab" * (i % 5 + 1))
        r.submit("ab" * (i % 5 + 1))
    got, want = p.run(), r.run()
    assert [q.rid for q in got] == [q.rid for q in want] == list(range(n))
    assert p.batches_run == r.batches_run == batches


@pytest.mark.parametrize("weights,order_len", [((1.0, 2.0), 8), ((1.0, 1.0), 6)])
def test_weighted_fair_serve_order(weights, order_len):
    p, r = services(PARSE, max_batch=1, n_chunks=4)
    for svc in (p, r):
        svc.register_tenant("a", weight=weights[0])
        svc.register_tenant("b", weight=weights[1])
        for _ in range(order_len // 2):
            svc.submit("abab", tenant="a")
        for _ in range(order_len // 2):
            svc.submit("abab", tenant="b")
    got, want = [q.tenant for q in p.run()], [q.tenant for q in r.run()]
    assert got == want
    if weights == (1.0, 2.0):
        assert got == ["a", "b", "b", "a", "b", "b", "a", "a"]


def test_no_starvation_and_riders_across_tenants():
    p, r = services(PARSE, max_batch=1, n_chunks=4)
    for svc in (p, r):
        svc.register_tenant("hot")
        svc.register_tenant("light")
        for _ in range(6):
            svc.submit("abab", tenant="hot")
        svc.step()
        svc.submit("abab", tenant="light")
        svc.step()
    same_shape(p.stats, r.stats)
    assert p.stats["tenants"]["light"]["served"] == 1

    p, r = services(PARSE, max_batch=4, n_chunks=4)
    for svc in (p, r):
        for tenant, text in (("a", "abab"), ("b", "baba"), ("a", "abba")):
            svc.submit(text, tenant=tenant)
        assert svc.step() is True
    same_shape(p.stats, r.stats)
    assert p.batches_run == 1 and p.stats["tenants"]["b"]["vtime"] > 0.0


def test_cancel_never_burns_a_slot_or_a_sample(monkeypatch):
    p, r = services(PARSE, max_batch=4, n_chunks=4)
    rows = {}
    for name, svc in (("port", p), ("ref", r)):
        reqs = [svc.submit_request("abab") for _ in range(3)]
        orig = svc.engine.parse_batch
        seen = rows.setdefault(name, [])
        monkeypatch.setattr(svc.engine, "parse_batch",
                            lambda cl, n_chunks=None, orig=orig, seen=seen:
                            seen.append(len(cl)) or orig(cl, n_chunks=n_chunks))
        assert svc.cancel(reqs[1].rid) is True
        assert svc.cancel(reqs[1].rid) is False
        assert svc.pending == 2
        assert svc.step() is True
        assert reqs[1].cancelled and reqs[1].latency_s is None
        assert svc._buckets[reqs[0].bucket].served == 2
        assert svc.cancel(reqs[0].rid) is False
        monkeypatch.undo()
    assert rows["port"] == rows["ref"] == [2]


def test_admission_errors_and_budgets():
    for svc in services(PARSE, max_batch=4, n_chunks=4, max_pending=2):
        svc.register_tenant("vip", max_pending=1)
        svc.submit("abab", tenant="vip")
        with pytest.raises(Exception, match="vip") as e:
            svc.submit("abab", tenant="vip")
        assert type(e.value).__name__ == "BudgetExceeded"
        svc.submit("abab")
        with pytest.raises(Exception, match="max_pending") as e:
            svc.submit("ab")
        assert type(e.value).__name__ == "BudgetExceeded"
        svc.run()
        bucket = svc.engine.bucket_shape(4, 4)
        svc._buckets[bucket].record(1e3)          # an observed p99 of 1000 s
        with pytest.raises(Exception, match="exceeds the remaining deadline") as e:
            svc.submit("abab", deadline_s=0.1)
        assert type(e.value).__name__ == "AdmissionError"
        assert e.value.bucket == bucket and e.value.predicted_s == 1e3
        with pytest.raises(Exception, match="deadline"):
            svc.submit("abab", deadline_s=0.0)     # a blown budget never admits
        svc.submit("abab", deadline_s=1e4)         # within budget: admitted
        svc.submit("ab" * 40, deadline_s=1e-9)     # a cold bucket admits
        causes = {s["labels"]["cause"]: s["value"] for s in
                  svc.engine.obs.metrics.snapshot()["admission_rejects_total"]
                  if s["labels"]["service"] == "parse"}
        assert causes["tenant_budget"] >= 1 and causes["budget"] >= 1
        assert causes["deadline"] >= 2


def test_stats_keys_and_percentiles():
    p, r = services(PARSE, max_batch=2, n_chunks=4)
    for svc in (p, r):
        for t in ["abab", "ba", "a" * 60, "ababab"]:
            svc.submit(t)
        assert svc.stats["pending"] == 4 and svc.stats["peak_queue_depth"] == 4
        svc.run()
    same_shape(p.stats, r.stats)
    for v in p.stats["buckets"].values():
        assert 0.0 <= v["p50_latency_s"] <= v["p99_latency_s"] <= v["max_latency_s"]


def test_bucket_stats_windows_and_deprecated_construction():
    s = BucketStats()
    for _ in range(100):
        s.record(0.2, queue_s=0.0, compute_s=0.2)
    for _ in range(LATENCY_WINDOW + 100):
        s.record(1.5, queue_s=1.0, compute_s=0.5)
    d = s.as_dict()
    assert d["p50_queue_s"] == d["p99_queue_s"] == 1.0
    assert d["p50_compute_s"] == 0.5 and d["served"] == LATENCY_WINDOW + 200
    with pytest.warns(DeprecationWarning, match="repro_torch.Parser"):
        ParseService(engines()[0])
    with pytest.warns(DeprecationWarning, match="open_stream"):
        StreamService(engines()[0])
    with pytest.raises(ValueError, match="prebuilt ParserEngine"):
        ParseService._internal(engines()[0], backend="packed")


# ----------------------------------------------------------- stream service


def _slpf_both(p, r, sid, text):
    got = p.slpf(sid)
    assert np.array_equal(got.pack(), r.slpf(sid).pack())
    assert np.array_equal(got.pack(), engines()[0].parse(text).pack()), text


def test_interleaved_sessions_exact():
    p, r = services(STREAM, max_batch=4, first_seal_len=4)
    texts = {0: "abab" * 3, 1: "b" + "ab" * 10, 2: "ba", 3: ""}
    sids = {k: (p.open(), r.open()) for k in texts}
    offsets = {k: 0 for k in texts}
    while any(offsets[k] < len(texts[k]) for k in texts):
        for k in texts:
            piece = texts[k][offsets[k]: offsets[k] + 2]
            offsets[k] += len(piece)
            if piece:
                assert p.append(sids[k][0], piece) == r.append(sids[k][1], piece)
    p.drain()
    r.drain()
    assert p.batches_run == r.batches_run
    for k, text in texts.items():
        _slpf_both(p, r, sids[k][0], text)
    same_shape(p.stats, r.stats)


def test_same_bucket_sessions_share_one_reach_and_max_batch():
    p, r = services(STREAM, max_batch=8, first_seal_len=8)
    for svc in (p, r):
        sids = [svc.open() for _ in range(8)]
        for sid in sids:
            svc.append(sid, "abab")
        svc.drain()
        assert svc.batches_run == 1 and svc.pending_chars == 0
    calls = []
    eng = engines()[0]
    orig = eng.phases.reach
    eng.phases.reach = lambda N, ch: calls.append(tuple(ch.shape)) or orig(N, ch)
    try:
        p, r = services(STREAM, max_batch=2, first_seal_len=8)
        for svc in (p, r):
            for sid in [svc.open() for _ in range(5)]:
                svc.append(sid, "ab")
            svc.drain()
            assert svc.batches_run == 3
    finally:
        eng.phases.reach = orig
    assert calls == [(2, 8), (2, 8), (1, 8)]    # one reach a step, sessions on axis 0


@pytest.mark.parametrize("backend", ["torch", "packed"])
def test_eviction_by_bytes_budget_is_exact(backend):
    eng = engines(backend)[0]
    lp = eng.tables.ell_pad
    per_product = lp * lp * 4 if backend == "torch" else lp * (lp // 32) * 4
    p, r = services(STREAM, backend, max_batch=4, first_seal_len=4,
                    cache_budget_bytes=3 * per_product)
    texts = {0: "abab" * 4, 1: "ab" * 9, 2: "ba" + "ab" * 6}
    sids = {k: (p.open(), r.open()) for k in texts}
    for k, text in texts.items():
        p.append(sids[k][0], text)
        r.append(sids[k][1], text)
    p.drain()
    r.drain()
    assert p.evictions == r.evictions > 0
    assert p.bytes_cached == r.bytes_cached
    for k, text in texts.items():
        _slpf_both(p, r, sids[k][0], text)
    assert p.stats["rebuilds"] == r.stats["rebuilds"] > 0


@pytest.mark.parametrize("backend", ["torch", "packed"])
def test_cost_aware_eviction_order(backend):
    p, r = services(STREAM, backend, max_batch=4, first_seal_len=4)
    eng = engines(backend)[0]
    lp = eng.tables.ell_pad
    per_product = lp * lp * 4 if backend == "torch" else lp * (lp // 32) * 4
    text = "ab" * 14                            # sealed 4, 8, 16
    trail = {}
    for name, svc in (("port", p), ("ref", r)):
        sids = [svc.open() for _ in range(3)]
        for sid in sids:
            svc.append(sid, text)
        svc.drain()

        def lens(sid, svc=svc):
            return sorted(c for _, c, _ in svc._sessions[sid].parser.sealed_cache_entries())

        steps = []
        for _ in range(2):
            svc.cache_budget_bytes = svc.bytes_cached - per_product
            svc._maybe_evict()
            steps.append((svc.evictions, [lens(s) for s in sids]))
        trail[name] = steps
        for sid in sids:
            assert np.array_equal(svc.slpf(sid).pack(), engines()[0].parse(text).pack())
    assert trail["port"] == trail["ref"]
    assert trail["port"][-1] == (2, [[4, 8], [4, 8], [4, 8, 16]])


def test_eviction_converges_below_the_join_cache_and_falls_back():
    p, r = services(STREAM, max_batch=4, first_seal_len=4)
    out = []
    for svc in (p, r):
        a, b = svc.open(), svc.open()
        for sid in (a, b):
            svc.append(sid, "ab" * 14)
            svc.slpf(sid)
        pa = svc._sessions[a].parser
        join_bytes = pa._join_nbytes()
        svc.cache_budget_bytes = join_bytes // 2
        svc._maybe_evict()
        assert pa.cache_nbytes == 0 and not pa._cold
        svc.slpf(a)
        out.append((join_bytes, pa.rebuilds, svc._sessions[b].parser.cache_nbytes))
    assert out[0] == out[1] and out[0][1] == 3

    p, r = services(STREAM, max_batch=4, first_seal_len=4, cache_budget_bytes=1)
    for svc in (p, r):
        a, b = svc.open(), svc.open()
        svc.append(a, "abab" * 3)
        svc.append(b, "abab" * 3)
        svc.drain()
        assert svc._sessions[a].parser.cache_nbytes == 0
        assert svc._sessions[b].parser.cache_nbytes > 0


def test_stream_admission_budgets_and_sessions():
    for svc in services(STREAM, first_seal_len=4, max_pending_chars=6):
        sid = svc.open()
        svc.append(sid, "abab")
        with pytest.raises(Exception, match="max_pending_chars") as e:
            svc.append(sid, "abab")
        assert type(e.value).__name__ == "BudgetExceeded"
        svc.drain()
        svc._buckets[8].record(1e3)
        with pytest.raises(Exception, match="exceeds the remaining deadline") as e:
            svc.append(sid, "ab", deadline_s=0.1)
        assert type(e.value).__name__ == "AdmissionError"
        svc.close(sid)
        with pytest.raises(KeyError):
            svc.slpf(sid)
        assert svc.stats["sessions"] == 0 and svc.bytes_cached == 0
    with pytest.raises(SessionNotFound):
        services(STREAM)[0].close(7)


def test_stream_stats_and_drain_only_that_session():
    p, r = services(STREAM, max_batch=4, first_seal_len=8)
    for svc in (p, r):
        a, b = svc.open(), svc.open()
        svc.append(a, "abab")
        svc.append(b, "ab" * 8)
        svc.slpf(a)
        assert svc.stats["pending_chars"] == 16
        svc.drain()
        svc.slpf(a)
    same_shape(p.stats, r.stats)
    assert p.stats["peak_queue_depth"] == 2


# ------------------------------------------------------------------- facade


def _facade_pair(**cfg):
    art, port_m, _ = artifacts(AMBIG)
    cfg = {"regex": "<svc>", "n_chunks": 4, **cfg}
    port = Parser.from_matrices(port_m, ParserConfig(backend="torch", **cfg), device="cpu")
    ref = repro.Parser.from_matrices(art.matrices, repro.ParserConfig(**cfg))
    return port, ref


def test_facade_submit_tickets_and_parse_batch():
    p, r = _facade_pair(max_batch=4)
    texts = ["abab", "", "ab" * 30, "axb", "ba"]
    tickets = [p.submit(t, deadline_s=30.0) for t in texts]
    assert all(isinstance(t, ParseTicket) for t in tickets)
    assert not any(t.done() for t in tickets)
    got = [t.result() for t in tickets]
    want = r.parse_batch(texts, deadline_s=30.0)
    for a, b in zip(got, want):
        assert np.array_equal(a.forest.pack(), b.forest.pack())
        assert (a.ok, a.bucket, a.trace_id) == (b.ok, b.bucket, b.trace_id)
    assert [x.forest.pack().tobytes() for x in p.parse_batch(texts)] == \
        [x.forest.pack().tobytes() for x in want]
    for parser in (p, r):
        t = parser.submit("abab")
        assert t.cancel() is True
        with pytest.raises(Exception, match="was cancelled"):
            t.result()
        assert t.cancel() is False


def test_facade_deadline_admission_and_all_or_nothing_batch():
    for parser in _facade_pair(max_pending=3):
        parser.parse("abab")                     # seeds the bucket's window
        with pytest.raises(Exception, match="deadline") as e:
            parser.parse("abab", deadline_s=1e-9)
        assert type(e.value).__name__ == "AdmissionError"
        with pytest.raises(Exception, match="max_pending") as e:
            parser.parse_batch(["ab"] * 4)
        assert type(e.value).__name__ == "BudgetExceeded"
        assert parser.parse_service.pending == 0   # the queued three were cancelled
    p, _ = _facade_pair(slo={"default_deadline_s": 1e-9})
    p.parse("abab")                              # a cold bucket admits
    with pytest.raises(AdmissionError):
        p.parse("abab")                          # the config's default deadline


def test_facade_stats_keys_match_reference():
    # targets no served bucket can meet, so the SLO grades do not hang on
    # timing: False for every served bucket, True for a bucket still unserved
    p, r = _facade_pair(max_batch=4, slo={"p50_s": 1e-9, "p99_s": 1e-9}, analyze="off")
    for parser in (p, r):
        parser.parse("abab")
        parser.parse_batch(["ab", "ab" * 30])
        with parser.open_stream() as st:
            st.append("abab")
            st.result()
    sp, sr = p.stats(), r.stats()
    assert set(sp) == set(sr)
    assert sp["hlo"] is None and set(sp["analysis"]) == set(sr["analysis"])
    for key, value in sp["analysis"].items():
        if key not in ("cost", "recommended_backend"):
            assert value == sr["analysis"][key], key
    for key in ("parse", "stream", "slo"):
        same_shape(sp[key], sr[key], key)
    assert set(sp["metrics"]) == set(sr["metrics"]) - {"analyzer_verdicts_total"}
    for name, series in sp["metrics"].items():
        want = {tuple(sorted(s["labels"].items())): s["value"] for s in sr["metrics"][name]}
        for s in series:
            key = tuple(sorted(s["labels"].items()))
            if name.endswith("_total") and name != "compiled_programs_total":
                assert s["value"] == want[key], (name, key)
    assert sp["compile_count"] >= 1 and sp["pending"] == 0


def test_facade_sparse_speculation_stats():
    art, port_m, _ = artifacts(AMBIG)
    cfg = {"regex": "<spec>", "n_chunks": 4, "backend": "sparse"}
    p = Parser.from_matrices(port_m, ParserConfig(**cfg), device="cpu")
    r = repro.Parser.from_matrices(art.matrices, repro.ParserConfig(**cfg))
    for parser in (p, r):
        for text in ("abab", "ab" * 20, "abab"):
            parser.parse(text)
    assert p.stats()["speculation"] == r.stats()["speculation"]
    hp = p.stats()["metrics"]["speculation_width"]
    hr = r.stats()["metrics"]["speculation_width"]
    assert hp == hr
