"""repro_torch's multi-tenant fleet against repro's, on the CPU.

Mirrors ``tests/test_fleet.py`` case for case: every tenant served through
the port's ``ParserFleet`` (and ``FleetEngine``) gives the SLPF of the
reference's fleet on the same tenants and texts, bit for bit (``torch`` ↔
``jnp``, ``packed`` ↔ ``packed``, ``sparse`` ↔ ``sparse``), across tenants
whose ℓp lands in the same or different automaton buckets and a
dense-fallback sparse tenant sharing a bucket with a reduced one; the
economics (compile count by buckets, the table cache) and the facade
(errors, stats, SLO grades, budgets, input order) behave as the
reference's.  Then the port's own: the compile count at T = 32, one call
of each phase a dispatch whatever T, the fleet equal to the port's solo
``Parser``, the tenant-axis plain versions equal to a per-tenant loop, and
the compiled tenant tables equal to the reference's.

Texts are drawn from a seed with numpy; no tolerance (OR-AND on {0,1} is
exact).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro  # noqa: E402
from repro.core import fleet as ref_fleet  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch import Parser, ParserConfig, ParserFleet  # noqa: E402
from repro_torch.core.backend import list_backends  # noqa: E402
from repro_torch.core.fleet import (  # noqa: E402
    FleetEngine,
    TenantSpec,
    _compile_tables,
    clear_table_cache,
    normalize_regex,
)
from repro_torch.core.matrices import (  # noqa: E402
    build_matrices,
    pack_transition_table_torch,
    sparse_init_rows,
)
from repro_torch.core.segments import compute_segments  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tests run many small tensor ops; under a parallel test run the
    intra-op thread pool of every worker competes for the same cores and
    makes each op wait, so this module runs them on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


RX_SMALL = "(a|b)*abb"
RX_MED = "(a|b)" * 10
RX_LONG = "a" * 40
RX_WIDE = "a?" * 6

TEXTS = {
    RX_SMALL: ["abb", "ababb", "bbabb", "a" * 7 + "bb"],
    RX_MED: ["ab" * 5, "ba" * 5, "a" * 10],
    RX_LONG: ["a" * 40],
    RX_WIDE: ["", "a", "aaa", "aaaaaa"],
}
# the port's backends on the CPU and the reference's of the same family
FAMILIES = {"torch": "jnp", "packed": "packed", "sparse": "sparse"}


def _rng_texts(seed, n, lengths, alphabet=b"ab"):
    rng = np.random.default_rng(seed)
    return [bytes(rng.choice(list(alphabet), size=int(L))) for L in lengths[:n]]


def _port_fleet(tenants, **kw):
    return ParserFleet(tenants, device="cpu", **kw)


def _cfg_pair(regex, backend, **kw):
    """(port config, reference config) of one tenant."""
    return (ParserConfig(regex=regex, backend=backend, **kw),
            repro.ParserConfig(regex=regex, backend=FAMILIES[backend], **kw))


def _fleet_pair(specs, **kw):
    """(port fleet, reference fleet) over {name: (regex, backend, options)}."""
    port, ref_ = {}, {}
    for name, (regex, backend, opts) in specs.items():
        port[name], ref_[name] = _cfg_pair(regex, backend, **opts)
    return _port_fleet(port, **kw), repro.ParserFleet(ref_, **kw)


def _assert_same(got, want):
    assert got.ok == want.ok
    assert np.array_equal(got.forest.classes, want.forest.classes)
    assert np.array_equal(got.forest.pack(), want.forest.pack())


# ------------------------------------------------------------- conformance


@pytest.mark.parametrize("backend", sorted(FAMILIES))
def test_fleet_conformant_per_backend(backend):
    """Each CPU backend, as a fleet tenant, gives the reference fleet's
    SLPF and its own solo Parser's on every text."""
    port, ref_ = _fleet_pair({"t": (RX_SMALL, backend, {"n_chunks": 4})})
    solo = Parser(ParserConfig(regex=RX_SMALL, backend=backend, n_chunks=4), device="cpu")
    texts = TEXTS[RX_SMALL] + _rng_texts(1, 4, [0, 5, 33, 70])
    for text in texts:
        got = port.parse("t", text)
        _assert_same(got, ref_.parse("t", text))
        _assert_same(got, solo.parse(text))
    assert list_backends() == sorted(["cuda", *FAMILIES])


def test_mixed_backend_tenants_one_batch():
    port, ref_ = _fleet_pair({b: (RX_SMALL, b, {"n_chunks": 4}) for b in FAMILIES})
    items = [(b, t) for b in FAMILIES for t in TEXTS[RX_SMALL] + _rng_texts(2, 2, [9, 17])]
    for got, want in zip(port.parse_batch(items), ref_.parse_batch(items)):
        _assert_same(got, want)


def test_same_and_different_lp_buckets():
    specs = {"small": (RX_SMALL, "torch", {"n_chunks": 4}),
             "med": (RX_MED, "torch", {"n_chunks": 4}),
             "long": (RX_LONG, "torch", {"n_chunks": 4})}
    port, ref_ = _fleet_pair(specs)
    eng = port.engine
    assert eng.tenant("small").bucket_key == eng.tenant("med").bucket_key
    assert eng.tenant("long").bucket_key != eng.tenant("small").bucket_key
    assert eng.n_buckets == ref_.engine.n_buckets == 2
    for name, (rx, _, _) in specs.items():
        for text in TEXTS[rx]:
            _assert_same(port.parse(name, text), ref_.parse(name, text))


def test_sparse_dense_fallback_shares_bucket():
    specs = {"reduced": (RX_SMALL, "sparse", {"n_chunks": 4}),
             "dense": (RX_WIDE, "sparse", {"n_chunks": 4})}
    port, ref_ = _fleet_pair(specs)
    eng = port.engine
    key = eng.tenant("reduced").bucket_key
    assert key == eng.tenant("dense").bucket_key
    assert eng.runner(key).backend._width == key[2]          # bucket-wide dense fallback
    for name, (rx, _, _) in specs.items():
        for text in TEXTS[rx]:
            _assert_same(port.parse(name, text), ref_.parse(name, text))


def test_sparse_bucket_width_grows_on_tenant_add():
    port, ref_ = _fleet_pair({"reduced": (RX_SMALL, "sparse", {"n_chunks": 4})})
    runner = port.engine.runner(port.engine.tenant("reduced").bucket_key)
    narrow = runner.backend._width
    _assert_same(port.parse("reduced", "ababb"), ref_.parse("reduced", "ababb"))
    compiled = port.compile_count
    for fleet, mk in ((port, ParserConfig), (ref_, repro.ParserConfig)):
        fleet.add("dense", mk(regex=RX_WIDE, backend="sparse", n_chunks=4))
    assert runner.backend._width > narrow
    _assert_same(port.parse("reduced", "ababb"), ref_.parse("reduced", "ababb"))
    assert port.compile_count == compiled + 1                  # a grown S: a new program
    for text in TEXTS[RX_SMALL]:
        _assert_same(port.parse("reduced", text), ref_.parse("reduced", text))


# ---------------------------------------------------------------- economics


def test_compile_count_scales_with_buckets_not_tenants():
    """12 same-bucket tenants, one text shape: one program, as the
    reference's."""
    port, ref_ = _fleet_pair({f"t{i}": (RX_SMALL, "torch", {"n_chunks": 4}) for i in range(12)})
    texts = [(f"t{i}", "ababb") for i in range(12)]
    for _ in range(2):                                         # steady state: still one
        for got, want in zip(port.parse_batch(texts), ref_.parse_batch(texts)):
            _assert_same(got, want)
        assert port.compile_count == ref_.compile_count == 1
    assert port.engine.n_buckets == 1


def _counter(fleet, name):
    snap = {str(k): v for k, v in fleet.obs.metrics.snapshot().items()}
    return snap[name][0]["value"] if name in snap else None


def test_table_cache_shared_across_fleets():
    clear_table_cache()
    patterns = {"a": RX_SMALL, "b": RX_MED}
    f1 = _port_fleet({k: ParserConfig(regex=v, backend="torch", n_chunks=4)
                      for k, v in patterns.items()})
    assert _counter(f1, "table_cache_misses_total") == 2.0
    assert _counter(f1, "table_cache_hits_total") is None
    f2 = _port_fleet({k: ParserConfig(regex=v, backend="torch", n_chunks=4)
                      for k, v in patterns.items()})
    assert _counter(f2, "table_cache_hits_total") == 2.0
    assert _counter(f2, "table_cache_misses_total") is None


def test_normalize_regex_is_structural():
    assert normalize_regex(RX_SMALL) == normalize_regex(RX_SMALL)
    assert normalize_regex("ab") != normalize_regex("ba")
    assert normalize_regex("(a)") != normalize_regex("a")     # groups number parens
    for a, b in (("ab", "ba"), ("(a)", "a"), (RX_SMALL, RX_SMALL)):
        assert (normalize_regex(a) == normalize_regex(b)) == \
            (ref_fleet.normalize_regex(a) == ref_fleet.normalize_regex(b))


def test_table_cache_key_includes_backend():
    clear_table_cache()
    fleet = _port_fleet({"j": ParserConfig(regex=RX_SMALL, backend="torch"),
                         "s": ParserConfig(regex=RX_SMALL, backend="sparse")})
    assert _counter(fleet, "table_cache_misses_total") == 2.0


# ------------------------------------------------------------------- facade


def test_fleet_engine_rejects_duplicate_and_unknown_tenants():
    eng = FleetEngine(device="cpu")
    eng.add_tenant("t", TenantSpec(regex=RX_SMALL, backend="torch"))
    with pytest.raises(ValueError, match="already registered"):
        eng.add_tenant("t", TenantSpec(regex=RX_SMALL, backend="torch"))
    with pytest.raises(KeyError, match="unknown fleet tenant"):
        eng.tenant("ghost")
    with pytest.raises(ValueError, match="runs only on the card"):
        eng.add_tenant("k", TenantSpec(regex=RX_SMALL, backend="cuda"))


def test_parser_fleet_rejects_mesh_and_unknown_tenant():
    fleet = _port_fleet({"t": ParserConfig(regex=RX_SMALL, backend="torch")})
    with pytest.raises(NotImplementedError, match="item 11"):
        fleet.add("m", ParserConfig(regex=RX_SMALL, backend="torch", mesh="host"))
    with pytest.raises(NotImplementedError, match="item 11"):
        ParserFleet({"t": ParserConfig(regex=RX_SMALL, backend="torch")}, device="cpu",
                    mesh="host")
    with pytest.raises(KeyError):
        fleet.parse("ghost", "abb")
    assert sorted(fleet.tenants) == ["t"]


def test_fleet_stats_shape_and_slo_grades():
    specs = {"fast": (RX_SMALL, "torch", {"n_chunks": 4, "weight": 2.0,
                                         "slo": {"p99_s": 1e4}}),
             "plain": (RX_MED, "torch", {"n_chunks": 4})}
    port, ref_ = _fleet_pair(specs)
    for fleet in (port, ref_):
        fleet.parse_batch([("fast", "abb"), ("plain", "ab" * 5)])
    s, r = port.stats(), ref_.stats()
    assert set(s) == set(r) and set(s["fleet"]) == set(r["fleet"])
    assert s["backend"] == "fleet"
    assert s["fleet"]["n_tenants"] == 2
    assert s["fleet"]["n_buckets"] == r["fleet"]["n_buckets"] == 1
    fast = s["tenants"]["fast"]
    assert set(fast) == set(r["tenants"]["fast"])
    assert fast["served"] == 1 and fast["weight"] == 2.0 and fast["backend"] == "torch"
    assert fast["slo"]["p99_ok"] is True
    assert "p99_ok" not in s["tenants"]["plain"]["slo"]
    assert s["metrics"]


def test_fleet_tenant_budget_rejected_typed():
    fleet = _port_fleet({"t": ParserConfig(regex=RX_SMALL, backend="torch", n_chunks=4,
                                           max_pending=2)})
    fleet.submit("t", "abb")
    fleet.submit("t", "abb")
    with pytest.raises(repro_torch.BudgetExceeded):
        fleet.submit("t", "abb")


def test_fleet_results_in_input_order_across_buckets():
    specs = {"small": (RX_SMALL, "torch", {"n_chunks": 4}),
             "long": (RX_LONG, "torch", {"n_chunks": 4})}
    port, ref_ = _fleet_pair(specs)
    items = [("long", "a" * 40), ("small", "abb"), ("small", "bab"), ("long", "a" * 39)]
    results = port.parse_batch(items)
    assert [r.ok for r in results] == [True, True, False, False]
    assert results[0].backend == "torch" and results[0].n_chunks == 4
    for got, want in zip(results, ref_.parse_batch(items)):
        _assert_same(got, want)
        assert got.bucket[1] == want.bucket[1]


# ------------------------------------------------------- the port's own


E_PATTERNS = [f"(a|b)*a(a|b){{{k}}}" for k in range(1, 9)]


def test_compile_count_at_32_tenants_is_per_bucket():
    """The reference benchmark's fleet (``benchmarks/run.py``
    ``multi_tenant``): 32 tenants over the 8 patterns (a|b)*a(a|b){k}, one
    text each: at most 2 programs an automaton bucket, table-cache misses =
    distinct patterns, every result the reference fleet's."""
    clear_table_cache()
    tenants = {f"t{i:02d}": E_PATTERNS[i % 8] for i in range(32)}
    port, ref_ = _fleet_pair({t: (p, "torch", {"n_chunks": 2}) for t, p in tenants.items()},
                             max_batch=32)
    texts = _rng_texts(42, 32, [16 - (i % 5) for i in range(32)])
    items = list(zip(tenants, texts))
    for _ in range(2):
        for got, want in zip(port.parse_batch(items), ref_.parse_batch(items)):
            _assert_same(got, want)
    assert port.compile_count <= 2 * port.engine.n_buckets
    assert port.engine.n_buckets == 1
    assert _counter(port, "table_cache_misses_total") == 8.0


class _Counting:
    """Wraps a bucket backend and counts the calls of each phase body and
    of its semiring product (K3's seat on the ``cuda`` backend)."""

    PHASES = ("reach", "join", "start_column", "build_merge_packed", "matmul", "compose")

    def __init__(self, backend):
        self.calls = {name: 0 for name in self.PHASES}
        for name in self.PHASES:
            if hasattr(backend, name):
                setattr(backend, name, self._count(name, getattr(backend, name)))

    def _count(self, name, fn):
        def call(*args, **kw):
            self.calls[name] += 1
            return fn(*args, **kw)
        return call


@pytest.mark.parametrize("backend", sorted(FAMILIES))
def test_one_call_of_each_phase_a_dispatch_whatever_T(backend):
    """A bucket dispatch calls each phase body once whether it serves 1 or
    32 tenants, and the join's products (K3 on the card) as often."""
    calls = {}
    for T in (1, 32):
        fleet = _port_fleet({f"t{i}": ParserConfig(regex=E_PATTERNS[i % 8], backend=backend,
                                                   n_chunks=4) for i in range(T)}, max_batch=64)
        key = fleet.engine.tenant("t0").bucket_key
        counting = _Counting(fleet.engine.runner(key).backend)
        items = [(f"t{i}", t) for i, t in enumerate(_rng_texts(T, T, [40] * T))]
        fleet.parse_batch(items)
        assert fleet.stats()["batches_run"] == 1
        for phase in ("reach", "join", "start_column", "build_merge_packed"):
            assert counting.calls[phase] == 1, (T, phase, counting.calls)
        calls[T] = counting.calls
    assert calls[1] == calls[32]


@pytest.mark.parametrize("backend", sorted(FAMILIES))
def test_fleet_equals_the_ports_solo_parsers(backend):
    patterns = [RX_SMALL, RX_MED, RX_LONG, RX_WIDE, "(a|b|ab)+", "x(yz|y)*z?"]
    cfgs = {f"t{i}": ParserConfig(regex=p, backend=backend, n_chunks=4)
            for i, p in enumerate(patterns)}
    fleet = _port_fleet(cfgs, max_batch=64)
    items = [(tid, t) for tid in cfgs
             for t in _rng_texts(len(tid), 5, [0, 3, 12, 40, 90], b"abxyz")]
    for (tid, text), got in zip(items, fleet.parse_batch(items)):
        want = Parser(cfgs[tid], device="cpu").parse(text)
        _assert_same(got, want)
        assert got.count_trees() == want.count_trees()


def _tenant_tables(T, n_classes, lp, seed):
    rng = np.random.default_rng(seed)
    N = (rng.random((T, n_classes, lp, lp)) < 3.0 / lp).astype(np.float32)
    N[:, -1] = np.eye(lp, dtype=np.float32)
    return torch.tensor(N), rng


@pytest.mark.parametrize("kernel", ["reach", "build_merge", "packed_reach", "sparse_reach"])
@pytest.mark.parametrize("T", [1, 3, 8])
def test_tenant_axis_plain_versions_equal_a_per_tenant_loop(kernel, T):
    """Each plain version over a tenant stack equals the same version run
    tenant by tenant on its own table."""
    lp, A1, Ct, k = 64, 5, 3, 9
    N, rng = _tenant_tables(T, A1, lp, T * 7 + len(kernel))
    ids = torch.tensor(rng.integers(0, A1, size=(T * Ct, k)), dtype=torch.int32)
    Np = pack_transition_table_torch(N)
    ef = torch.tensor((rng.random((T * Ct, lp)) < 0.3).astype(np.float32))
    eb = torch.tensor((rng.random((T * Ct, lp)) < 0.3).astype(np.float32))
    idx = torch.tensor(rng.integers(0, lp, size=(T * Ct, 8)))
    R0 = sparse_init_rows(idx, lp)
    fn, args, per = {
        "reach": (ref.reach_chunk_product_ref, (N, ids), lambda t, s: (N[t], ids[s])),
        "build_merge": (ref.build_merge_packed_ref, (N, ids, ef, eb),
                        lambda t, s: (N[t], ids[s], ef[s], eb[s])),
        "packed_reach": (ref.packed_reach_chunk_product_ref, (Np, ids),
                         lambda t, s: (Np[t], ids[s])),
        "sparse_reach": (ref.sparse_reach_rows_ref, (Np, ids, R0),
                         lambda t, s: (Np[t], ids[s], R0[s])),
    }[kernel]
    got = fn(*args)
    want = torch.cat([fn(*per(t, slice(t * Ct, (t + 1) * Ct))) for t in range(T)])
    assert torch.equal(got, want)


@pytest.mark.parametrize("pattern", [RX_SMALL, RX_MED, RX_LONG, RX_WIDE, "x(yz|y)*z?",
                                     "(a|b)*a(a|b){125}"])
@pytest.mark.parametrize("lane", [32, 128])
def test_compiled_tenant_tables_equal_the_references(pattern, lane):
    """``_compile_tables`` gives the reference's arrays, bit for bit, for the
    same pattern and lane pad: N, I, F, ℓp, classes, width bound."""
    from repro.core.matrices import build_matrices as ref_build
    from repro.core.segments import compute_segments as ref_segments

    got = _compile_tables(build_matrices(compute_segments(pattern)), lane)
    want = ref_fleet._compile_tables(ref_build(ref_segments(pattern)), lane)
    for name in ("N", "I", "F"):
        a, b = getattr(got, name), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    for name in ("ell", "ell_pad", "n_classes", "pad_class", "width_bound"):
        assert getattr(got, name) == getattr(want, name), name
