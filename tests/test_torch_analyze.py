"""repro_torch.analyze against repro.analyze, and the facade's analysis policy.

Mirrors ``tests/test_analyze.py`` on the port:

  * pattern leg: every ``AnalysisReport`` field but ``cost`` and
    ``recommended_backend`` equals the reference's on the pathological,
    finitely ambiguous and unambiguous fixtures and the REgen corpus; the
    recommendation's family equals the reference's wherever the card's
    constants keep the ranking (the cases where they do not are listed);
    the static width bounds hold over what the sparse backend observes; the
    lane-pad mirror tracks the port's backends; cost and density sanity;
  * facade policy: ``analyze="off" | "warn" | "strict"`` at ``Parser``
    construction and ``ParserFleet.add``, the services' pattern guard,
    ``stats()["analysis"]`` and the analyzer's counters;
  * ``backend="auto"``: parses bit-identically to the backend it resolves
    to, solo and in a fleet, and resolves to the kernel paths on the card;
  * program leg: the ``torch``, ``packed`` and ``sparse`` phase programs
    lint clean, and a seeded f64 cast, a seeded ``.item()`` and a chunk
    length outside the bucket set are caught.

Left out: the reference's HLO cases (``lint_hlo_text``, the roofline
re-export of ``repro.launch``, ``scripts/bench_trend.py``), which wait for
the port's launch tools, and ``enable_x64`` (its f64 test seeds the cast
through a wrapper backend instead).
"""

import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro  # noqa: E402
from repro.analyze import analyze_matrices as ref_analyze_matrices  # noqa: E402
from repro.analyze import analyze_pattern as ref_analyze_pattern  # noqa: E402
from repro.core.matrices import build_matrices as ref_build_matrices  # noqa: E402
from repro.core.numbering import number_regex as ref_number_regex  # noqa: E402
from repro.core.segments import compute_segments as ref_compute_segments  # noqa: E402
from repro.data.regen import random_regex, sample_string  # noqa: E402
from test_torch_corpus import to_port_ast  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch import Parser, ParserConfig, ParserFleet  # noqa: E402
from repro_torch.analyze import (  # noqa: E402
    AnalysisReport,
    analyze_matrices,
    analyze_pattern,
    backend_cost_model,
    choose_backend,
    feasible_width_bounds,
    lint_engine,
    lint_program,
    resolve_backend,
    sparse_width_bucket,
)
from repro_torch.analyze import roofline  # noqa: E402
from repro_torch.analyze.pattern import _MIN_LANE_PAD  # noqa: E402
from repro_torch.core.backend import (  # noqa: E402
    _BACKENDS,
    PackedBackend,
    SparseBackend,
    TorchBackend,
    get_backend,
)
from repro_torch.core.engine import ParserEngine  # noqa: E402
from repro_torch.core.matrices import build_matrices, feasible_start_widths  # noqa: E402
from repro_torch.core.numbering import number_regex  # noqa: E402
from repro_torch.core.segments import compute_segments  # noqa: E402
from repro_torch.errors import ParseError, PathologicalPatternError  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tests run many small tensor ops; under a parallel test run the
    intra-op thread pool of every worker competes for the same cores and
    makes each op wait, so this module runs them on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


PATHOLOGICAL = ["(a*)*", "(a?)+", "(a*)+", "((a|b)*)*"]
FINITE = ["a|a", "(a|b|ab)+", "(ab|ba|abba)+", "x(yz|y)*z?"]
UNAMBIGUOUS = ["abc", "a*b", "(ab|a)*", "(a|b)*abb"]
WIDTH_SEEDS = [11, 23, 47, 101]
# the chip's parse cells and the reference benchmark's fleet patterns
CHIP = [r"((GET|POST|PUT) /([a-z0-9]|/)* ([0-9]{3}) (ok|err|-)\n)+", "(a|b)*a(a|b){125}"]
E_PATTERNS = [f"(a|b)*a(a|b){{{k}}}" for k in range(1, 9)]
# the analyzer's family names in the two packages
TO_REF = {"torch": "jnp", "packed": "packed", "sparse": "sparse"}
# patterns whose recommendation the card's constants move off the
# reference's: none of the fixtures, the REgen seeds or the chip's patterns
RANKING_CHANGED: set = set()


def _seed_matrices(seed):
    """(port matrices, reference matrices) of a REgen pattern."""
    ast = random_regex(7, np.random.Generator(np.random.Philox(seed)))
    port = build_matrices(compute_segments(number_regex(to_port_ast(ast))))
    ref = ref_build_matrices(ref_compute_segments(ref_number_regex(ast)))
    return port, ref, ast


def _assert_report_equal(got: AnalysisReport, want):
    a, b = got.to_dict(), want.to_dict()
    assert set(a) == set(b)
    for key in a:
        if key not in ("cost", "recommended_backend"):
            assert a[key] == b[key], key
    assert set(a["cost"]) == {"torch", "cuda", "packed", "sparse"}


# ------------------------------------------------------------ pattern leg


@pytest.mark.parametrize("pattern", PATHOLOGICAL)
def test_pathological_fixtures(pattern):
    r = analyze_pattern(pattern)
    assert r.ambiguity == "pathological" and r.verdict == "pathological"
    _assert_report_equal(r, ref_analyze_pattern(pattern))


@pytest.mark.parametrize("pattern", FINITE)
def test_finitely_ambiguous_fixtures(pattern):
    r = analyze_pattern(pattern)
    assert r.ambiguity == "finite" and r.verdict == "ok"
    _assert_report_equal(r, ref_analyze_pattern(pattern))


@pytest.mark.parametrize("pattern", UNAMBIGUOUS)
def test_unambiguous_fixtures(pattern):
    r = analyze_pattern(pattern)
    assert r.ambiguity == "unambiguous" and r.ambiguity_exact and r.verdict == "ok"
    _assert_report_equal(r, ref_analyze_pattern(pattern))


def test_regen_corpus_analyzes():
    """Every REgen pattern gets the reference's report, internally
    consistent."""
    for seed in WIDTH_SEEDS:
        port, ref, _ = _seed_matrices(seed)
        r = analyze_matrices(port)
        _assert_report_equal(r, ref_analyze_matrices(ref))
        assert r.recommended_backend in ("torch", "packed", "sparse")
        assert len(r.width_bounds) >= 1 and r.width_bounds[0] <= r.ell_pad
        assert all(a >= b for a, b in zip(r.width_bounds, r.width_bounds[1:]))


@pytest.mark.parametrize("pattern", PATHOLOGICAL + FINITE + UNAMBIGUOUS + CHIP + E_PATTERNS
                         + [f"seed:{s}" for s in WIDTH_SEEDS])
def test_recommendation_family_equals_the_references(pattern):
    """The card's constants (H100: 989 TFLOP/s bf16, 3.35 TB/s, 16.7 T word
    ops/s) keep the reference's ranking on every pattern here; a pattern
    where they do not would be listed in RANKING_CHANGED."""
    if pattern.startswith("seed:"):
        port, ref, _ = _seed_matrices(int(pattern[5:]))
        got, want = analyze_matrices(port), ref_analyze_matrices(ref)
    else:
        got, want = analyze_pattern(pattern), ref_analyze_pattern(pattern)
    same = TO_REF[got.recommended_backend] == want.recommended_backend
    assert same == (pattern not in RANKING_CHANGED), (got.recommended_backend,
                                                      want.recommended_backend)


def test_report_schema_round_trips():
    import json

    d = analyze_pattern("(a|b|ab)+").to_dict()
    json.dumps(d)
    for key in ("pattern", "ell", "ell_pad", "n_classes", "nullable", "ambiguity",
                "ambiguity_exact", "width_bounds", "width_exact", "width_bucket",
                "density", "cost", "recommended_backend", "verdict"):
        assert key in d, key
    assert set(d["cost"]) == {"torch", "cuda", "packed", "sparse"}


def _corpus_text(ast_or_pattern, rng, n_chars):
    """A text of exactly n_chars from the pattern's language samples."""
    from repro.core import regex as rx

    node = rx.parse_regex(ast_or_pattern) if isinstance(ast_or_pattern, str) else ast_or_pattern
    text = b""
    for _ in range(64):
        text += sample_string(node, rng, max_rep=3) or b"a"
        if len(text) >= n_chars:
            break
    return (text + b"a" * n_chars)[:n_chars]


@pytest.mark.parametrize("key", UNAMBIGUOUS + FINITE + [f"seed:{s}" for s in WIDTH_SEEDS])
@pytest.mark.parametrize("depth", [1, 2])
def test_static_width_bound_vs_observed(key, depth):
    """Static bound ≥ every observed speculation width of the port's sparse
    parser, whose carried rows are the bucket of the depth-1 bound."""
    rng = np.random.Generator(np.random.Philox(abs(hash(key)) % 2**31))
    cfg = ParserConfig(regex="<prebuilt>", backend="sparse", feasible_depth=depth,
                       n_chunks=4, analyze="off")
    if key.startswith("seed:"):
        m, _, src = _seed_matrices(int(key[5:]))
        report = analyze_matrices(m, depth=depth)
    else:
        m, src = build_matrices(compute_segments(key)), key
        report = analyze_pattern(key, depth=depth)
    p = Parser.from_matrices(m, cfg, device="cpu")
    n = 4 * p.engine.bucket_shape(4 * cfg.min_chunk_len, 4)[1]
    observed = []
    for _ in range(6):
        spec = p.parse(_corpus_text(src, rng, n)).speculation
        assert spec is not None and spec["depth"] == depth
        observed.append(spec["width_max"])
    assert max(observed) <= report.width_bounds[depth - 1]
    carried = int(p.engine.backend._width)
    assert carried == sparse_width_bucket(report.width_bounds[0], report.ell_pad)
    if carried < report.ell_pad:
        assert carried < 2 * max(report.width_bounds[0], 8)


def test_width_bounds_match_runtime_fold():
    m = build_matrices(compute_segments("(a|b|ab)+"))
    N = np.asarray(m.N)
    bounds, exact = feasible_width_bounds(N, 1)
    assert exact
    widths = [int(feasible_start_widths(N, np.array([[a]]), depth=1)[0])
              for a in range(N.shape[0] - 1)]
    assert bounds[0] == max(widths)


def test_min_lane_pad_mirror_matches_backends():
    for name, lane in _MIN_LANE_PAD.items():
        assert get_backend(name).min_lane_pad == lane, name
    assert set(_MIN_LANE_PAD) == set(_BACKENDS)


def test_cost_model_prefers_reduction():
    cost = backend_cost_model(40, width_bucket_32=4)
    assert choose_backend(cost, reduced=True) == "sparse"
    assert choose_backend(cost, reduced=False) in ("packed", "torch")
    for ell in (8, 40, 200, 1000):
        for w in (2, 16, 200):
            c = backend_cost_model(ell, w)
            assert choose_backend(c, reduced=True) != "cuda"
            for name in ("torch", "cuda", "packed", "sparse"):
                assert c[name]["t_total"] > 0


def test_card_constants():
    """The H100 SXM's published figures, as PERF.md uses them."""
    assert roofline.PEAK_FLOPS == 989e12 and roofline.HBM_BW == 3.35e12
    assert roofline.INT8_OPS == 1979e12 and roofline.NVLINK_BW == 450e9
    r = roofline.Roofline("a", "s", "m", 1, hlo_flops=989e12, hlo_bytes=0.0, coll_bytes=0.0,
                          model_flops=989e12)
    assert r.t_compute == 1.0 and r.bottleneck == "compute" and r.roofline_fraction == 1.0


def test_density_profile_bounds():
    d = analyze_pattern("(a|b|ab)+").density
    assert 0.0 < d["class_mean"] <= d["class_max"] <= 1.0
    assert d["union"] <= d["saturation"] <= 1.0


# -------------------------------------------------------- facade policy


def test_strict_rejects_pathological_at_construction():
    with pytest.raises(PathologicalPatternError) as ei:
        Parser(ParserConfig(regex="(a*)*", backend="torch", analyze="strict"), device="cpu")
    err = ei.value
    assert err.pattern == "(a*)*" and err.ambiguity == "pathological"
    assert isinstance(err, ValueError) and isinstance(err, ParseError)


def test_warn_mode_warns_and_serves():
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        p = Parser(ParserConfig(regex="(a?)+", backend="torch"), device="cpu")
    assert any(issubclass(w.category, UserWarning) and "pathologically" in str(w.message)
               for w in caught)
    assert p.parse("aa").ok


def test_off_mode_skips_construction_analysis():
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        p = Parser(ParserConfig(regex="(a*)*", backend="torch", analyze="off"), device="cpu")
    assert not any(issubclass(w.category, UserWarning) for w in caught)
    assert p._analysis is None
    assert p.stats()["analysis"]["verdict"] == "pathological"      # lazily


def test_analyze_knob_validated():
    with pytest.raises(ValueError, match="analyze"):
        ParserConfig(regex="ab", analyze="loud")


def test_config_round_trips_new_fields():
    cfg = ParserConfig(regex="(a|b)+", backend="auto", analyze="strict")
    assert ParserConfig.from_dict(cfg.to_dict()) == cfg


def test_fleet_strict_rejects_and_keeps_serving():
    fleet = ParserFleet({"good": ParserConfig(regex="(a|b|ab)+", backend="torch")},
                        device="cpu")
    with pytest.raises(PathologicalPatternError):
        fleet.add("bad", ParserConfig(regex="(a*)*", backend="torch", analyze="strict"))
    assert sorted(fleet.tenants) == ["good"]
    assert fleet.parse("good", "ab").ok


def test_service_pattern_guard_blocks_admission():
    p = Parser(ParserConfig(regex="(a|b|ab)+", backend="torch", analyze="warn"), device="cpu")
    svc = p.parse_service
    svc.set_pattern_guard("pathological", "strict")
    with pytest.raises(PathologicalPatternError):
        p.parse("ab")
    svc.set_pattern_guard("pathological", "warn")
    assert p.parse("ab").ok
    ss = p.stream_service
    ss.set_pattern_guard("pathological", "strict")
    sid = ss.open()
    with pytest.raises(PathologicalPatternError):
        ss.append(sid, "ab")


def test_services_hold_the_construction_verdict():
    """A pathological pattern admitted under ``warn`` carries its verdict
    onto both services (the reference passes the report's verdict too)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        p = Parser(ParserConfig(regex="(a?)+", backend="torch"), device="cpu")
    assert p.parse_service._pattern_guard == ("pathological", "warn")
    assert p.stream_service._pattern_guard == ("pathological", "warn")
    off = Parser(ParserConfig(regex="(a?)+", backend="torch", analyze="off"), device="cpu")
    assert off.parse_service._pattern_guard == ("ok", "off")


def test_analysis_report_on_parser_and_metrics():
    p = Parser(ParserConfig(regex="(a|b|ab)+", backend="torch"), device="cpu")
    r = repro.Parser(repro.ParserConfig(regex="(a|b|ab)+"))
    assert isinstance(p.analysis, AnalysisReport)
    s = p.stats()
    assert s["analysis"]["verdict"] == "ok"
    _assert_report_equal(p.analysis, r.analysis)
    from repro_torch.obs import validate_metric_names

    snap = s["metrics"]
    validate_metric_names(snap)
    flat = {str(k): v for k, v in snap.items()}
    assert flat["analyzer_verdicts_total"][0]["labels"]["verdict"] == "ok"


# ------------------------------------------------------- backend="auto"


def test_auto_backend_bit_identical():
    rng = np.random.Generator(np.random.Philox(7))
    for pattern in UNAMBIGUOUS + FINITE:
        auto = Parser(ParserConfig(regex=pattern, backend="auto", n_chunks=4, analyze="off"),
                      device="cpu")
        ref = repro.Parser(repro.ParserConfig(regex=pattern, backend="auto", n_chunks=4,
                                              analyze="off"))
        chosen = auto.backend_name
        assert chosen in repro_torch.list_backends()
        assert TO_REF[chosen] == ref.backend_name
        explicit = Parser(ParserConfig(regex=pattern, backend=chosen, n_chunks=4, analyze="off"),
                          device="cpu")
        for _ in range(4):
            text = _corpus_text(pattern, rng, int(rng.integers(1, 24)))
            fa, fe = auto.parse(text).forest, explicit.parse(text).forest
            assert np.array_equal(fa.columns, fe.columns)
            assert np.array_equal(fa.classes, fe.classes)
            assert fa.count_trees() == fe.count_trees()
            assert np.array_equal(fa.pack(), ref.parse(text).forest.pack())


def test_auto_backend_in_fleet_bit_identical():
    fleet = ParserFleet({"auto": ParserConfig(regex="(a|b|ab)+", backend="auto")}, device="cpu")
    resolved = fleet.stats()["tenants"]["auto"]["backend"]
    assert resolved in repro_torch.list_backends()
    fleet.add("explicit", ParserConfig(regex="(a|b|ab)+", backend=resolved))
    for text in ("abab", "ba", "abba" * 3):
        ra, re_ = fleet.parse("auto", text), fleet.parse("explicit", text)
        assert ra.backend == resolved
        assert np.array_equal(ra.forest.columns, re_.forest.columns)


def test_auto_validation_rules():
    with pytest.raises(ValueError, match="kernel"):
        ParserConfig(regex="ab", backend="auto", kernel=True)
    ParserConfig(regex="ab", backend="auto", feasible_depth=2)
    with pytest.raises(ValueError, match="auto"):
        ParserConfig(regex="ab", backend="auto").build_backend()


@pytest.mark.parametrize("choice,device,want", [
    ("torch", "cuda", ("cuda", False)), ("packed", "cuda", ("packed", True)),
    ("sparse", "cuda", ("sparse", True)), ("torch", "cpu", ("torch", False)),
    ("packed", "cpu", ("packed", False)), ("sparse", "cpu", ("sparse", False)),
])
def test_auto_resolves_to_the_kernel_paths_on_the_card(choice, device, want):
    """On the card auto never picks the kernel-free word loop."""
    assert resolve_backend(choice, device) == want
    with pytest.raises(ValueError):
        resolve_backend("cuda", device)


# ---------------------------------------------------------- program leg


@pytest.mark.parametrize("backend", ["torch", "packed", "sparse"])
def test_phase_programs_lint_clean(backend):
    p = Parser(ParserConfig(regex="(a|b|ab)+", backend=backend, analyze="off"), device="cpu")
    assert lint_engine(p.engine, buckets=((4, 32), (8, 8)), label=backend) == []


class _F64Reach(TorchBackend):
    """A wrapper backend whose reach runs in float64."""

    def reach(self, N, chunks):
        return super().reach(N.to(torch.float64), chunks).to(torch.float32)


class _ItemBuild(PackedBackend):
    """A wrapper backend whose build&merge reads a value back to the host."""

    def build_merge_packed(self, N, chunks, Jf, Jb):
        if int(Jf.sum()) < 0:
            raise AssertionError
        return super().build_merge_packed(N, chunks, Jf, Jb)


def _engine(backend):
    return ParserEngine(build_matrices(compute_segments("(a|b|ab)+")), backend=backend,
                        device="cpu")


def test_lint_catches_seeded_f64():
    findings = lint_engine(_engine(_F64Reach()), buckets=((4, 32),), label="t")
    assert {f.rule for f in findings} == {"f64"}
    assert {f.program for f in findings} == {"t:reach@4x32"}
    direct = lint_program(lambda x: x.to(torch.float64) * 2.0, (torch.ones(4, 4),), "t:f64")
    assert "f64" in {f.rule for f in direct} and all(f.program == "t:f64" for f in direct)


def test_lint_catches_seeded_item():
    findings = lint_engine(_engine(_ItemBuild()), buckets=((4, 32),), label="t")
    assert {(f.rule, f.program) for f in findings} == {("host-sync", "t:build_merge@4x32")}
    direct = lint_program(lambda x: x.sum().item(), (torch.ones(4),), "t:item")
    assert [f.rule for f in direct] == ["host-sync"]


def test_lint_catches_a_chunk_length_outside_the_buckets():
    findings = lint_engine(_engine(SparseBackend()), buckets=((4, 12),), label="s")
    assert {f.rule for f in findings} == {"dynamic-shape"}
    assert len(findings) == 3                                  # one a phase


def test_lint_finding_fields():
    f = lint_program(lambda x: x.double(), (torch.ones(2),), "p")[0]
    assert dataclasses.asdict(f).keys() == {"rule", "program", "detail"}
    assert str(f).startswith("[f64] p:")
