"""repro_torch's public API against repro's.

``Parser.parse`` / ``parse_batch`` results (``ok``, ``matches``,
``children``, ``trees``) equal ``repro.Parser``'s and the brute-force LST
oracle's; every served backend setting (``packed``, ``sparse``, their
``kernel=True`` paths and ``cuda`` with ``kernel=True``) parses as
``repro.Parser`` does; ``ParserConfig`` dicts round-trip between the
packages under the backend-name map; ``mesh="host"`` configs parse as the
reference's do; the package never imports JAX or ``repro``.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from oracle import enumerate_lsts  # noqa: E402
from test_torch_corpus import CORPUS, N_CHUNKS, artifacts, texts  # noqa: E402

import repro  # noqa: E402
from repro.core.numbering import number_regex  # noqa: E402
from repro_torch import ParseResult, Parser, ParserConfig, ParserEngine  # noqa: E402
from repro_torch.core.engine import make_parse_core  # noqa: E402

# backend names of the two packages (ROADMAP.md, "Layout")
TO_PORT = {"jnp": "torch", "pallas": "cuda", "packed": "packed", "sparse": "sparse",
           "auto": "auto"}
TO_REF = {v: k for k, v in TO_PORT.items()}
ORACLE_MAX_LEN = 6

_parsers: dict = {}


def _pair(key):
    if key not in _parsers:
        art, port, _ = artifacts(key)
        _parsers[key] = (
            repro.Parser.from_matrices(
                art.matrices, repro.ParserConfig(regex=f"<{key}>", n_chunks=N_CHUNKS)
            ),
            Parser.from_matrices(
                port, ParserConfig(regex=f"<{key}>", backend="torch", n_chunks=N_CHUNKS),
                device="cpu",
            ),
        )
    return _parsers[key]


def _tree_set(slpf):
    return {tuple(s for q in path for s in slpf.table.segs[q]) for path in slpf.iter_trees()}


def _assert_same_result(got: ParseResult, want, groups, text):
    assert got.ok == want.ok, text
    assert np.array_equal(got.forest.pack(), want.forest.pack()), text
    assert got.trees() == want.trees(), text
    assert got.trees(paths=True, limit=3) == want.trees(paths=True, limit=3), text
    assert got.count_trees() == want.count_trees(), text
    for g in groups:
        assert got.matches(g) == want.matches(g), (text, g)
        for span in want.matches(g, limit=3):
            assert got.children(span) == want.children(span), (text, span)


@pytest.mark.parametrize("key", CORPUS)
def test_parse_equals_reference_parser_and_oracle(key):
    ref, port = _pair(key)
    _, _, ast = artifacts(key)
    numbered = number_regex(ast if ast is not None else key)
    assert port.groups == ref.groups
    for text in texts(key):
        got, want = port.parse(text), ref.parse(text)
        _assert_same_result(got, want, ref.groups, text)
        assert got.backend == "torch" and got.bucket == want.bucket
        if len(text) <= ORACLE_MAX_LEN:
            oracle = {tuple(lst) for lst in enumerate_lsts(numbered, text)}
            assert _tree_set(got.forest) == oracle, text


@pytest.mark.parametrize("key", CORPUS)
def test_parse_batch_equals_reference_parser(key):
    ref, port = _pair(key)
    batch = texts(key)
    for got, want in zip(port.parse_batch(batch), ref.parse_batch(batch)):
        _assert_same_result(got, want, ref.groups, None)


def test_parser_from_pattern_and_empty_and_nonmatching_text():
    p = Parser(ParserConfig(regex="(a|b|ab)+", backend="torch", n_chunks=4), device="cpu")
    r = repro.Parser(repro.ParserConfig(regex="(a|b|ab)+", n_chunks=4))
    for text in ["", "abab", "abxab", "c"]:
        _assert_same_result(p.parse(text), r.parse(text), r.groups, text)
    assert not p.parse("").ok and not p.parse("c").ok
    assert p.backend_name == "torch" and p.compile_count >= 1
    assert p.table.n == r.table.n


def _ref_configs():
    return [
        repro.ParserConfig(regex="(ab|a)*"),
        repro.ParserConfig(regex="x+", backend="pallas", n_chunks=16, min_chunk_len=4,
                           max_batch=3, max_pending=9, weight=2.5, first_seal_len=16,
                           max_seal_len=64, cache_budget_bytes=1 << 20,
                           max_pending_chars=100, analyze="off"),
        repro.ParserConfig(regex="a|b", backend="packed", kernel=True, analyze="strict"),
        repro.ParserConfig(regex="a|b", backend="sparse", feasible_depth=3),
        repro.ParserConfig(regex="a|b", backend="auto", mesh="host",
                           mesh_rules={"chunk": ["pod"], "batch": "data"},
                           slo=repro.SLOTargets(p50_s=0.01, p99_s=0.1, default_deadline_s=1.0),
                           obs=repro.ObsConfig(enabled=True, max_spans=7)),
    ]


def _mapped(d, names):
    return {**d, "backend": names[d["backend"]]}


@pytest.mark.parametrize("i", range(5))
def test_config_dicts_round_trip_between_packages(i):
    ref_cfg = _ref_configs()[i]
    d = json.loads(json.dumps(ref_cfg.to_dict()))
    port_cfg = ParserConfig.from_dict(_mapped(d, TO_PORT))
    assert ParserConfig.from_dict(port_cfg.to_dict()) == port_cfg
    back = repro.ParserConfig.from_dict(_mapped(port_cfg.to_dict(), TO_REF))
    assert back == ref_cfg
    assert back.to_dict() == ref_cfg.to_dict()


def test_default_backends_map():
    assert ParserConfig(regex="a").backend == "cuda"
    assert TO_PORT[repro.ParserConfig(regex="a").backend] == "torch"


@pytest.mark.parametrize("bad", [
    {"regex": ""}, {"backend": "jnp"}, {"analyze": "loud"}, {"backend": "torch", "kernel": True},
    {"backend": "auto", "kernel": True}, {"feasible_depth": 0}, {"feasible_depth": 2},
    {"n_chunks": 0}, {"min_chunk_len": 6}, {"first_seal_len": 3}, {"max_seal_len": 5},
    {"max_batch": 0}, {"weight": 0}, {"max_pending": 0}, {"mesh": "pod"},
    {"mesh_rules": {"chunk": "pod"}}, {"mesh": "host", "mesh_rules": {"chunk": "x"}},
    {"slo": {"p50_s": -1.0}}, {"obs": {"max_spans": 0}},
])
def test_config_validation_matches_reference(bad):
    kw = {"regex": "a|b", **bad}
    with pytest.raises(ValueError):
        ParserConfig(**kw)
    ref_kw = dict(kw)
    if ref_kw.get("backend") in TO_REF:
        ref_kw["backend"] = TO_REF[ref_kw["backend"]]
    if bad == {"backend": "jnp"}:
        ref_kw["backend"] = "nope"
    with pytest.raises(ValueError):
        repro.ParserConfig(**ref_kw)
    with pytest.raises(ValueError):
        ParserConfig.from_dict({"regex": "a", "colour": 1})


SERVED = [
    {"backend": "packed"}, {"backend": "sparse"}, {"backend": "sparse", "feasible_depth": 2},
    {"backend": "packed", "kernel": True}, {"backend": "sparse", "kernel": True},
    {"backend": "cuda", "kernel": True},
]


def _parse_on_cpu_tensors(parser_cfg, matrices, text):
    """A kernel setting's parse with every phase on CPU tensors, where each
    kernel wrapper runs its plain version: the configured backend over the
    engine's tables, bucketing and assembly."""
    eng = ParserEngine(matrices, backend="torch", min_chunk_len=parser_cfg.min_chunk_len,
                       device="cpu")
    backend = parser_cfg.build_backend()
    backend.bind_tables(eng.tables)
    classes = eng.classes_of_text(text)
    chunks = eng.chunks_tensor(eng._pad_to(classes, *eng.bucket_shape(len(classes),
                                                                    parser_cfg.n_chunks)))
    t = eng.tables
    col0, cols = make_parse_core(backend)(t.N, t.I, t.F, chunks)
    return eng._assemble(col0.numpy(), cols.numpy(), classes)


@pytest.mark.parametrize("key", CORPUS)
@pytest.mark.parametrize("setting", SERVED)
def test_served_settings_equal_reference_parser(setting, key):
    """Each served setting parses as ``repro.Parser`` with the same setting:
    on the CPU where the backend allows it, else on the card when there is
    one, else with its phases on CPU tensors."""
    art, port_m, _ = artifacts(key)
    cfg = ParserConfig(regex=f"<{key}>", n_chunks=N_CHUNKS, **setting)
    ref_cfg = repro.ParserConfig.from_dict(_mapped(cfg.to_dict(), TO_REF))
    ref = repro.Parser.from_matrices(art.matrices, ref_cfg)
    if cfg.build_backend().needs_cuda:
        with pytest.raises(ValueError, match="runs only on the card"):
            Parser.from_matrices(port_m, cfg, device="cpu")
    if not cfg.build_backend().needs_cuda or torch.cuda.is_available():
        dev = "cpu" if not cfg.build_backend().needs_cuda else "cuda"
        port = Parser.from_matrices(port_m, cfg, device=dev)
        assert port.backend_name == TO_PORT[ref.backend_name]
        for text in texts(key):
            got, want = port.parse(text), ref.parse(text)
            _assert_same_result(got, want, ref.groups, text)
            assert got.speculation == want.speculation, text
    else:
        for text in texts(key):
            got = _parse_on_cpu_tensors(cfg, port_m, text)
            assert np.array_equal(got.pack(), ref.parse(text).forest.pack()), text


@pytest.mark.parametrize("setting", [
    {"mesh": "host"}, {"mesh": "host", "backend": "auto"}, {"mesh": "host", "analyze": "strict"},
])
def test_unported_settings_raise_not_implemented(setting):
    """The settings once refused as unported (``mesh``, with or without
    ``backend="auto"`` / ``analyze="strict"``) are served: on the 1-rank
    mesh every result equals the reference ``Parser``'s on its 1-device
    mesh (the default backend maps ``jnp`` ↔ ``torch`` here on the CPU)."""
    port_setting = {"backend": "torch", **setting}
    port = Parser(ParserConfig(regex="(a|b|ab)+", n_chunks=N_CHUNKS, **port_setting),
                  device="cpu")
    ref = repro.Parser(repro.ParserConfig(regex="(a|b|ab)+", n_chunks=N_CHUNKS, **setting))
    assert port.engine.mesh.shape == dict(ref.engine.mesh.shape) == {"pod": 1, "data": 1}
    assert port.backend_name == TO_PORT[ref.backend_name]
    texts = ["", "ab", "abab", "aab", "ab" * 9, "abx"]
    for text in texts:
        _assert_same_result(port.parse(text), ref.parse(text), ref.groups, text)
    for text, got, want in zip(texts, port.parse_batch(texts), ref.parse_batch(texts)):
        _assert_same_result(got, want, ref.groups, text)


def test_ported_settings_are_accepted():
    for cfg in (ParserConfig(regex="a|b", backend="torch", analyze="warn"),
                ParserConfig(regex="a|b", backend="torch", analyze="off",
                             obs={"enabled": False}),
                ParserConfig(regex="a|b", backend="torch", slo={"p99_s": 0.1}),
                ParserConfig(regex="a|b", backend="torch", obs={"enabled": True})):
        assert Parser(cfg, device="cpu").parse("a").ok


def test_cuda_backend_refused_on_cpu_and_device_none_needs_the_card():
    with pytest.raises(ValueError, match="runs only on the card"):
        Parser(ParserConfig(regex="a|b"), device="cpu")
    if torch.cuda.is_available():
        pytest.skip("the rest checks the behaviour without a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Parser("a|b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ParserEngine(artifacts("(ab|a)*")[1], backend="torch", device=None)


def test_port_imports_neither_jax_nor_repro():
    src = Path(__file__).resolve().parents[1] / "src"
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(src)!r})\n"
        "import repro_torch, torch\n"
        "import repro_torch.serve.engine, repro_torch.serve.scheduler\n"
        "import repro_torch.core.serial, repro_torch.core.reference, repro_torch.core.stream\n"
        "import repro_torch.core.fleet, repro_torch.analyze\n"
        "import repro_torch.core.distributed, repro_torch.launch.mesh\n"
        "import repro_torch.parallel.sharding\n"
        "from repro_torch.configs import get_smoke\n"
        "from repro_torch.models import model as m\n"
        "cfg = get_smoke('zamba2-2.7b')\n"
        "m.prefill(m.init_params(cfg, device='cpu'), torch.zeros((1, 8), dtype=torch.long), cfg)\n"
        "p = repro_torch.Parser(repro_torch.ParserConfig(regex='(a|b|ab)+', "
        "backend='torch', n_chunks=4), device='cpu')\n"
        "assert p.parse('abab').ok\n"
        "pm = repro_torch.Parser(repro_torch.ParserConfig(regex='(a|b|ab)+', "
        "backend='torch', mesh='host', n_chunks=4), device='cpu')\n"
        "assert pm.parse('abab').ok and pm.engine.dist.chunk_axes == ('pod', 'data')\n"
        "f = repro_torch.ParserFleet({'t': repro_torch.ParserConfig(regex='(a|b)*abb', "
        "backend='auto')}, device='cpu')\n"
        "assert f.parse('t', 'ababb').ok\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
