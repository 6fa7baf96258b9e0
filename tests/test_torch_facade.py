"""repro_torch's package surface against repro's.

Every name of ``repro.__all__`` that the port has ported is exported by
``repro_torch`` and is the port's own object (the unported ones, none now,
would be absent).
``ParseResult.slpf``, ``Parser.count_accepting`` and the context-manager
protocol (``close`` / ``__enter__`` / ``__exit__``) behave as the
reference's, and the five typed errors keep its class hierarchy.
"""

import inspect

import pytest

torch = pytest.importorskip("torch")

from test_torch_corpus import CORPUS, N_CHUNKS, artifacts, texts  # noqa: E402

import repro  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch import Parser, ParserConfig  # noqa: E402

# the reference's exports whose modules are not ported yet: none since the
# fleet and the analyzer (ROADMAP Queue 1 items 9 and 10)
UNPORTED: set = set()
ERRORS = ["ParseError", "AdmissionError", "SessionNotFound", "BudgetExceeded",
          "PathologicalPatternError"]


def _module_of(obj) -> str:
    return obj.__name__ if inspect.ismodule(obj) else obj.__module__


@pytest.mark.parametrize("name", sorted(repro.__all__))
def test_reference_exports_are_the_ports_own(name):
    if name in UNPORTED:
        assert name not in repro_torch.__all__
        assert not hasattr(repro_torch, name)
        return
    assert name in repro_torch.__all__
    assert _module_of(getattr(repro_torch, name)).startswith("repro_torch")


def test_port_exports_resolve():
    for name in repro_torch.__all__:
        assert _module_of(getattr(repro_torch, name)).startswith("repro_torch"), name


def test_parse_result_slpf_is_the_forest():
    r = Parser(ParserConfig(regex="(a|b|ab)+", backend="torch"), device="cpu").parse(b"abab")
    assert r.slpf is r.forest
    assert isinstance(repro_torch.ParseResult.slpf, property)


_pairs: dict = {}


@pytest.mark.parametrize("key", CORPUS)
def test_count_accepting_equals_reference(key):
    if key not in _pairs:
        art, port, _ = artifacts(key)
        _pairs[key] = (
            repro.Parser.from_matrices(
                art.matrices, repro.ParserConfig(regex=f"<{key}>", n_chunks=N_CHUNKS)
            ),
            Parser.from_matrices(
                port, ParserConfig(regex=f"<{key}>", backend="torch", n_chunks=N_CHUNKS),
                device="cpu",
            ),
        )
    ref, port = _pairs[key]
    for text in texts(key):
        assert port.count_accepting(text) == ref.count_accepting(text), text


def test_parser_is_a_context_manager():
    cfg = ParserConfig(regex="(ab|a)*", backend="torch")
    with Parser(cfg, device="cpu") as p:
        assert isinstance(p, Parser)
        r = p.parse(b"aba")
        assert r.ok and r.count_trees() == 1
    p.close()                                     # closing twice is harmless
    with repro.Parser(repro.ParserConfig(regex="(ab|a)*")) as ref:
        assert ref.parse(b"aba").count_trees() == r.count_trees()


@pytest.mark.parametrize("name", ERRORS)
def test_errors_keep_the_reference_hierarchy(name):
    port_cls, ref_cls = getattr(repro_torch, name), getattr(repro, name)
    assert port_cls is getattr(repro_torch.errors, name)
    assert [c.__name__ for c in port_cls.__mro__] == [c.__name__ for c in ref_cls.__mro__]
    for base in (repro_torch.ParseError, KeyError, ValueError):
        ref_base = getattr(repro, base.__name__, base)
        assert issubclass(port_cls, base) == issubclass(ref_cls, ref_base)
    assert inspect.signature(port_cls.__init__) == inspect.signature(ref_cls.__init__)
