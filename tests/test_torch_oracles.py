"""repro_torch's paper oracles (``core/serial.py``, ``core/reference.py``)
against repro's, on the shared corpus.

The serial matrix and DFA parsers, the recognizer, the paper-faithful
parallel parser (plain and with the fused builder&merger, several chunk
counts) and the parallel recognizer must give the reference's SLPFs
(``SLPF.pack()``) and verdicts on ``tests/test_torch_corpus.py``'s patterns
and texts; the generated machines must have the reference's sizes, and
``Parser.artifacts`` must be them.  numpy only: no tolerance.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_corpus import CORPUS, artifacts, texts  # noqa: E402

from repro.core import reference as ref_reference  # noqa: E402
from repro.core import serial as ref_serial  # noqa: E402
from repro_torch import Parser, ParserConfig  # noqa: E402
from repro_torch.core import reference as port_reference  # noqa: E402
from repro_torch.core import serial as port_serial  # noqa: E402

_arts: dict = {}


def port_artifacts(key):
    if key not in _arts:
        _arts[key] = port_reference.ParallelArtifacts.generate(artifacts(key)[1].table)
    return _arts[key]


def _machine_sizes(art):
    return {name: (len(getattr(art, name).states), sum(getattr(art, name).final))
            for name in ("dfa", "medfa", "rdfa", "rmedfa")}


@pytest.mark.parametrize("key", CORPUS)
def test_serial_parsers_and_recognizer_equal_reference(key):
    ref_art, port_m, _ = artifacts(key)
    art = port_artifacts(key)
    for text in texts(key):
        want = ref_serial.parse_serial_matrix(ref_art.matrices, text)
        got = port_serial.parse_serial_matrix(port_m, text)
        assert np.array_equal(got.pack(), want.pack()), text
        got_dfa = port_serial.parse_serial_dfa(port_m, text, art.dfa, art.rdfa, art.nfa)
        assert np.array_equal(got_dfa.pack(), want.pack()), text
        assert port_serial.recognize(port_m, text, art.dfa) == \
            ref_serial.recognize(ref_art.matrices, text, ref_art.dfa) == want.accepted


@pytest.mark.parametrize("key", CORPUS)
@pytest.mark.parametrize("c", [1, 3])
def test_parallel_reference_equals_reference(key, c):
    ref_art, _, _ = artifacts(key)
    art = port_artifacts(key)
    assert _machine_sizes(art) == _machine_sizes(ref_art)
    for text in texts(key):
        want = ref_reference.parse_parallel_reference(ref_art, text, c=c)
        for fused in (False, True):
            got = port_reference.parse_parallel_reference(art, text, c=c, fused=fused)
            assert np.array_equal(got.pack(), want.pack()), (text, fused)
        assert port_reference.recognize_parallel(art, text, c=c) == \
            ref_reference.recognize_parallel(ref_art, text, c=c)


def test_serial_parser_bundle_and_split_chunks():
    for pattern, text in (("(a|b|ab)+", "abab"), ("x(yz|y)*z?", "xyzyz"), ("(ab|a)*", "aab")):
        got, want = port_serial.SerialParser(pattern), ref_serial.SerialParser(pattern)
        for method in ("dfa", "matrix"):
            assert np.array_equal(got.parse(text, method=method).pack(),
                                  want.parse(text, method=method).pack())
        assert got.accepts(text) == want.accepts(text) is True
        assert got.accepts(text + "~") == want.accepts(text + "~") is False
    classes = np.arange(11, dtype=np.int32)
    for c in (1, 2, 4, 11, 20):
        assert [x.tolist() for x in port_reference.split_chunks(classes, c)] == \
            [x.tolist() for x in ref_reference.split_chunks(classes, c)]


@pytest.mark.parametrize("key", CORPUS[:3])
def test_parser_artifacts_are_the_oracle_machines(key):
    ref_art, _, _ = artifacts(key)
    p = Parser(ParserConfig(regex=key, backend="torch", n_chunks=4), device="cpu")
    art = p.artifacts
    assert art is p.artifacts                       # built once
    assert isinstance(art, port_reference.ParallelArtifacts)
    assert _machine_sizes(art) == _machine_sizes(ref_art)
    for text in texts(key):
        want = p.parse(text).forest
        got = port_reference.parse_parallel_reference(art, text, c=4)
        assert np.array_equal(got.pack(), want.pack()), text
