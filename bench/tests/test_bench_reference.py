"""The benchmark's reference against the program's ``torch`` backend on the CPU.

    python -m pytest -q bench/tests

The reference (``bench/reference``) must give the program's forest bit for bit
on valid and corrupted texts of both configurations' patterns, at every chunk
length, and on a stream's prefix after each piece; its transfer matrices must
give a concatenation's verdict.
"""

import json

import _paths  # noqa: F401
import pytest
import torch

from bench import harness, textgen
from bench.reference import forest as ref

PATTERNS = {name: json.loads((harness.BENCH / "configs" / f"{name}.json").read_text())
           for name in ("traffic", "e125")}
CPU = torch.device("cpu")


def program(config, **kw):
    from repro_torch import Parser, ParserConfig

    return Parser(ParserConfig(regex=config["pattern"], backend="torch", n_chunks=4, **kw), device="cpu")


def corrupt(text: bytes, at: int) -> bytes:
    return text[:at] + b"~" + text[at + 1:]


@pytest.mark.parametrize("name", sorted(PATTERNS))
@pytest.mark.parametrize("seed", [1, 2**33 + 5])
@pytest.mark.parametrize("kind", ["valid", "corrupted", "cut"])
def test_forest_equals_program(name, seed, kind):
    cfg = PATTERNS[name]
    text = textgen.texts(cfg["text"], 700, 1, seed, purpose=1)[0]
    if kind == "corrupted":
        text = corrupt(text, 350)
    elif kind == "cut":
        text = text[:333]                      # a prefix: valid or not, as it falls
    got = program(cfg).parse(text)
    aut = ref.automaton(cfg["pattern"])
    for chunk in (1, 5, 64, 1024):
        want = ref.forest(aut, text, CPU, chunk=chunk)
        assert ref.differing_bits(got.forest.columns, want) == 0
        assert ref.accepted(want) == got.ok
    assert got.ok == (kind == "valid") or kind == "cut"


@pytest.mark.parametrize("text", [b"", b"a", b"ab", b"ba", b"abab"])
def test_forest_small_texts(text):
    cfg = {"pattern": "(a|b|ab)+"}
    got = program(cfg).parse(text)
    want = ref.forest(ref.automaton(cfg["pattern"]), text, CPU, chunk=2)
    assert ref.differing_bits(got.forest.columns, want) == 0


@pytest.mark.parametrize("name", sorted(PATTERNS))
def test_stream_prefixes_equal_whole_text(name):
    """A stream's prefix after every piece: the program's forest and verdict
    equal the reference's on the whole concatenated text, and the pieces'
    transfer matrices give the same verdict."""
    cfg = PATTERNS[name]
    pieces = textgen.texts(cfg["text"], 512, 3, 7, purpose=2)
    pieces.append(corrupt(pieces[0], 200))
    aut = ref.automaton(cfg["pattern"])
    transfers = ref.piece_transfers(aut, pieces, CPU, chunk=64)
    p = program(cfg, first_seal_len=512, max_seal_len=512)
    with p.open_stream() as s:
        for i, piece in enumerate(pieces):
            s.append(piece)
            whole = b"".join(pieces[:i + 1])
            want = ref.forest(aut, whole, CPU, chunk=128)
            assert ref.differing_bits(s.result().forest.columns, want) == 0
            assert s.accepted == ref.accepted(want) == ref.accepted_through(aut, transfers[:i + 1])


def test_control_breaks_the_forest():
    """The control (forward columns alone) differs from the clean forest on
    every configuration's valid text, and keeps its verdict."""
    for cfg in PATTERNS.values():
        aut = ref.automaton(cfg["pattern"])
        text = textgen.texts(cfg["text"], 700, 1, 3, purpose=1)[0]
        clean = ref.forest(aut, text, CPU)
        control = ref.forest(aut, text, CPU, clean=False)
        assert ref.differing_bits(control.numpy(), clean) > 0
        assert ref.accepted(control) == ref.accepted(clean)


@pytest.mark.cuda
def test_forest_on_the_card_equals_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    for cfg in PATTERNS.values():
        aut = ref.automaton(cfg["pattern"])
        text = textgen.texts(cfg["text"], 5000, 1, 11, purpose=1)[0]
        want = ref.forest(aut, text, CPU, chunk=256)
        got = ref.forest(aut, text, dev, chunk=256)
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("name", sorted(PATTERNS))
def test_configuration_widths(name):
    """The sizes a configuration's file states are its automaton's and the program's."""
    cfg = PATTERNS[name]
    aut = ref.automaton(cfg["pattern"])
    w = cfg["widths"]
    assert (aut.ell, aut.pad_class) == (w["ell"], w["n_classes"])
    t = program(cfg).engine.tables
    assert (t.ell, t.ell_pad) == (w["ell"], w["ell_pad"])
