"""The reference against a witness outside the program: Python's ``re``.

    python -m pytest -q bench/tests/test_bench_witness.py

The reference builds its automaton with a frozen copy of the program's
front-end, so a fault of that front-end would sit on both sides of the
comparison that decides ``correct``.  These tests hold the reference against
``re``, which shares nothing with either:

- its verdict against ``re.fullmatch`` of the configuration's pattern, on
  valid, corrupted and cut texts of both configurations;
- every column of its clean forest, on small texts, against an enumeration of
  the pattern's parses by ``re``.  A column bit says that some parse of the
  whole text passes through a segment at a position; every segment ends with a
  terminal of the pattern, so projected onto terminals, column ``i`` says
  which occurrences of the pattern's terminals read character ``i`` in some
  parse.  ``re`` answers that directly: occurrence ``p`` reads character ``i``
  in some parse iff the pattern with occurrence ``p`` widened to also match a
  marker character fully matches the text with character ``i`` replaced by the
  marker, where ``p`` reads that character at all (the marker matches nowhere
  else, and ``p`` still matches what it did everywhere else).  The last column is non-empty iff ``re`` accepts the text.

The occurrences are found in the pattern with its counted repeats written out
(``X{3}`` → ``XXX``) by this file's own tokenizer; the only thing taken from
the front-end is which segment ends with which occurrence, and that is checked
too: the front-end's terminals, in order, must read the same bytes as the
occurrences, in order.
"""

import json
import re

import _paths  # noqa: F401
import numpy as np
import pytest
import torch

from bench import harness, textgen
from bench.reference import forest as ref
from bench.reference.numbering import TERM, number_regex
from bench.reference.segments import compute_segments

CONFIGS = {name: json.loads((harness.BENCH / "configs" / f"{name}.json").read_text())
           for name in ("traffic", "e125")}
CPU = torch.device("cpu")
MARK = "\x00"                 # matched by no terminal of either pattern


def written_out(pattern: str) -> str:
    """``pattern`` with every counted repeat ``(…){n}`` or ``[…]{n}`` written out,
    and every group made non-capturing."""
    rep = re.compile(r"(\([^()]*\)|\[[^\]]*\])\{(\d+)\}")
    while True:
        m = rep.search(pattern)
        if not m:
            break
        pattern = pattern[:m.start()] + m.group(1) * int(m.group(2)) + pattern[m.end():]
    assert "{" not in pattern
    return pattern.replace("(", "(?:")


def occurrences(pattern: str):
    """The terminal occurrences of a written-out pattern, left to right: (start,
    end) in the pattern and the set of bytes each matches."""
    out, i = [], 0
    while i < len(pattern):
        c = pattern[i]
        if pattern.startswith("(?:", i):
            i += 3
            continue
        if c in "()|*+?":
            i += 1
            continue
        j = pattern.index("]", i + 1) + 1 if c == "[" else i + (2 if c == "\\" else 1)
        tok = pattern[i:j]
        out.append(((i, j), frozenset(b for b in range(256) if re.fullmatch(tok, chr(b)))))
        i = j
    return out


def segment_occurrence(pattern: str, occ) -> np.ndarray:
    """For each segment of the front-end's table, the index of the occurrence its
    end-letter is (-1 for the end-mark), checked against ``occ``'s bytes."""
    table = compute_segments(number_regex(pattern))
    terms = [s for s in table.numbered.symbols if s.kind == TERM]
    assert len(terms) == len(occ)
    for s, (_, bytes_) in zip(terms, occ):
        assert frozenset(b for lo, hi in s.ranges for b in range(lo, hi + 1)) == bytes_
    rank = {s.sid: k for k, s in enumerate(terms)}
    return np.array([rank.get(table.end_letter[g], -1) for g in range(table.n)])


def brute_columns(pattern: str, occ, text: str) -> np.ndarray:
    """(n, occurrences) bool: occurrence p reads character i in some parse."""
    out = np.zeros((len(text), len(occ)), dtype=bool)
    for p, ((a, b), reads) in enumerate(occ):
        marked = re.compile(pattern[:a] + f"(?:{pattern[a:b]}|{MARK})" + pattern[b:], re.S)
        for i in range(len(text)):
            if ord(text[i]) in reads:               # the marker stands for text[i]
                out[i, p] = marked.fullmatch(text[:i] + MARK + text[i + 1:]) is not None
    return out


def sample_texts(name: str, n: int, seed: int):
    """A valid text of ``n`` bytes, the same with a byte corrupted, and a cut of it."""
    text = textgen.texts(CONFIGS[name]["text"], n, 1, seed, purpose=1)[0]
    spec = CONFIGS[name]["text"]
    r = textgen.rng(seed, 9)
    if "anchor" in spec:                   # e125: the anchor flipped, in the alphabet
        at, byte = n - int(spec["anchor_from_end"]), b"b"
    else:
        at, byte = int(r.integers(0, n)), b"~"
    corrupt = text[:at] + byte + text[at + 1:]
    cut = text[:int(r.integers(1, n))]
    return {"valid": text, "corrupted": corrupt, "cut": cut}


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("seed", [3, 2**40 + 11, 977])
def test_verdict_equals_re(name, seed):
    pattern = CONFIGS[name]["pattern"]
    aut = ref.automaton(pattern)
    whole = re.compile(pattern, re.S)
    seen = set()
    for n in (200, 700, 3000):
        for kind, text in sample_texts(name, n, seed + n).items():
            want = whole.fullmatch(text.decode("latin-1")) is not None
            assert ref.accepted(ref.forest(aut, text, CPU, chunk=64)) == want, (kind, n)
            seen.add(want)
    assert seen == {True, False}


@pytest.mark.parametrize("name,n", [("traffic", 90), ("e125", 140)])
@pytest.mark.parametrize("kind", ["valid", "corrupted", "cut"])
def test_columns_equal_re_enumeration(name, n, kind):
    pattern = CONFIGS[name]["pattern"]
    text = sample_texts(name, n, 5)[kind]
    wide = written_out(pattern)
    occ = occurrences(wide)
    seg_occ = segment_occurrence(pattern, occ)
    cols = ref.forest(ref.automaton(pattern), text, CPU, chunk=16).numpy()
    got = np.zeros((len(text), len(occ)), dtype=bool)
    for g in np.flatnonzero(seg_occ >= 0):
        got[:, seg_occ[g]] |= cols[:-1, g]
    want = brute_columns(wide, occ, text.decode("latin-1"))
    assert np.array_equal(got, want)
    accepted = re.fullmatch(wide, text.decode("latin-1"), re.S) is not None
    assert bool(cols[-1].any()) == accepted
    assert accepted == (kind == "valid") or kind == "cut"
    if accepted:
        assert want.any(axis=1).all()          # every character is read in a parse
