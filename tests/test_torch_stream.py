"""repro_torch's streaming parser against repro's, on the CPU.

The flows of ``tests/test_stream.py`` and ``tests/test_stream_edit.py`` run
through both packages side by side: ``StreamingParser`` over the port's
``torch`` / ``packed`` / ``sparse`` engines and the reference's ``jnp`` /
``packed`` / ``sparse`` ones.  After every step the two streams must agree
on ``SLPF.pack()``, ``accepted``, ``n``, ``n_sealed_chunks``,
``tree_height``, ``cache_nbytes`` and ``rebuilds``, and the port's SLPF must
equal a cold parse of the same text.  Tolerance is zero: OR-AND on {0,1} is
exact.  Also: snapshots survive later appends and edits (products are
shared, never written in place), the grouped build&merge of
``current_slpf`` equals one build&merge per leaf, and the facade's
``ParserStream`` matches ``repro``'s.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_corpus import artifacts  # noqa: E402

import repro  # noqa: E402
from repro.core.engine import ParserEngine as RefEngine  # noqa: E402
from repro.core.stream import StreamingParser as RefStream  # noqa: E402
from repro_torch import Parser, ParserConfig  # noqa: E402
from repro_torch.core.engine import ParserEngine  # noqa: E402
from repro_torch.core.stream import StreamingParser  # noqa: E402
from repro_torch.core.serial import parse_serial_matrix  # noqa: E402

AMBIG = "(a|b|ab)+"   # ambiguous: many LSTs per text
# port backend ↔ reference backend (ROADMAP.md, "Layout")
BACKENDS = [("torch", "jnp"), ("packed", "packed"), ("sparse", "sparse")]

_engines: dict = {}


def engines(port_backend: str):
    """(port engine, reference engine) over the same automaton, cached."""
    if port_backend not in _engines:
        art, port_m, _ = artifacts(AMBIG)
        ref_backend = dict(BACKENDS)[port_backend]
        _engines[port_backend] = (
            ParserEngine(port_m, backend=port_backend, device="cpu"),
            RefEngine(art.matrices, backend=ref_backend),
        )
    return _engines[port_backend]


class Pair:
    """The same stream in both packages; every call goes to both."""

    def __init__(self, backend="torch", **kw):
        port_eng, ref_eng = engines(backend)
        self.port = StreamingParser(port_eng, **kw)
        self.ref = RefStream(ref_eng, **kw)
        self.cold = engines("torch")[0]

    def __getattr__(self, name):
        def both(*args):
            got = getattr(self.port, name)(*args)
            want = getattr(self.ref, name)(*args)
            assert got == want, (name, args, got, want)
            return got
        return both

    def check(self, text=None):
        """Both streams agree on every observable; with ``text``, the port
        also equals a cold parse of it."""
        p, r = self.port, self.ref
        got = p.current_slpf()
        assert np.array_equal(got.pack(), r.current_slpf().pack())
        assert got.count_trees() == r.current_slpf().count_trees()
        assert p.accepted == r.accepted
        for field in ("n", "n_sealed_chunks", "tree_height", "cache_nbytes", "rebuilds",
                      "edits"):
            assert getattr(p, field) == getattr(r, field), field
        assert [len(c) for c in p._sealed_classes] == [len(c) for c in r._sealed_classes]
        if text is not None:
            assert p.n == len(text)
            assert np.array_equal(got.pack(), self.cold.parse(text).pack()), text
        return got


def _splits(text, cuts):
    pieces, prev = [], 0
    for c in list(cuts) + [len(text)]:
        pieces.append(text[prev:c])
        prev = c
    return pieces


@pytest.mark.parametrize("backend", [b for b, _ in BACKENDS])
@pytest.mark.parametrize("text", ["b", "abab", "a" * 23, "ab" * 40, "axb"])
def test_single_append_equals_reference_and_cold(backend, text):
    s = Pair(backend, first_seal_len=4)
    s.append(text)
    s.check(text)


def test_every_split_of_a_text():
    text = "ababab"
    for c1 in range(len(text) + 1):
        for c2 in range(c1, len(text) + 1):
            s = Pair(first_seal_len=4)
            for piece in _splits(text, [c1, c2]):
                s.append(piece)
            s.check(text)


@pytest.mark.parametrize("backend", [b for b, _ in BACKENDS])
def test_char_at_a_time_every_prefix(backend):
    text = "ab" * 7 + "b"
    s = Pair(backend, first_seal_len=4)
    for i, ch in enumerate(text):
        s.append(ch)
        s.check(text[: i + 1])


def test_empty_stream_and_zero_length_appends():
    s = Pair(first_seal_len=4)
    s.check("")
    s.append("")
    s.append("abab")
    s.append(b"")
    s.check("abab")


def test_matches_paper_oracles():
    from repro_torch.core.reference import ParallelArtifacts, parse_parallel_reference

    port_m = artifacts(AMBIG)[1]
    art = ParallelArtifacts.generate(port_m.table)
    s = Pair(first_seal_len=4)
    for piece in ("ab", "a", "bab"):
        s.append(piece)
    got = s.check("ababab")
    assert np.array_equal(got.columns, parse_parallel_reference(art, "ababab", c=3).columns)
    assert np.array_equal(got.columns, parse_serial_matrix(port_m, "ababab").columns)


@pytest.mark.parametrize("backend", [b for b, _ in BACKENDS])
def test_geometric_sealing_and_max_seal_len(backend):
    s = Pair(backend, first_seal_len=4)
    s.append("ab" * 125)                      # sealed 4, 8, …, 64; tail 126
    s.check("ab" * 125)
    lens = [len(c) for c in s.port._sealed_classes]
    assert lens == [4, 8, 16, 32, 64] and s.port._tail_len == 126
    capped = Pair(backend, first_seal_len=4, max_seal_len=100)
    assert capped.port.max_seal_len == capped.ref.max_seal_len == 64
    capped.append("ab" * 100)
    capped.append("ba" * 3)
    capped.check("ab" * 100 + "ba" * 3)
    assert max(len(c) for c in capped.port._sealed_classes) == 64


@pytest.mark.parametrize("backend", [b for b, _ in BACKENDS])
def test_snapshot_restore_survives_appends_and_edits(backend):
    """The in-place hazard: a snapshot shares its products with the live
    stream, so nothing after it may write into them."""
    s = Pair(backend, first_seal_len=4)
    s.append("abab")
    s.append("ab")
    snap_p, snap_r = s.port.snapshot(), s.ref.snapshot()
    held = [p.clone() for p in snap_p.sealed_products] + [snap_p.tail_product.clone()]
    base = s.check("ababab")

    s.append("ba" * 8)                        # crosses a seal
    s.edit(1, 3, "ba")
    s.delete(0, 2)
    s.insert(4, "aab")
    s.check()

    shared = list(snap_p.sealed_products) + [snap_p.tail_product]
    assert all(torch.equal(a, b) for a, b in zip(shared, held))
    s.port.restore(snap_p)
    s.ref.restore(snap_r)
    assert np.array_equal(s.check("ababab").pack(), base.pack())
    s.append("abab")
    s.check("ababab" + "abab")

    fresh = Pair(backend, first_seal_len=4)   # restore into a fresh stream
    fresh.port.restore(snap_p)
    fresh.ref.restore(snap_r)
    assert np.array_equal(fresh.check("ababab").pack(), base.pack())


def test_restore_clamps_seal_boundary_to_cap():
    s = Pair(first_seal_len=4)
    s.append("ab" * 40)                       # leaves 4, 8, 16, 32; tail 20
    capped = Pair(first_seal_len=4, max_seal_len=16)
    capped.port.restore(s.port.snapshot())
    capped.ref.restore(s.ref.snapshot())
    assert capped.port._next_seal == capped.ref._next_seal <= 16
    capped.check("ab" * 40)
    capped.append("ab" * 20)
    capped.check("ab" * 60)


@pytest.mark.parametrize("backend", [b for b, _ in BACKENDS])
def test_drop_cache_and_partial_eviction_rebuild_counts(backend):
    s = Pair(backend, first_seal_len=4)
    s.append("abab" * 4)
    assert s.port.cache_nbytes > 0
    s.drop_cache()
    assert s.port.cache_nbytes == 0
    s.check("abab" * 4)                       # rebuilt: 2 leaves + the tail
    assert s.port.rebuilds == 3
    s.append("ab")
    s.check("abab" * 4 + "ab")

    p = Pair(backend, first_seal_len=4)
    p.append("ab" * 14)                       # sealed leaves 4, 8, 16
    m = p.port.engine.obs.metrics
    before = m.counter("stream_rebuilds_total").value
    ports = sorted(p.port.sealed_cache_entries(), key=lambda e: -e[1])[:2]
    refs = sorted(p.ref.sealed_cache_entries(), key=lambda e: -e[1])[:2]
    assert [e[1:] for e in ports] == [e[1:] for e in refs]
    for (kp, _, _), (kr, _, _) in zip(ports, refs):
        assert p.port.drop_sealed_product(kp) == p.ref.drop_sealed_product(kr) > 0
    p.check("ab" * 14)
    assert p.port.rebuilds == 2
    assert m.counter("stream_rebuilds_total").value == before + 2

    c = Pair(backend, first_seal_len=4)       # snapshot of a cold stream
    c.append("abab" * 3)
    c.drop_cache()
    snap = c.port.snapshot()
    assert snap.sealed_products is None and c.port.rebuilds == 0
    c2 = StreamingParser(engines(backend)[0], first_seal_len=4)
    c2.restore(snap)
    assert np.array_equal(c2.current_slpf().pack(), c.cold.parse("abab" * 3).pack())
    assert c2.rebuilds == 2


@pytest.mark.parametrize("backend", [b for b, _ in BACKENDS])
def test_edit_delete_insert_flows(backend):
    s = Pair(backend, first_seal_len=4, max_seal_len=8)
    text = "ab" * 20
    s.append(text)
    text = text[:10] + "baba" + text[14:]     # [10, 14) crosses a seal boundary
    s.edit(10, 14, "baba")
    s.check(text)

    e = Pair(backend, first_seal_len=4, max_seal_len=8)
    e.insert(0, "ab")                         # into the empty stream
    text = "ab"
    e.check(text)
    e.insert(len(text), "ab" * 9)             # at n
    text += "ab" * 9
    e.insert(0, "ba")                         # at 0
    text = "ba" + text
    e.check(text)
    e.delete(3, 7)
    text = text[:3] + text[7:]
    e.check(text)
    e.delete(0, len(text))                    # everything
    e.insert(0, "ab")
    e.check("ab")

    v = Pair(backend, first_seal_len=4, max_seal_len=8)   # edits over evicted nodes
    text = "ab" * 16
    v.append(text)
    kp = max(v.port.sealed_cache_entries(), key=lambda e: e[1])[0]
    kr = max(v.ref.sealed_cache_entries(), key=lambda e: e[1])[0]
    assert v.port.drop_sealed_product(kp) == v.ref.drop_sealed_product(kr)
    text = text[:5] + "a" + text[6:]
    v.edit(5, 6, "a")
    v.check(text)
    v.drop_cache()
    text = text[:9] + text[12:]
    v.delete(9, 12)
    v.check(text)

    with pytest.raises(ValueError, match="out of bounds"):
        v.port.edit(2, 1, "a")


@pytest.mark.parametrize("cap", [None, 16])
def test_edit_position_fuzz(cap):
    rng = np.random.default_rng(7)
    s = Pair(first_seal_len=4, max_seal_len=cap)
    text = "".join(rng.choice(list("ab"), 60))
    s.append(text)
    for _ in range(10):
        lo = int(rng.integers(0, s.port.n + 1))
        hi = int(rng.integers(lo, min(s.port.n, lo + 7) + 1))
        repl = "".join(rng.choice(list("abx"), int(rng.integers(0, 5)), p=[0.45, 0.45, 0.1]))
        text = text[:lo] + repl + text[hi:]
        s.edit(lo, hi, repl)
        s.check(text)


def test_tree_balance_and_edit_metrics():
    s = Pair(first_seal_len=4, max_seal_len=4)
    s.append("ab" * 64)                       # 32 fixed-size leaves
    m = s.port.engine.obs.metrics
    edits0 = m.counter("stream_edits_total").value
    depth0 = m.histogram("stream_edit_recompose_depth").count
    for i in range(10):
        s.edit(3 + 7 * i, 5 + 7 * i, "ab")
    s.check()
    assert m.counter("stream_edits_total").value == edits0 + 10
    assert m.histogram("stream_edit_recompose_depth").count == depth0 + 10


def test_absorb_product_rejects_boundary_crossing():
    from repro_torch.errors import BudgetExceeded

    sp = StreamingParser(engines("torch")[0], first_seal_len=4)
    with pytest.raises(BudgetExceeded, match="seal boundary"):
        sp.absorb_product(np.zeros(9, dtype=np.int32), sp._eye)


def test_no_new_shapes_on_a_warm_stream():
    eng = ParserEngine(artifacts(AMBIG)[1], backend="torch", device="cpu")

    def stream():
        sp = StreamingParser(eng, first_seal_len=4)
        for ch in "ab" * 20:
            sp.append(ch)
        return sp.current_slpf()

    first = stream()
    warm = eng.compile_count
    assert np.array_equal(stream().pack(), first.pack())
    assert eng.compile_count == warm


def test_resolve_engine_rules():
    port_eng = engines("torch")[0]
    with pytest.raises(ValueError, match="prebuilt ParserEngine"):
        StreamingParser(port_eng, backend="packed")
    with pytest.raises(NotImplementedError, match="item 11"):
        StreamingParser(port_eng, mesh="host")
    built = StreamingParser(artifacts(AMBIG)[1], backend="packed", device="cpu")
    assert built.engine.backend.name == "packed"


@pytest.mark.parametrize("backend", [b for b, _ in BACKENDS])
def test_grouped_build_merge_equals_per_leaf(backend):
    """``current_slpf`` runs one build&merge per padded chunk length; each
    chunk's rows equal a build&merge of that chunk alone."""
    eng = engines(backend)[0]
    sp = StreamingParser(eng, first_seal_len=4, max_seal_len=16)
    sp.append("ab" * 45 + "b")                # leaves 4, 8, 16 ×4; tail 15
    chunks = sp._chunk_classes()
    Jf, Jb, _, _ = sp._joined()
    grouped = sp._build_merge_grouped(chunks, Jf, Jb)
    t = eng.tables
    for i, ch in enumerate(chunks):
        k = sp._bucket_len(len(ch))
        one = eng.phases.build_merge(t.N, eng.chunks_tensor(eng._pad_to(ch, 1, k)),
                                     Jf[i][None], Jb[i][None])
        assert np.array_equal(grouped[i], one[0, : len(ch)].numpy()), i
    # padded lengths 8 (the 4- and 8-leaves) and 16 (the rest and the tail)
    assert sorted({sp._bucket_len(len(c)) for c in chunks}) == [8, 16]
    calls = []
    phases = eng.phases
    orig = phases.build_merge
    phases.build_merge = lambda *a: calls.append(tuple(a[1].shape)) or orig(*a)
    try:
        slpf = sp.current_slpf()
    finally:
        phases.build_merge = orig
    assert sorted(calls) == [(2, 8), (5, 16)]   # one call per padded length
    assert np.array_equal(slpf.pack(), engines("torch")[0].parse("ab" * 45 + "b").pack())


def test_facade_parser_stream_matches_reference():
    art, port_m, _ = artifacts(AMBIG)
    cfg = dict(regex="<edit-facade>", first_seal_len=4, max_seal_len=8)
    p = Parser.from_matrices(port_m, ParserConfig(backend="torch", **cfg), device="cpu")
    r = repro.Parser.from_matrices(art.matrices, repro.ParserConfig(**cfg))
    with p.open_stream() as sp, r.open_stream() as sr:
        text = "ab" * 10
        assert sp.append(text) == sr.append(text)
        assert sp.n == sr.n == 0              # queued until a query drains it
        assert sp.edit(2, 6, "ba") == sr.edit(2, 6, "ba") == len(text) - 2
        text = text[:2] + "ba" + text[6:]
        sp.delete(0, 2)
        sr.delete(0, 2)
        text = text[2:]
        sp.insert(0, "ab")
        sr.insert(0, "ab")
        text = "ab" + text
        got, want = sp.result(), sr.result()
        assert np.array_equal(got.forest.pack(), want.forest.pack())
        assert sp.accepted == sr.accepted
        assert sp.n == sr.n == len(text)
        assert sp.n_sealed_chunks == sr.n_sealed_chunks
        assert got.backend == "torch" and got.n_chunks == want.n_chunks


def test_engine_pad_chunks_and_count_accepting_equal_reference():
    port, ref = engines("torch")
    for text in ("", "a", "abab", "ab" * 13, "axb"):
        classes = port.classes_of_text(text)
        for c in (1, 3, 8):
            assert np.array_equal(port.pad_chunks(classes, c),
                                  np.asarray(ref.pad_chunks(ref.classes_of_text(text), c)))
        assert port.count_accepting(text, 4) == ref.count_accepting(text, 4)
