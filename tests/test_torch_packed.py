"""repro_torch's packed backend against repro's, on the CPU.

Every word op of the packed semiring (``repro_torch/core/matrices.py``)
against its ``repro.core.matrices`` twin on random asymmetric tables; the
plain K4 (``kernels/ref.py::packed_reach_chunk_product_ref``) against the
Pallas kernel in interpret mode; every phase boundary and ``parse_batch``
against ``repro``'s ``ParserEngine(backend="packed")`` on the shared corpus,
with ``kernel=True`` phases on CPU tensors held against ``kernel=False``.
Words are int32 in the port and uint32 in the reference, compared as
``.view(np.uint32)``.  Tolerance is zero: OR-AND on {0,1} is exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from test_torch_corpus import CORPUS, N_CHUNKS, artifacts, carried_tables, i32, texts, u32  # noqa: E402

from repro.core import matrices as rm  # noqa: E402
from repro.core.engine import ParserEngine as RefEngine  # noqa: E402
from repro.kernels.packed_reach import packed_reach_chunk_product as pallas_packed_reach  # noqa: E402
from repro_torch import Parser, ParserConfig  # noqa: E402
from repro_torch.core import matrices as tm  # noqa: E402
from repro_torch.core.backend import PackedBackend, get_backend  # noqa: E402
from repro_torch.core.engine import ParserEngine, PhasePrograms  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import packed_reach_chunk_product_ref  # noqa: E402

SIZES = [32, 64, 96, 160]
DENSITIES = [0.0, 0.05, 0.3, 1.0]


def random_tables(n, density, seed, count=3):
    """``count`` random {0,1} (n, n) matrices; asymmetric unless the density
    is 0 or 1, so a transposed orientation cannot pass."""
    rng = np.random.default_rng(seed)
    N = rng.random((count, n, n)) < density
    if 0.0 < density < 1.0:
        assert not np.array_equal(N, N.swapaxes(-1, -2))
    return N


def packed_pair(N):
    """Packed tables of boolean N in both packages: (jnp uint32, torch int32)."""
    Np = rm.pack_transition_table(N)
    return jnp.asarray(Np), i32(Np)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("density", DENSITIES)
def test_packing_equals_reference(n, density):
    N = random_tables(n, density, seed=n)
    got = tm.pack_transition_table_torch(torch.tensor(N, dtype=torch.float32))
    assert np.array_equal(u32(got), rm.pack_transition_table(N))
    assert np.array_equal(u32(got), np.asarray(rm.pack_transition_table_jnp(jnp.asarray(N, jnp.float32))))
    back = tm.unpack_bits_torch(got, n)
    assert np.array_equal(back.numpy(), np.asarray(rm.unpack_bits_jnp(jnp.asarray(u32(got)), n)))
    assert np.array_equal(back.numpy() > 0.5, N.swapaxes(-1, -2))
    assert np.array_equal(u32(tm.packed_identity(n)), np.asarray(rm.packed_identity(n)))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("density", DENSITIES)
def test_packed_matmul_equals_reference(n, density):
    N = random_tables(n, density, seed=n + 1)
    jp, tp = packed_pair(N)
    want = np.asarray(rm.packed_semiring_matmul(jp[0], jp[1]))
    assert np.array_equal(u32(tm.packed_semiring_matmul(tp[0], tp[1])), want)
    # orientation: later ⊗ earlier is the Boolean product N[0] · N[1]
    assert np.array_equal(want, rm.pack_transition_table(rm.boolean_matmul(N[0], N[1])[None])[0])
    # leading axes broadcast, as the join scan hands whole stacks over
    stacked = tm.packed_semiring_matmul(tp[:2], tp[1:])
    assert np.array_equal(u32(stacked), np.asarray(rm.packed_semiring_matmul(jp[:2], jp[1:])))
    assert np.array_equal(u32(tm.packed_semiring_matmul(tp[2], tp[1:])),
                          np.asarray(rm.packed_semiring_matmul(jp[2], jp[1:])))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("density", DENSITIES)
def test_packed_matvecs_equal_reference(n, density):
    N = random_tables(n, density, seed=n + 2)
    jp, tp = packed_pair(N)
    rng = np.random.default_rng(n)
    for vd in (0.0, 0.2, 1.0):
        v = (rng.random(n) < vd).astype(np.float32)
        jv, tv = jnp.asarray(v), torch.tensor(v)
        jvp = rm.pack_bits_jnp(jv)
        tvp = i32(jvp)
        assert np.array_equal(tm.packed_matvec(tp[0], tv).numpy(), np.asarray(rm.packed_matvec(jp[0], jv)))
        assert np.array_equal(tm.packed_matvec_T(tp[0], tv).numpy(), np.asarray(rm.packed_matvec_T(jp[0], jv)))
        assert np.array_equal(u32(tm.packed_matvec_words(tp[0], tvp)),
                              np.asarray(rm.packed_matvec_words(jp[0], jvp)))
        assert np.array_equal(u32(tm.packed_matvec_T_words(tp[0], tvp)),
                              np.asarray(rm.packed_matvec_T_words(jp[0], jvp)))
        assert np.array_equal(u32(tm._select_or(tp[1], tv)), np.asarray(rm._select_or(jp[1], jv)))
        # a stack of matrices against one vector, the join's act
        stack = tm.packed_matvec(tp, tv).numpy()
        for i in range(len(N)):
            assert np.array_equal(stack[i], np.asarray(rm.packed_matvec(jp[i], jv)))
        # and against the Boolean oracle
        assert np.array_equal(stack[1] > 0.5, rm.boolean_matvec(N[1], v > 0.5))


def test_or_reduce_folds_every_width():
    rng = np.random.default_rng(4)
    for n in (0, 1, 2, 3, 5, 32, 33):
        x = rng.integers(-2**31, 2**31, size=(3, n), dtype=np.int64).astype(np.int32)
        want = np.bitwise_or.reduce(x.view(np.uint32), axis=1) if n else np.zeros(3, np.uint32)
        assert np.array_equal(u32(tm._or_reduce(torch.from_numpy(x), 1)), want)


def _pad_identity_table(rng, n_classes, lp, density):
    N = rng.random((n_classes + 1, lp, lp)) < density
    N[-1] = np.eye(lp, dtype=bool)                    # PAD = identity
    return N


@pytest.mark.parametrize("lp,density", [(32, 0.2), (64, 0.05), (96, 0.3)])
@pytest.mark.parametrize("k", [1, 3, 8])
def test_plain_packed_reach_equals_pallas(lp, density, k):
    rng = np.random.default_rng(lp + k)
    N = _pad_identity_table(rng, 4, lp, density)
    jp, tp = packed_pair(N)
    ids = rng.integers(0, 5, size=(3, k)).astype(np.int32)
    got = packed_reach_chunk_product_ref(tp, torch.from_numpy(ids))
    for c in range(len(ids)):
        want = pallas_packed_reach(jp, jnp.asarray(ids[c]), interpret=True)
        assert np.array_equal(u32(got[c]), np.asarray(want)), c
    # the wrapper's CPU path is the plain version
    assert torch.equal(ops.packed_reach_chunk_product(tp, torch.from_numpy(ids)), got)


_engines: dict = {}


def _ref_engine(key):
    if key not in _engines:
        _engines[key] = RefEngine(artifacts(key)[0].matrices, backend="packed")
    return _engines[key]


@pytest.mark.parametrize("key", CORPUS)
def test_phase_boundaries_equal_reference_per_bucket(key):
    ref = _ref_engine(key)
    t = carried_tables(ref)
    plain, kern = PhasePrograms(PackedBackend()), PhasePrograms(PackedBackend(kernel=True))
    for text in texts(key) + [texts(key)[-2] * 2]:
        classes = ref.classes_of_text(text)
        c, k = ref.bucket_shape(len(classes), N_CHUNKS)
        chunks = ref._pad_to(classes, c, k)
        rt = ref.tables
        P = ref.phases.reach(rt.N, jnp.asarray(chunks))
        Jf, Jb, col0 = ref.phases.join(P, rt.I, rt.F)
        cols = ref.phases.build_merge(rt.N, jnp.asarray(chunks), Jf, Jb)

        ch = torch.from_numpy(chunks)
        for phases in (plain, kern):
            gP = phases.reach(t.N, ch)
            gJf, gJb, gcol0 = phases.join(gP, t.I, t.F)
            gcols = phases.build_merge(t.N, ch, gJf, gJb)
            assert np.array_equal(u32(gP), np.asarray(P)), (key, text)
            assert np.array_equal(gJf.numpy(), np.asarray(Jf)), (key, text)
            assert np.array_equal(gJb.numpy(), np.asarray(Jb)), (key, text)
            assert np.array_equal(u32(gcol0), np.asarray(col0)), (key, text)
            assert np.array_equal(u32(gcols), np.asarray(cols)), (key, text)
        # compose stays in the representation, with the identity a no-op
        eye = plain.backend.identity_product(t.ell_pad)
        assert torch.equal(plain.compose(gP, eye), gP) and torch.equal(plain.compose(eye, gP), gP)


@pytest.mark.parametrize("key", CORPUS)
def test_parse_batch_equals_reference_engine(key):
    ref = _ref_engine(key)
    port = ParserEngine(artifacts(key)[1], backend="packed", device="cpu")
    batch = texts(key)
    for text, g, w in zip(batch, port.parse_batch(batch, n_chunks=N_CHUNKS),
                          ref.parse_batch(batch, n_chunks=N_CHUNKS)):
        assert np.array_equal(g.pack(), w.pack()), (key, text)
        assert g.accepted == w.accepted, (key, text)


def test_batched_grid_equals_per_row():
    ref = _ref_engine("(a|b|ab)+")
    t = carried_tables(ref)
    be = PackedBackend()
    rng = np.random.default_rng(3)
    batch = torch.tensor(rng.integers(0, t.N.shape[0], size=(3, 4, 8)).astype(np.int32))
    P = be.reach(t.N, batch)
    Jf, Jb = be.join(P, t.I, t.F)
    cols = be.build_merge_packed(t.N, batch, Jf, Jb)
    for b in range(3):
        Pb = be.reach(t.N, batch[b])
        Jfb, Jbb = be.join(Pb, t.I, t.F)
        assert torch.equal(P[b], Pb) and torch.equal(Jf[b], Jfb) and torch.equal(Jb[b], Jbb)
        assert torch.equal(cols[b], be.build_merge_packed(t.N, batch[b], Jfb, Jbb))


def test_kernel_backend_runs_only_on_the_card():
    assert not PackedBackend().needs_cuda and PackedBackend(kernel=True).needs_cuda
    assert get_backend("packed").name == "packed"
    with pytest.raises(ValueError, match="runs only on the card"):
        Parser(ParserConfig(regex="a|b", backend="packed", kernel=True), device="cpu")
    p = Parser(ParserConfig(regex="a|b", backend="packed"), device="cpu")
    assert p.parse("a").ok and p.parse("a").speculation is None
