"""repro_torch's sparse (speculation-reducing) backend against repro's, on the CPU.

Every sparse op (``repro_torch/core/matrices.py``) against its
``repro.core.matrices`` twin, sentinel rows and the identity flag included;
the plain K5 (``kernels/ref.py::sparse_reach_rows_ref``) against the Pallas
kernel in interpret mode; every phase boundary and ``parse_batch`` against
``repro``'s ``ParserEngine(backend="sparse")`` on the shared corpus (both
``kernel`` settings, phases on CPU tensors); the bound width S, the
dense-fallback rule, ``feasible_depth=2``, binding errors and
``ParseResult.speculation``.  Tolerance is zero.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from test_torch_corpus import CORPUS, N_CHUNKS, artifacts, carried_tables, i32, texts, u32  # noqa: E402
from test_torch_packed import DENSITIES, SIZES, random_tables  # noqa: E402

import repro  # noqa: E402
from repro.core import matrices as rm  # noqa: E402
from repro.core.backend import SparseBackend as RefSparse  # noqa: E402
from repro.core.engine import ParserEngine as RefEngine  # noqa: E402
from repro.core.segments import compute_segments as ref_compute_segments  # noqa: E402
from repro.kernels.sparse_reach import sparse_reach_rows as pallas_sparse_reach  # noqa: E402
from repro_torch import Parser, ParserConfig  # noqa: E402
from repro_torch.core import matrices as tm  # noqa: E402
from repro_torch.core.backend import SparseBackend  # noqa: E402
from repro_torch.core.engine import ParserEngine, PhasePrograms  # noqa: E402
from repro_torch.core.matrices import build_matrices  # noqa: E402
from repro_torch.core.segments import compute_segments  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import sparse_reach_rows_ref  # noqa: E402


def sparsify(M, S, n_empty_first=0):
    """Dense {0,1} (n, n) → the sparse (S, 1+W) uint32 rep listing its
    nonzero columns, after ``n_empty_first`` unused slots."""
    n = M.shape[-1]
    cols = np.where(M.any(axis=0))[0]
    assert len(cols) + n_empty_first <= S
    P = np.zeros((S, 1 + n // 32), dtype=np.uint32)
    P[:, 0] = rm.SPARSE_EMPTY
    rows = slice(n_empty_first, n_empty_first + len(cols))
    P[rows, 0] = cols
    P[rows, 1:] = rm.pack_transition_table(M[None])[0][cols]
    return P


def sparse_stack(N):
    """The sparse reps of each matrix of N (S = n, one unused slot first
    when there is room), plus the flagged identity appended."""
    n = N.shape[-1]
    reps = [sparsify(M, n, n_empty_first=int(M.any(axis=0).sum() < n)) for M in N]
    reps.append(np.asarray(rm.sparse_identity(n, n // 32)))
    return np.stack(reps)


def test_sentinels_fit_int32_and_equal_reference():
    assert tm.SPARSE_EMPTY == int(rm.SPARSE_EMPTY) and tm.SPARSE_IDENT == int(rm.SPARSE_IDENT)
    assert max(tm.SPARSE_EMPTY, tm.SPARSE_IDENT) < 2**31
    for rows, W in ((8, 2), (1, 5)):
        got = tm.sparse_identity(rows, W)
        assert np.array_equal(u32(got), np.asarray(rm.sparse_identity(rows, W)))
        assert bool(tm.sparse_is_identity(got))
    idx = np.array([3, 40, tm.SPARSE_EMPTY, 63, 64, tm.SPARSE_IDENT], dtype=np.int32)
    assert np.array_equal(u32(tm.sparse_init_rows(torch.from_numpy(idx), 64)),
                          np.asarray(rm.sparse_init_rows(jnp.asarray(idx), 64)))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("density", DENSITIES)
def test_sparse_ops_equal_reference(n, density):
    N = random_tables(n, density, seed=n + 7)
    P = sparse_stack(N)                          # (4, n, 1+W): 3 listed + identity
    jP, tP = jnp.asarray(P), i32(P)
    for i in range(len(P)):
        assert np.array_equal(u32(tm.sparse_to_packed(tP[i], n)),
                              np.asarray(rm.sparse_to_packed(jP[i], n)))
    assert np.array_equal(tm.sparse_is_identity(tP).numpy(), [False] * 3 + [True])
    # compose every ordered pair, identity on either side, as one stack
    a, b = np.divmod(np.arange(len(P) ** 2), len(P))
    got = tm.sparse_compose(tP[a], tP[b])
    for j, (ia, ib) in enumerate(zip(a, b)):
        want = np.asarray(rm.sparse_compose(jP[ia], jP[ib]))
        assert np.array_equal(u32(got[j]), want), (ia, ib)
    # the Boolean oracle: later ⊗ earlier = N[0] · N[1]
    dense = u32(tm.sparse_to_packed(tm.sparse_compose(tP[0], tP[1]), n))
    assert np.array_equal(dense, rm.pack_transition_table(rm.boolean_matmul(N[0], N[1])[None])[0])
    rng = np.random.default_rng(n)
    for vd in (0.0, 0.3, 1.0):
        v = (rng.random(n) < vd).astype(np.float32)
        gv, gT = tm.sparse_matvec(tP, torch.tensor(v)), tm.sparse_matvec_T(tP, torch.tensor(v))
        for i in range(len(P)):
            assert np.array_equal(gv[i].numpy(), np.asarray(rm.sparse_matvec(jP[i], jnp.asarray(v))))
            assert np.array_equal(gT[i].numpy(), np.asarray(rm.sparse_matvec_T(jP[i], jnp.asarray(v))))


@pytest.mark.parametrize("lp,S", [(32, 8), (64, 16), (96, 64)])
@pytest.mark.parametrize("k", [1, 3, 8])
def test_plain_sparse_reach_equals_pallas(lp, S, k):
    rng = np.random.default_rng(lp + S + k)
    N = rng.random((5, lp, lp)) < 0.1
    N[-1] = np.eye(lp, dtype=bool)
    Np = rm.pack_transition_table(N)
    idx = np.sort(rng.choice(lp, size=S - 2, replace=False)).astype(np.int32)
    idx = np.concatenate([idx, [tm.SPARSE_EMPTY] * 2]).astype(np.int32)
    R0 = np.asarray(rm.sparse_init_rows(jnp.asarray(idx), lp))
    ids = rng.integers(0, 5, size=(2, k)).astype(np.int32)
    R0s = np.stack([R0, R0[::-1]])
    got = sparse_reach_rows_ref(i32(Np), torch.from_numpy(ids), i32(R0s))
    for c in range(2):
        want = pallas_sparse_reach(jnp.asarray(Np), jnp.asarray(ids[c]), jnp.asarray(R0s[c]),
                                   interpret=True)
        assert np.array_equal(u32(got[c]), np.asarray(want)), c
    assert torch.equal(ops.sparse_reach_rows(i32(Np), torch.from_numpy(ids), i32(R0s)), got)


_engines: dict = {}


def _ref_engine(key, **kw):
    name = (key, tuple(sorted(kw.items())))
    if name not in _engines:
        _engines[name] = RefEngine(artifacts(key)[0].matrices, backend=RefSparse(**kw))
    return _engines[name]


def _bound(t, **kw):
    be = SparseBackend(**kw)
    be.bind_tables(t)
    return be


@pytest.mark.parametrize("key", CORPUS)
def test_phase_boundaries_equal_reference_per_bucket(key):
    ref = _ref_engine(key)
    t = carried_tables(ref)
    plain, kern = PhasePrograms(_bound(t)), PhasePrograms(_bound(t, kernel=True))
    assert plain.backend._width == ref.backend._width
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
        eye = plain.backend.identity_product(t.ell_pad)
        assert torch.equal(plain.compose(gP, eye), gP) and torch.equal(plain.compose(eye, gP), gP)


@pytest.mark.parametrize("key", CORPUS)
def test_parse_batch_and_width_equal_reference_engine(key):
    ref = _ref_engine(key)
    port = ParserEngine(artifacts(key)[1], backend="sparse", device="cpu")
    assert port.backend._width == ref.backend._width
    batch = texts(key)
    for text, g, w in zip(batch, port.parse_batch(batch, n_chunks=N_CHUNKS),
                          ref.parse_batch(batch, n_chunks=N_CHUNKS)):
        assert np.array_equal(g.pack(), w.pack()), (key, text)
        assert g.accepted == w.accepted, (key, text)


@pytest.mark.parametrize("key", CORPUS)
def test_feasible_widths_equal_reference(key):
    ref = _ref_engine(key)
    port = ParserEngine(artifacts(key)[1], backend="sparse", device="cpu")
    for depth in (1, 2):
        for text in texts(key):
            classes = ref.classes_of_text(text)
            c, k = ref.bucket_shape(len(classes), N_CHUNKS)
            chunks = ref._pad_to(classes, c, k)
            want = rm.feasible_start_widths(np.asarray(ref.tables.N), chunks, depth=depth)
            got = tm.feasible_start_widths(port.tables.N.numpy(), chunks, depth=depth)
            assert np.array_equal(got, want), (key, text, depth)


def test_width_with_ell_pad_not_a_multiple_of_s():
    """(a|b)*a(a|b){31}: ℓp = 96 with S = 64, as in the reference's test."""
    table = compute_segments("(a|b)*a(a|b){31}")
    port = ParserEngine(build_matrices(table), backend="sparse", device="cpu")
    ref = RefEngine(ref_compute_segments("(a|b)*a(a|b){31}"), backend="sparse")
    lp, S = port.tables.ell_pad, port.backend._width
    assert (lp, S) == (ref.tables.ell_pad, ref.backend._width) and lp % S != 0
    rng = np.random.default_rng(5)
    for n in (1, 33, 70):
        text = bytes(rng.choice([97, 98], size=n))
        assert np.array_equal(port.parse(text, n_chunks=4).pack(), ref.parse(text, n_chunks=4).pack())


@pytest.mark.parametrize("kw", [{"min_width": 4096}, {"depth": 2}, {"depth": 2, "kernel": True}])
def test_dense_fallback_and_depth_two_equal_reference(kw):
    key = "(a|b|ab)+"
    ref = _ref_engine(key, **{k: v for k, v in kw.items() if k != "kernel"})
    t = carried_tables(ref)
    be = _bound(t, **kw)
    assert be._width == ref.backend._width
    if "min_width" in kw:
        assert be._width == t.ell_pad                 # S = ℓp: no reduction
    phases = PhasePrograms(be)
    for text in texts(key) + [b"abba" * 9]:
        classes = ref.classes_of_text(text)
        chunks = ref._pad_to(classes, *ref.bucket_shape(len(classes), N_CHUNKS))
        P = ref.phases.reach(ref.tables.N, jnp.asarray(chunks))
        gP = phases.reach(t.N, torch.from_numpy(chunks))
        assert np.array_equal(u32(gP), np.asarray(P)), text
    port = ParserEngine(artifacts(key)[1], backend=SparseBackend(**{
        k: v for k, v in kw.items() if k != "kernel"}), device="cpu")
    for text in texts(key):
        assert np.array_equal(port.parse(text, n_chunks=N_CHUNKS).pack(),
                              ref.parse(text, n_chunks=N_CHUNKS).pack()), text


def test_all_pad_chunks_give_the_flagged_identity():
    port = ParserEngine(artifacts("(ab|a)*")[1], backend="sparse", device="cpu")
    chunks = port.chunks_tensor(port._pad_to(np.zeros(0, np.int32), 4, 8))
    P = port.phases.reach(port.tables.N, chunks)
    assert P.shape[0] == 4 and bool(tm.sparse_is_identity(P).all())


def test_unbound_backend_raises_and_bound_rejects_other_ell_pad():
    be = SparseBackend()
    with pytest.raises(RuntimeError, match="unbound"):
        be.reach(torch.zeros((2, 32, 32)), torch.zeros((1, 8), dtype=torch.int32))
    with pytest.raises(RuntimeError, match="unbound"):
        be.identity_product(32)
    with pytest.raises(ValueError, match="depth"):
        SparseBackend(depth=0)
    port = ParserEngine(artifacts("(ab|a)*")[1], backend="sparse", device="cpu")
    with pytest.raises(ValueError, match="bound to"):
        port.backend.identity_product(port.tables.ell_pad * 2)


@pytest.mark.parametrize("depth", [1, 2])
def test_speculation_equals_reference(depth):
    cfg = dict(regex="(abc)*", backend="sparse", n_chunks=4, feasible_depth=depth)
    port = Parser(ParserConfig(**cfg), device="cpu")
    ref = repro.Parser(repro.ParserConfig(**cfg))
    for text in (b"abcabc", b"", b"bcabcab", b"abcabcabcabcabc~"):
        got, want = port.parse(text), ref.parse(text)
        assert got.speculation == want.speculation, text
        assert np.array_equal(got.forest.pack(), want.forest.pack()), text
    spec = port.parse(b"abcabc").speculation
    assert spec["width_max"] <= spec["product_rows"] <= spec["ell_pad"]
    assert Parser(ParserConfig(regex="(abc)*", backend="packed"), device="cpu").parse(
        b"abc").speculation is None
    assert Parser(ParserConfig(regex="(abc)*", backend="torch"), device="cpu").parse(
        b"abc").speculation is None


def test_kernel_backend_runs_only_on_the_card():
    assert SparseBackend(kernel=True).needs_cuda and not SparseBackend().needs_cuda
    with pytest.raises(ValueError, match="runs only on the card"):
        Parser(ParserConfig(regex="a|b", backend="sparse", kernel=True), device="cpu")
