"""repro_torch's engine against repro's ``ParserEngine(backend="jnp")``.

Every phase boundary — products P, entries Jf/Jb, the packed text-start
column, the packed clean columns — is compared per bucket on the
conformance corpus, with the reference's own tables carried over through
``EngineTables.from_arrays``.  Packed words are int32 in the port and uint32
in the reference; they are compared as ``.view(np.uint32)``.  Tolerance is
zero: OR-AND on {0,1} is exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from test_torch_corpus import CORPUS, N_CHUNKS, artifacts, carried_tables, texts, u32  # noqa: E402

from repro.core.engine import ParserEngine as RefEngine  # noqa: E402
from repro_torch.core.backend import TorchBackend, get_backend, list_backends  # noqa: E402
from repro_torch.core.engine import (  # noqa: E402
    ParserEngine,
    PhasePrograms,
    make_parse_core,
)
from repro_torch.obs import ObsConfig, ObsHandle  # noqa: E402

_engines: dict = {}


def _ref_engine(key):
    if key not in _engines:
        _engines[key] = RefEngine(artifacts(key)[0].matrices, backend="jnp")
    return _engines[key]


@pytest.mark.parametrize("key", CORPUS)
def test_phase_boundaries_equal_reference_per_bucket(key):
    ref = _ref_engine(key)
    t = carried_tables(ref)
    phases = PhasePrograms(TorchBackend())
    for text in texts(key) + [texts(key)[-2] * 2]:
        classes = ref.classes_of_text(text)
        c, k = ref.bucket_shape(len(classes), N_CHUNKS)
        chunks = ref._pad_to(classes, c, k)
        rt = ref.tables
        P = ref.phases.reach(rt.N, jnp.asarray(chunks))
        Jf, Jb, col0 = ref.phases.join(P, rt.I, rt.F)
        cols = ref.phases.build_merge(rt.N, jnp.asarray(chunks), Jf, Jb)

        ch = torch.from_numpy(chunks)
        gP = phases.reach(t.N, ch)
        gJf, gJb, gcol0 = phases.join(gP, t.I, t.F)
        gcols = phases.build_merge(t.N, ch, gJf, gJb)
        assert np.array_equal(gP.numpy(), np.asarray(P)), (key, text)
        assert np.array_equal(gJf.numpy(), np.asarray(Jf)), (key, text)
        assert np.array_equal(gJb.numpy(), np.asarray(Jb)), (key, text)
        assert np.array_equal(u32(gcol0), np.asarray(col0)), (key, text)
        assert np.array_equal(u32(gcols), np.asarray(cols)), (key, text)
        assert gcols.shape == (c, k, t.ell_pad // 32)


@pytest.mark.parametrize("key", CORPUS)
def test_engine_tables_equal_reference(key):
    ref = _ref_engine(key)
    port = ParserEngine(artifacts(key)[1], backend="torch", device="cpu")
    carried = carried_tables(ref)
    for name in ("N", "I", "F", "byte_to_class"):
        want = np.asarray(getattr(ref.tables, name))
        assert np.array_equal(getattr(port.tables, name).numpy(), want), name
        assert np.array_equal(getattr(carried, name).numpy(), want), name
    assert (port.tables.ell, port.tables.ell_pad, port.tables.pad_class) == (
        ref.tables.ell, ref.tables.ell_pad, ref.tables.pad_class
    )


@pytest.mark.parametrize("key", CORPUS)
def test_engine_parse_equals_reference_engine(key):
    ref = _ref_engine(key)
    port = ParserEngine(artifacts(key)[1], backend="torch", device="cpu")
    batch = texts(key)
    got = port.parse_batch(batch, n_chunks=N_CHUNKS)
    want = ref.parse_batch(batch, n_chunks=N_CHUNKS)
    for text, g, w in zip(batch, got, want):
        assert np.array_equal(g.columns, w.columns), (key, text)
        assert np.array_equal(g.pack(), w.pack()), (key, text)
        assert g.accepted == w.accepted
    single = port.parse(batch[-2], n_chunks=N_CHUNKS)
    assert np.array_equal(single.pack(), ref.parse(batch[-2], n_chunks=N_CHUNKS).pack())


@pytest.mark.parametrize("backend,ref_backend", [("torch", "jnp"), ("packed", "packed"),
                                                 ("sparse", "sparse")])
def test_backend_conformance_mesh_route(backend, ref_backend):
    """The mesh route (``ParserEngine(mesh=...)`` on the 1-rank mesh) on a
    corpus slice, as ``tests/test_conformance.py`` holds the reference's:
    equal to the port's fused parse and to the reference's mesh route."""
    from repro.launch.mesh import make_parse_mesh as ref_make_parse_mesh
    from repro_torch.launch.mesh import make_parse_mesh

    key = CORPUS[1]
    art, port_m, _ = artifacts(key)
    fused = ParserEngine(port_m, backend=backend, device="cpu")
    meshed = ParserEngine(port_m, backend=backend, device="cpu", mesh=make_parse_mesh())
    ref_meshed = RefEngine(art.matrices, backend=ref_backend, mesh=ref_make_parse_mesh())
    for text in texts(key)[:6]:
        got = meshed.parse(text, n_chunks=N_CHUNKS)
        assert np.array_equal(got.pack(), fused.parse(text, n_chunks=N_CHUNKS).pack()), text
        assert np.array_equal(got.pack(), ref_meshed.parse(text, n_chunks=N_CHUNKS).pack()), text


def test_batched_core_equals_per_row_core():
    ref = _ref_engine("(a|b|ab)+")
    t = carried_tables(ref)
    core = make_parse_core(TorchBackend())
    rng = np.random.default_rng(3)
    batch = torch.tensor(rng.integers(0, t.N.shape[0], size=(3, 4, 8)).astype(np.int32))
    col0s, colss = core(t.N, t.I, t.F, batch)
    for b in range(3):
        col0, cols = core(t.N, t.I, t.F, batch[b])
        assert torch.equal(col0s[b], col0) and torch.equal(colss[b], cols)


def test_parse_batch_columns_equal_the_host_route():
    """``parse_batch`` over ragged texts in two buckets (columns unpacked by
    ``ops.unpack_columns``'s plain version) against ``_assemble``'s host
    unpack of the same core's packed words: equal columns, each result's its
    own C-contiguous, writable bool array, and an earlier parse's columns
    unchanged by a later one."""
    key = "(a|b|ab)+"
    obs = ObsHandle.from_config(ObsConfig(enabled=True))
    eng = ParserEngine(artifacts(key)[1], backend="torch", device="cpu", obs=obs)
    batch = ["ab" * 5 + "a", "b", "", "abba" * 20 + "b", "ab" * 3]
    results = eng.parse_batch(batch, n_chunks=N_CHUNKS)
    builds = [s for s in obs.tracer.spans if s.name == "phase.host_build"]
    assert len(builds) == len(batch) and {s.attrs["unpacked_on"] for s in builds} == {"host"}
    kept = [r.columns.copy() for r in results]
    for text, r in zip(batch, results):
        classes = eng.classes_of_text(text)
        c, k = eng.bucket_shape(len(classes), N_CHUNKS)
        col0, cols = eng.run(eng.chunks_tensor(eng._pad_to(classes, c, k)))
        want = eng._assemble(col0.numpy(), cols.numpy(), classes)
        assert np.array_equal(r.columns, want.columns), text
        assert r.columns.dtype == np.bool_ and r.columns.shape == (len(classes) + 1, eng.tables.ell)
        assert r.columns.flags.c_contiguous and r.columns.flags.writeable
    for i, a in enumerate(results):
        for b in results[i + 1:]:
            assert not np.shares_memory(a.columns, b.columns)
    later = eng.parse_batch(["ba" * 7, "abab"], n_chunks=N_CHUNKS)
    for r, before in zip(results, kept):
        assert np.array_equal(r.columns, before)
    assert all(not np.shares_memory(a.columns, b.columns) for a in results for b in later)


def test_bucket_shape_and_compile_count_match_reference():
    key = "(ab|a)*"
    ref = _ref_engine(key)
    port = ParserEngine(artifacts(key)[1], backend="torch", device="cpu")
    for n in (0, 1, 7, 8, 33, 100, 1000):
        assert port.bucket_shape(n, N_CHUNKS) == ref.bucket_shape(n, N_CHUNKS)
    port.parse_batch(["ab", "a", "aba"], n_chunks=N_CHUNKS)       # one (4, 4, 8) shape
    port.parse("abab", n_chunks=N_CHUNKS)                          # (1, 4, 8)
    port.parse("ab" * 40, n_chunks=N_CHUNKS)                       # (1, 4, 32)
    port.parse("aab", n_chunks=N_CHUNKS)                           # seen before
    assert port.compile_count == 3


def test_backend_registry():
    assert list_backends() == ["cuda", "packed", "sparse", "torch"]
    be = TorchBackend()
    assert get_backend(be) is be and get_backend("cuda").name == "cuda"
    with pytest.raises(ValueError, match="unknown parse backend"):
        get_backend("jnp")
    assert torch.equal(be.identity_product(64), torch.eye(64))
    eye = be.identity_product(32)
    rng = np.random.default_rng(1)
    p = torch.tensor((rng.random((32, 32)) < 0.2).astype(np.float32))
    assert torch.equal(be.compose(p, eye), p) and torch.equal(be.compose(eye, p), p)


def test_engine_refuses_cuda_backend_on_cpu():
    with pytest.raises(ValueError, match="runs only on the card"):
        ParserEngine(artifacts("(ab|a)*")[1], backend="cuda", device="cpu")


def test_engine_device_none_means_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ParserEngine(artifacts("(ab|a)*")[1], backend="torch")
