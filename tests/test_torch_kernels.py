"""repro_torch's kernel modules on the CPU.

Each plain PyTorch kernel version (``repro_torch/kernels/ref.py``) against
the reference's Pallas kernel (``repro.kernels.ops``, interpret mode on the
CPU, ℓp = 128) on the same numpy inputs; the wrappers' CPU path; the join
scan.  The CUDA kernels themselves are held against these plain versions on
the card by ``tests/test_torch_cuda.py``.  Tolerance is zero: OR-AND on
{0,1} is exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.engine import EngineTables as RefTables  # noqa: E402
from repro.core.matrices import pack_bits  # noqa: E402
from repro.core.reference import ParallelArtifacts  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro_torch.core import backend as port_backend  # noqa: E402
from repro_torch.core.matrices import (  # noqa: E402
    SPARSE_EMPTY,
    pack_transition_table_torch,
    sparse_init_rows,
)
from repro_torch.core.scan import associative_prefix, exclusive_entries  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import (  # noqa: E402
    build_merge_chunk_ref,
    build_merge_packed_ref,
    flash_attention_ref,
    packed_reach_chunk_product_ref,
    reach_chunk_product_ref,
    semiring_matmul_ref,
    sparse_reach_rows_ref,
    ssd_chunk_ref,
    unpack_columns_ref,
)

PATTERNS = ["(ab|a)*", "(a|b|ab)+", "x(yz|y)*z?"]


def _tables(pattern):
    t = RefTables.from_matrices(ParallelArtifacts.generate(pattern).matrices, lane_pad=128)
    return np.asarray(t.N), np.asarray(t.I), np.asarray(t.F)


def _bool(rng, shape, density):
    return (rng.random(shape) < density).astype(np.float32)


@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (256, 128, 128), (128, 256, 384)])
@pytest.mark.parametrize("density", [0.02, 0.3])
def test_semiring_matmul_plain_equals_pallas(m, k, n, density):
    rng = np.random.default_rng(m + k + n)
    a, b = _bool(rng, (m, k), density), _bool(rng, (k, n), density)
    want = np.asarray(ref_ops.semiring_matmul(jnp.asarray(a), jnp.asarray(b)))
    got = semiring_matmul_ref(torch.tensor(a), torch.tensor(b)).numpy()
    assert np.array_equal(got, want)
    stacked = semiring_matmul_ref(torch.tensor(np.stack([a, a])), torch.tensor(np.stack([b, b])))
    assert np.array_equal(stacked[1].numpy(), want)


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("klen", [1, 7, 16])
def test_reach_plain_equals_pallas(pattern, klen):
    N, _, _ = _tables(pattern)
    rng = np.random.default_rng(klen)
    ids = rng.integers(0, N.shape[0], size=(3, klen)).astype(np.int32)
    got = reach_chunk_product_ref(torch.tensor(N), torch.tensor(ids)).numpy()
    for c in range(3):
        want = np.asarray(ref_ops.reach_chunk_product(jnp.asarray(N), jnp.asarray(ids[c])))
        assert np.array_equal(got[c], want)


@pytest.mark.parametrize("pattern", PATTERNS[:2])
@pytest.mark.parametrize("klen", [1, 8, 13])
def test_build_merge_plain_equals_pallas(pattern, klen):
    N, I, F = _tables(pattern)
    rng = np.random.default_rng(klen + 17)
    ids = rng.integers(0, N.shape[0], size=(2, klen)).astype(np.int32)
    ef = np.stack([I, _bool(rng, I.shape, 0.5)])
    eb = np.stack([F, _bool(rng, F.shape, 0.5)])
    args = [torch.tensor(x) for x in (N, ids, ef, eb)]
    got = build_merge_chunk_ref(*args).numpy()
    packed = build_merge_packed_ref(*args)
    assert packed.dtype == torch.int32
    for c in range(2):
        want = np.asarray(ref_ops.build_merge_chunk(
            jnp.asarray(N), jnp.asarray(ids[c]), jnp.asarray(ef[c]), jnp.asarray(eb[c])
        ))
        assert np.array_equal(got[c], want)
        assert np.array_equal(packed[c].numpy().view(np.uint32), pack_bits(want > 0))


def test_wrappers_run_the_plain_version_on_cpu_tensors():
    N, I, F = _tables("(a|b|ab)+")
    rng = np.random.default_rng(0)
    Nt = torch.tensor(N)
    ids = torch.tensor(rng.integers(0, N.shape[0], size=(2, 5)).astype(np.int32))
    ef = torch.tensor(np.stack([I, I]))
    eb = torch.tensor(np.stack([F, F]))
    ops.reset_launches()
    assert torch.equal(ops.reach_chunk_product(Nt, ids), reach_chunk_product_ref(Nt, ids))
    assert torch.equal(
        ops.build_merge_packed(Nt, ids, ef, eb), build_merge_packed_ref(Nt, ids, ef, eb)
    )
    a = torch.tensor(_bool(rng, (3, 32, 32), 0.2))
    assert torch.equal(ops.semiring_matmul(a, a), semiring_matmul_ref(a, a))
    Np = pack_transition_table_torch(Nt)
    R0 = sparse_init_rows(torch.tensor([[0, 5, SPARSE_EMPTY]] * 2, dtype=torch.int32), N.shape[-1])
    assert torch.equal(ops.packed_reach_chunk_product(Np, ids),
                       packed_reach_chunk_product_ref(Np, ids))
    assert torch.equal(ops.sparse_reach_rows(Np, ids, R0), sparse_reach_rows_ref(Np, ids, R0))
    q = torch.tensor(rng.standard_normal((1, 8, 2, 16)).astype(np.float32))
    assert torch.equal(ops.flash_attention(q, q, q, causal=True, window=3),
                       flash_attention_ref(q, q, q, causal=True, window=3))
    x = torch.tensor(rng.standard_normal((2, 8, 16)).astype(np.float32))
    cs = torch.cumsum(-torch.rand((2, 8, 1)), dim=1)
    S = torch.zeros((2, 16, 16))
    for got, want in zip(ops.ssd_chunk(x, cs, x, x, S), ssd_chunk_ref(x, cs, x, x, S)):
        assert torch.equal(got, want)
    _, S_c = ops.ssd_chunk(x, cs, x, x, None, outputs="state")
    assert torch.equal(S_c, ssd_chunk_ref(x, cs, x, x, S)[1])
    words = ops.build_merge_packed(Nt, ids, ef, eb)[None]
    for got, want in zip(ops.unpack_columns(words[:, 0, 0], words, lengths=(7,), ell=5),
                         unpack_columns_ref(words[:, 0, 0], words, lengths=(7,), ell=5)):
        assert torch.equal(got, want)
    meta = [torch.empty((2,) + tuple(t.shape[1:]), dtype=t.dtype, device="meta")
            for t in (words[:, 0, 0], words)]
    for lengths in ((7,), (7, 0)):           # one output, and a tuple of them, modeled
        got = ops.unpack_columns(*meta, lengths=lengths, ell=5)
        assert [tuple(t.shape) for t in got] == [(n + 1, 5) for n in lengths]
    assert [k.launches for k in ops.KERNELS] == [0] * 8
    assert ops.launch_counts() == {k.name: 0 for k in ops.KERNELS}
    assert {k.plain for k in ops.KERNELS} == {
        reach_chunk_product_ref, build_merge_packed_ref, semiring_matmul_ref,
        packed_reach_chunk_product_ref, sparse_reach_rows_ref, flash_attention_ref,
        ssd_chunk_ref, unpack_columns_ref,
    }


def test_kernel_build_needs_a_toolkit(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        ops._nvcc()


def test_kernel_sources_are_the_ones_the_wrappers_build():
    for kernel in ops.KERNELS:
        src = ops.CSRC / f"{kernel._launcher.SOURCE}.cu"
        text = src.read_text()
        assert "Replaces: src/repro/kernels/" in text
        for fn in kernel._launcher.SIGNATURES:
            assert 'extern "C"' in text and fn in text


def _naive_prefix(xs):
    out = [xs[0]]
    for x in xs[1:]:
        out.append(semiring_matmul_ref(x, out[-1]))
    return torch.stack(out)


@pytest.mark.parametrize("c", [1, 2, 3, 5, 8, 13])
def test_associative_prefix_equals_serial_fold(c):
    rng = np.random.default_rng(c)
    xs = torch.tensor(_bool(rng, (c, 32, 32), 0.08))
    got = associative_prefix(lambda later, earlier: semiring_matmul_ref(later, earlier), xs)
    assert torch.equal(got, _naive_prefix(xs))


@pytest.mark.parametrize("c", [1, 4, 7])
def test_exclusive_entries_equals_serial_replay(c):
    rng = np.random.default_rng(c + 100)
    xs = torch.tensor(_bool(rng, (c, 32, 32), 0.1))
    init = torch.tensor(_bool(rng, (32,), 0.5))
    got = exclusive_entries(
        semiring_matmul_ref,
        lambda m, v: port_backend.matvec(semiring_matmul_ref, m, v),
        xs,
        init,
    )
    state = init
    for i in range(c):
        assert torch.equal(got[i], state)
        state = torch.clamp(xs[i] @ state, max=1.0)


def test_cuda_backend_phases_on_cpu_tensors_equal_torch_backend():
    """The cuda backend's glue (reshapes, batching, join) on CPU tensors, where
    every wrapper takes its plain version."""
    N, I, F = _tables("x(yz|y)*z?")
    rng = np.random.default_rng(5)
    chunks = torch.tensor(rng.integers(0, N.shape[0], size=(2, 4, 6)).astype(np.int32))
    Nt, It, Ft = torch.tensor(N), torch.tensor(I), torch.tensor(F)
    outs = []
    for be in (port_backend.TorchBackend(), port_backend.CudaBackend()):
        P = be.reach(Nt, chunks)
        Jf, Jb = be.join(P, It, Ft)
        col0 = be.start_column(P, It, Jb[..., 0, :])
        outs.append((P, Jf, Jb, col0, be.build_merge_packed(Nt, chunks, Jf, Jb)))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
