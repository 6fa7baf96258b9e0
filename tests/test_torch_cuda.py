"""repro_torch's CUDA kernels on the card: each kernel against its plain
PyTorch version, and the ``cuda`` backend against the ``torch`` backend.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without one.
The file imports no JAX, so it runs on a host that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance is zero throughout: OR-AND arithmetic on {0,1} is exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import Parser, ParserConfig, ParserEngine  # noqa: E402
from repro_torch.core.matrices import build_matrices  # noqa: E402
from repro_torch.core.segments import compute_segments  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import build_merge_packed_ref  # noqa: E402

pytestmark = pytest.mark.cuda

PATTERNS = ["(ab|a)*", "(a|b|ab)+", "x(yz|y)*z?", "(a|b)*a(a|b){5}"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _random_table(rng, n_classes, lp, density):
    N = (rng.random((n_classes + 1, lp, lp)) < density).astype(np.float32)
    N[-1] = np.eye(lp, dtype=np.float32)          # PAD = identity
    return N


def _pattern_table(pattern, dev):
    eng = ParserEngine(build_matrices(compute_segments(pattern)), backend="cuda", device=dev)
    return eng.tables


@pytest.mark.parametrize("shape", [
    (3, 64, 64, 64), (5, 288, 288, 288), (2, 96, 40, 1), (7, 1, 288, 288), (1, 130, 70, 33),
])
@pytest.mark.parametrize("density", [0.02, 0.3])
def test_semiring_matmul_kernel_equals_plain(dev, shape, density):
    b, m, k, n = shape
    rng = np.random.default_rng(m * 7 + n)
    a = torch.tensor((rng.random((b, m, k)) < density).astype(np.float32), device=dev)
    bb = torch.tensor((rng.random((b, k, n)) < density).astype(np.float32), device=dev)
    got = ops.semiring_matmul(a, bb)
    torch.cuda.synchronize()
    assert torch.equal(got, ops.semiring_matmul.plain(a, bb))


@pytest.mark.parametrize("lp,density", [(64, 0.05), (288, 0.01), (512, 0.004), (32, 0.2)])
@pytest.mark.parametrize("k", [0, 1, 7, 33])
def test_reach_kernel_equals_plain_random_tables(dev, lp, density, k):
    rng = np.random.default_rng(lp + k)
    N = torch.tensor(_random_table(rng, 5, lp, density), device=dev)
    ids = torch.tensor(rng.integers(0, 6, size=(9, k)), dtype=torch.int32, device=dev)
    got = ops.reach_chunk_product(N, ids)
    torch.cuda.synchronize()
    assert torch.equal(got, ops.reach_chunk_product.plain(N, ids))


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("k", [1, 8, 21])
def test_kernels_equal_plain_on_pattern_tables(dev, pattern, k):
    t = _pattern_table(pattern, dev)
    rng = np.random.default_rng(k)
    C = 6
    ids = torch.tensor(rng.integers(0, t.N.shape[0], size=(C, k)), dtype=torch.int32, device=dev)
    ef = torch.tensor((rng.random((C, t.ell_pad)) < 0.5).astype(np.float32), device=dev)
    eb = torch.tensor((rng.random((C, t.ell_pad)) < 0.5).astype(np.float32), device=dev)
    P = ops.reach_chunk_product(t.N, ids)
    M = ops.build_merge_packed(t.N, ids, ef, eb)
    torch.cuda.synchronize()
    assert torch.equal(P, ops.reach_chunk_product.plain(t.N, ids))
    assert torch.equal(M, build_merge_packed_ref(t.N, ids, ef, eb))


@pytest.mark.parametrize("lp,density", [(64, 0.05), (288, 0.01), (1024, 0.002)])
@pytest.mark.parametrize("k", [0, 5, 40])
def test_build_merge_kernel_equals_plain_random_tables(dev, lp, density, k):
    rng = np.random.default_rng(lp * 3 + k)
    N = torch.tensor(_random_table(rng, 4, lp, density), device=dev)
    C = 4
    ids = torch.tensor(rng.integers(0, 5, size=(C, k)), dtype=torch.int32, device=dev)
    ef = torch.tensor((rng.random((C, lp)) < 0.3).astype(np.float32), device=dev)
    eb = torch.tensor((rng.random((C, lp)) < 0.3).astype(np.float32), device=dev)
    got = ops.build_merge_packed(N, ids, ef, eb)
    torch.cuda.synchronize()
    assert torch.equal(got, build_merge_packed_ref(N, ids, ef, eb))


def test_wrappers_count_launches_on_the_card_only(dev):
    rng = np.random.default_rng(0)
    a = (rng.random((2, 32, 32)) < 0.2).astype(np.float32)
    ops.reset_launches()
    ops.semiring_matmul(torch.tensor(a), torch.tensor(a))           # CPU: plain
    assert ops.semiring_matmul.launches == 0
    ops.semiring_matmul(torch.tensor(a, device=dev), torch.tensor(a, device=dev))
    assert ops.semiring_matmul.launches == 1


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    a = torch.zeros((2, 32, 32), device=dev)
    with pytest.raises(ValueError):
        ops.semiring_matmul(a.double(), a.double())
    with pytest.raises(ValueError):
        ops.semiring_matmul(a.transpose(1, 2), a)                    # not contiguous
    with pytest.raises(ValueError):
        ops.semiring_matmul(a, a.cpu())                              # mixed devices
    N = torch.eye(32, device=dev).expand(3, 32, 32).contiguous()
    with pytest.raises(ValueError):
        ops.reach_chunk_product(N, torch.full((1, 4), 3, dtype=torch.int32, device=dev))
    with pytest.raises(ValueError):
        ops.reach_chunk_product(N, torch.zeros((1, 4), dtype=torch.int64, device=dev))


@pytest.mark.parametrize("pattern", PATTERNS)
def test_cuda_backend_equals_torch_backend(dev, pattern):
    cfg = ParserConfig(regex=pattern, n_chunks=4)
    p_cuda = Parser(cfg, device=dev)
    p_torch = Parser(cfg.replace(backend="torch"), device=dev)
    rng = np.random.default_rng(len(pattern))
    texts = [b"", b"a", b"ab" * 9, b"xyzyyz", b"ba" * 40 + b"~"]
    texts += [bytes(rng.choice(list(b"abxyz"), size=int(n))) for n in (3, 17, 100)]
    for got, want in zip(p_cuda.parse_batch(texts), p_torch.parse_batch(texts)):
        assert got.ok == want.ok
        assert np.array_equal(got.forest.pack(), want.forest.pack())
    assert p_cuda.backend_name == "cuda"
