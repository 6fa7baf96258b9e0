"""repro_torch's CUDA kernels on the card: each kernel against its plain
PyTorch version, the ``cuda``, ``packed`` and ``sparse`` kernel backends
against the ``torch`` backend (parses, and streams with splices), the
grouped build&merge of a stream's ``result()`` against per-leaf launches,
one reach launch a stream-service step, 1-rank mesh parses against the
non-mesh parse, the LM prefill through K6 and K7 against the same model on
its plain versions, and ``phase_static_cost``'s modeled launches against a
real parse's.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without one.
The file imports no JAX, so it runs on a host that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The parser's tolerance is zero: OR-AND arithmetic on {0,1} is exact.  The LM
kernels are float and use the reference's bounds (``tests/test_kernels.py``):
K6 atol 3e-5 in f32 and 3e-2 in bf16, K7 rtol = atol = 2e-4.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import Parser, ParserConfig, ParserEngine  # noqa: E402
from repro_torch.core.backend import SparseBackend  # noqa: E402
from repro_torch.core.matrices import (  # noqa: E402
    SPARSE_EMPTY,
    build_matrices,
    pack_transition_table_torch,
    sparse_init_rows,
)
from repro_torch.core.segments import compute_segments  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import build as build_launcher  # noqa: E402
from repro_torch.kernels import packed_reach as packed_launcher  # noqa: E402
from repro_torch.kernels import reach as reach_launcher  # noqa: E402
from repro_torch.kernels import ssd_chunk as ssd_launcher  # noqa: E402
from repro_torch.kernels.checks import MAX_SMEM_BYTES, check_class_ids  # noqa: E402
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


# the join's automata: TRAFFIC (ℓp = 64) and e125 (ℓp = 288), as chip_smoke.py runs them
JOIN_PATTERNS = {
    "traffic": r"((GET|POST|PUT) /([a-z0-9]|/)* ([0-9]{3}) (ok|err|-)\n)+",
    "e125": "(a|b)*a(a|b){125}",
}


def _join_operands(dev, which, source, density):
    """The first join level's operands (P[1:], P[:-1]) of 1024 chunk products:
    real products of random class ids (``source='products'``) or random
    {0,1} matrices of ``density``; plus {0,1} vectors for the mat-vecs."""
    t = _pattern_table(JOIN_PATTERNS[which], dev)
    lp = t.ell_pad
    rng = np.random.default_rng(lp)
    if source == "products":
        ids = torch.tensor(rng.integers(0, t.N.shape[0], size=(1024, 8)), dtype=torch.int32,
                           device=dev)
        P = ops.reach_chunk_product.plain(t.N, ids)
    else:
        P = torch.tensor((rng.random((1024, lp, lp)) < density).astype(np.float32), device=dev)
    v = torch.tensor((rng.random((1023, lp)) < 0.5).astype(np.float32), device=dev)
    return P[1:].contiguous(), P[:-1].contiguous(), v


@pytest.mark.parametrize("which", ["traffic", "e125"])
@pytest.mark.parametrize("source,density", [("products", None), ("random", 0.02),
                                            ("random", 0.5)])
def test_semiring_matmul_at_the_join_shapes(dev, which, source, density):
    """K3 bit for bit at the join's real shapes: the first level's compose
    (1023, ℓp, ℓp)², the forward act (1023, ℓp, ℓp)·(1023, ℓp, 1) and the
    backward act (1023, 1, ℓp)·(1023, ℓp, ℓp)."""
    a, b, v = _join_operands(dev, which, source, density)
    for x, y in ((a, b), (a, v.unsqueeze(-1)), (v.unsqueeze(-2), b)):
        got = ops.semiring_matmul(x, y)
        torch.cuda.synchronize()
        assert torch.equal(got, ops.semiring_matmul.plain(x, y))


@pytest.mark.parametrize("shape", [
    (1, 1, 1, 1), (2, 1, 64, 1), (600, 64, 32, 64), (3, 96, 1000, 96), (2, 97, 288, 95),
    (4, 64, 33, 130), (1, 1, 5, 7), (9, 5, 3, 1), (300, 288, 288, 288),
])
def test_semiring_matmul_ragged_and_ring_wrapping_shapes(dev, shape):
    """Ragged edges in every dimension, k slices wrapping the 4-stage ring
    many times (k = 1000: 32 slices), and more work items than resident
    blocks (persistent blocks walk several)."""
    b, m, k, n = shape
    rng = np.random.default_rng(b + m + k + n)
    a = torch.tensor((rng.random((b, m, k)) < 0.1).astype(np.float32), device=dev)
    bb = torch.tensor((rng.random((b, k, n)) < 0.1).astype(np.float32), device=dev)
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


def _reach_variants(n_classes, lp):
    """Every K1 kernel that takes ``n_classes`` (ℓp, ℓp) tables: each group
    width whose table fits, and the strip kernel."""
    out = []
    if lp // 32 <= reach_launcher.MAX_GROUP_W:
        out += [("group", g) for g in reach_launcher.GROUPS
                if reach_launcher.group_table_bytes(n_classes, lp, g) <= MAX_SMEM_BYTES]
    return out + [("strip", 0)]


# (ℓp, classes incl. PAD, density): TRAFFIC's and e125's widths, a 512-wide
# table (one class for g = 4), the strip kernel's widest, and 300 classes
# (ids above 255)
REACH_TABLES = [(32, 300, 0.05), (64, 19, 0.03), (288, 4, 0.005), (512, 1, 0.002),
                (512, 3, 0.002), (928, 3, 0.001)]
REACH_CASES = [(lp, a, d, variant) for lp, a, d in REACH_TABLES
               for variant in _reach_variants(a, lp)]


@pytest.mark.parametrize("lp,n_classes,density,variant", REACH_CASES)
@pytest.mark.parametrize("k", [0, 1, 7, 33])
def test_reach_kernel_every_plan_variant(dev, monkeypatch, lp, n_classes, density, variant, k):
    """K1 bit for bit in each kernel the plan can choose, forced through the
    plan: random tables with PAD (the last class) the identity, chunks that
    end in PAD, ids above 255 where there are that many classes."""
    monkeypatch.setattr(reach_launcher, "plan", lambda n, l, lw=None: variant)
    rng = np.random.default_rng(lp + n_classes + k)
    N = (rng.random((n_classes, lp, lp)) < density).astype(np.float32)
    if n_classes > 1:
        N[-1] = np.eye(lp, dtype=np.float32)                    # PAD = identity
    N = torch.tensor(N, device=dev)
    C = 5
    ids = rng.integers(0, n_classes, size=(C, k))
    ids[: C // 2, k // 2:] = n_classes - 1                     # PAD-ended chunks
    ids = torch.tensor(ids, dtype=torch.int32, device=dev)
    ops.reset_launches()
    got = ops.reach_chunk_product(N, ids)
    torch.cuda.synchronize()
    assert ops.reach_chunk_product.launches == 1
    assert torch.equal(got, ops.reach_chunk_product.plain(N, ids))


@pytest.mark.parametrize("which,variant", [("traffic", ("group", 4)), ("traffic", ("strip", 0)),
                                           ("e125", ("group", 4)), ("e125", ("group", 2)),
                                           ("e125", ("strip", 0))])
def test_reach_kernel_long_chunks(dev, monkeypatch, which, variant):
    """k = 8192 steps (TRAFFIC's chunk length at 8 MiB) on the repository's
    automata, random class ids, the last chunk ending in PAD."""
    t = _pattern_table(JOIN_PATTERNS[which], dev)
    monkeypatch.setattr(reach_launcher, "plan", lambda n, l, lw=None: variant)
    rng = np.random.default_rng(8192)
    ids = rng.integers(0, t.N.shape[0] - 1, size=(3, 8192))
    ids[-1, 5000:] = t.N.shape[0] - 1
    ids = torch.tensor(ids, dtype=torch.int32, device=dev)
    got = ops.reach_chunk_product(t.N, ids)
    torch.cuda.synchronize()
    assert torch.equal(got, ops.reach_chunk_product.plain(t.N, ids))


def test_reach_plan_at_the_parse_shapes(dev):
    """The plan's own choice for TRAFFIC and e125: the group kernel, g = 4."""
    for which in ("traffic", "e125"):
        t = _pattern_table(JOIN_PATTERNS[which], dev)
        assert reach_launcher.plan(t.N.shape[0], t.ell_pad) == ("group", 4)


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


def _build_variants(n_classes, lp):
    """Every K2 kernel that takes ``n_classes`` (ℓp, ℓp) tables: at each
    group width, the walk with both tables resident and with the backward one
    rebuilt, each at the longest round that fits one warp's ring, and at an
    odd 7-step round (g = 4); then the row kernel."""
    out = []
    if lp // 32 <= build_launcher.MAX_GROUP_W:
        L = build_launcher.LANES
        for g in build_launcher.GROUPS:
            table = build_launcher.table_bytes(n_classes, lp, g, L)
            stride = build_launcher.class_stride(lp, g, L)
            for both in (True, False):
                fits = [rs for rs in build_launcher.ROUNDS + (7,) if (2 if both else 1) * table
                        + build_launcher.ring_bytes(lp, L, rs) <= MAX_SMEM_BYTES]
                out += [build_launcher.Plan("walk", g, L, rs, both, stride)
                        for rs in fits[:1] + ([7] if g == 4 and 7 in fits else [])]
    return out + [build_launcher.ROWS]


BUILD_K = (1, 65, 8192)
# (ℓp, classes incl. PAD): at ℓp = 512 one class and PAD, so that the walk fits
BUILD_TABLES = ((32, 4), (64, 4), (96, 4), (288, 4), (512, 2), (1024, 4))
BUILD_CASES = [(lp, a, k, variant) for lp, a in BUILD_TABLES for k in BUILD_K
               for variant in _build_variants(a, lp)]
_build_inputs: dict = {}


def _build_case(lp, n_classes, k, dev):
    """Inputs and the plain version's columns for ℓp and k, made once: random
    classes and PAD (the last, the identity), 9 chunks (not a multiple of the
    16, 8 or 4 chunks a warp walks), a padded bucket's tail, an all-PAD
    chunk."""
    if (lp, k) not in _build_inputs:
        rng = np.random.default_rng(lp * 7 + k)
        N = torch.tensor(_random_table(rng, n_classes - 1, lp, 3.0 / lp), device=dev)
        C = 9
        ids = rng.integers(0, n_classes, size=(C, k))
        ids[C // 2:, k // 2:] = n_classes - 1
        ids[-1] = n_classes - 1
        ids = torch.tensor(ids, dtype=torch.int32, device=dev)
        ef = torch.tensor((rng.random((C, lp)) < 0.3).astype(np.float32), device=dev)
        eb = torch.tensor((rng.random((C, lp)) < 0.3).astype(np.float32), device=dev)
        args = (N, ids, ef, eb)
        _build_inputs.clear()                      # one shape's inputs at a time
        _build_inputs[(lp, k)] = (args, build_merge_packed_ref(*args))
    return _build_inputs[(lp, k)]


@pytest.mark.parametrize("lp,n_classes,k,variant", BUILD_CASES)
def test_build_merge_kernel_every_plan_variant(dev, monkeypatch, lp, n_classes, k, variant):
    """K2 bit for bit in each kernel the plan can choose, forced through
    ``build.plan``, at ℓp from one word to the row kernel's 1024 and k from 1
    to TRAFFIC's 8192 steps."""
    args, want = _build_case(lp, n_classes, k, dev)
    monkeypatch.setattr(build_launcher, "plan", lambda n, l, c, lw=None: variant)
    ops.reset_launches()
    got = ops.build_merge_packed(*args)
    torch.cuda.synchronize()
    assert ops.build_merge_packed.launches == 1
    assert torch.equal(got, want)


def test_build_merge_plan_at_the_parse_shapes(dev):
    """The plan's own choice on TRAFFIC and e125 at 1024 chunks: the walk at
    g = 4, 8 lanes a chunk, both tables and 128-step rounds (TRAFFIC), the
    backward table rebuilt and 64-step rounds (e125)."""
    want = {"traffic": ("walk", 4, 128, True), "e125": ("walk", 4, 64, False)}
    for which, (kind, g, rs, both) in want.items():
        t = _pattern_table(JOIN_PATTERNS[which], dev)
        p = build_launcher.plan(t.N.shape[0], t.ell_pad, 1024)
        assert (p.kernel, p.g, p.lanes, p.round, p.both) == (kind, g, 8, rs, both)


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
    with pytest.raises(ValueError):              # class ids are range-checked on the host
        check_class_ids(np.full((1, 4), 3, dtype=np.int32), N.shape[0])
    with pytest.raises(ValueError):
        ops.reach_chunk_product(N, torch.zeros((1, 4), dtype=torch.int64, device=dev))
    with pytest.raises(ValueError, match="split evenly"):
        ops.reach_chunk_product(N.expand(2, 3, 32, 32).contiguous(),
                                torch.zeros((3, 4), dtype=torch.int32, device=dev))


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


def _packed_table(rng, n_classes, lp, density, dev):
    """Random asymmetric tables, PAD the identity, packed as the packed
    backend packs them (rows = target sets of each source)."""
    N = torch.tensor(_random_table(rng, n_classes, lp, density), device=dev)
    return pack_transition_table_torch(N)


def _feasible_r0(rng, C, S, lp, dev):
    """R0 (C, S, W): S - 1 random distinct start states per chunk, ascending,
    and one unused slot (S = 1: one start state)."""
    idx = np.full((C, S), SPARSE_EMPTY, dtype=np.int32)
    n = max(S - 1, 1)
    for c in range(C):
        idx[c, :n] = np.sort(rng.choice(lp, size=n, replace=False))
    return sparse_init_rows(torch.tensor(idx, device=dev), lp).contiguous()


# k: the walk's id rounds (32 steps a round at 32 rows or more, 32 / cpw
# below) end just before, at and after a round's edge
WORD_STEPS = [0, 1, 9, 31, 32, 33, 40, 65]


@pytest.mark.parametrize("lp", [64, 288, 320])
@pytest.mark.parametrize("density", [0.01, 0.1, 0.5])
@pytest.mark.parametrize("k", WORD_STEPS)
def test_packed_reach_kernel_equals_plain_random_tables(dev, lp, density, k):
    rng = np.random.default_rng(lp + k)
    Np = _packed_table(rng, 5, lp, density, dev)
    ids = torch.tensor(rng.integers(0, 6, size=(7, k)), dtype=torch.int32, device=dev)
    got = ops.packed_reach_chunk_product(Np, ids)
    torch.cuda.synchronize()
    assert torch.equal(got, ops.packed_reach_chunk_product.plain(Np, ids))


@pytest.mark.parametrize("lp,S", [(64, 8), (288, 256), (320, 16), (320, 320), (64, 1), (64, 13),
                                  (64, 33), (288, 8)])
@pytest.mark.parametrize("density", [0.01, 0.1, 0.5])
@pytest.mark.parametrize("k", WORD_STEPS)
def test_sparse_reach_kernel_equals_plain_random_tables(dev, lp, S, density, k):
    rng = np.random.default_rng(lp + S + k)
    Np = _packed_table(rng, 5, lp, density, dev)
    ids = torch.tensor(rng.integers(0, 6, size=(7, k)), dtype=torch.int32, device=dev)
    R0 = _feasible_r0(rng, 7, S, lp, dev)
    got = ops.sparse_reach_rows(Np, ids, R0)
    torch.cuda.synchronize()
    assert torch.equal(got, ops.sparse_reach_rows.plain(Np, ids, R0))


def _word_variants(n_classes, lp, rows):
    """Every K4 / K5 kernel that takes ``n_classes`` (ℓp, W) tables folding
    ``rows`` rows a chunk: each group width whose walk table fits, and the
    fold kernel."""
    out = []
    if lp // 32 <= packed_launcher.MAX_GROUP_W:
        out += [("walk", g) for g in packed_launcher.GROUPS
                if packed_launcher.walk_table_bytes(n_classes, lp, rows, g) <= MAX_SMEM_BYTES]
    return out + [("fold", 0)]


# (ℓp, classes incl. PAD, rows: None for K4's ℓp identity rows, else K5's S)
WORD_TABLES = [(64, 19, None), (64, 19, 1), (64, 19, 8), (64, 19, 13), (64, 19, 33),
               (288, 4, None), (288, 4, 256), (288, 4, 8), (512, 3, None), (512, 2, 8),
               (32, 300, 1)]
WORD_CASES = [(lp, a, rows, variant) for lp, a, rows in WORD_TABLES
              for variant in _word_variants(a, lp, lp if rows is None else rows)]


@pytest.mark.parametrize("lp,n_classes,rows,variant", WORD_CASES)
@pytest.mark.parametrize("k", [1, 31, 32, 33, 65])
def test_word_reach_kernels_every_plan_variant(dev, monkeypatch, lp, n_classes, rows, variant, k):
    """K4 (rows None) or K5 bit for bit in each kernel the plan can choose,
    forced through ``packed_reach.plan``: random tables with PAD (the last
    class) the identity, a padded bucket (chunks that end in PAD), an all-PAD
    chunk, 9 chunks (not a multiple of the 4, 2 or 32 chunks a warp packs at
    S = 8, 13, 1), ids above 255 where there are that many classes."""
    monkeypatch.setattr(packed_launcher, "plan", lambda n, l, r: variant)
    rng = np.random.default_rng(lp + n_classes + k + (rows or 0))
    C = 9
    Np = _packed_table(rng, n_classes - 1, lp, 4.0 / lp, dev)
    ids = rng.integers(0, n_classes, size=(C, k))
    ids[C // 2:, k // 2:] = n_classes - 1                      # a padded bucket's tail
    ids[-1] = n_classes - 1                                    # an all-PAD chunk
    ids = torch.tensor(ids, dtype=torch.int32, device=dev)
    ops.reset_launches()
    if rows is None:
        got = ops.packed_reach_chunk_product(Np, ids)
        want = ops.packed_reach_chunk_product.plain(Np, ids)
        launches = ops.packed_reach_chunk_product.launches
    else:
        R0 = _feasible_r0(rng, C, rows, lp, dev)
        got = ops.sparse_reach_rows(Np, ids, R0)
        want = ops.sparse_reach_rows.plain(Np, ids, R0)
        launches = ops.sparse_reach_rows.launches
    torch.cuda.synchronize()
    assert launches == 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("which", ["traffic", "e125"])
@pytest.mark.parametrize("kernel", ["packed", "sparse"])
@pytest.mark.parametrize("variant", [("walk", 4), ("walk", 2), ("fold", 0)])
def test_word_reach_kernels_long_chunks(dev, monkeypatch, which, kernel, variant):
    """k = 8192 steps (TRAFFIC's chunk length at 8 MiB) on the repository's
    automata in every plan variant: 5 chunks (not a multiple of TRAFFIC's 4
    chunks a warp), random class ids, the last chunk ending in PAD, K5's
    rows the sparse backend's own feasible rows."""
    t = _pattern_table(JOIN_PATTERNS[which], dev)
    monkeypatch.setattr(packed_launcher, "plan", lambda n, l, r: variant)
    Np = pack_transition_table_torch(t.N)
    rng = np.random.default_rng(8192)
    ids = rng.integers(0, t.N.shape[0] - 1, size=(5, 8192))
    ids[-1, 5000:] = t.N.shape[0] - 1
    ids = torch.tensor(ids, dtype=torch.int32, device=dev)
    if kernel == "packed":
        got = ops.packed_reach_chunk_product(Np, ids)
        want = ops.packed_reach_chunk_product.plain(Np, ids)
    else:
        sparse = SparseBackend()
        sparse.bind_tables(t)
        R0 = sparse_init_rows(sparse.feasible_rows(t.N, ids), t.ell_pad).contiguous()
        got = ops.sparse_reach_rows(Np, ids, R0)
        want = ops.sparse_reach_rows.plain(Np, ids, R0)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_word_reach_plan_at_the_parse_shapes(dev):
    """The plan's own choice for K4 and K5 on TRAFFIC and e125: the walk
    kernel, g = 4."""
    for which in ("traffic", "e125"):
        t = _pattern_table(JOIN_PATTERNS[which], dev)
        sparse = SparseBackend()
        sparse.bind_tables(t)
        for rows in (t.ell_pad, sparse._width):
            assert packed_launcher.plan(t.N.shape[0], t.ell_pad, rows) == ("walk", 4)


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("k", [1, 8, 21])
def test_packed_kernels_equal_plain_on_pattern_tables(dev, pattern, k):
    t = _pattern_table(pattern, dev)
    Np = pack_transition_table_torch(t.N)
    rng = np.random.default_rng(k)
    C = 6
    ids = torch.tensor(rng.integers(0, t.N.shape[0], size=(C, k)), dtype=torch.int32, device=dev)
    sparse = SparseBackend()
    sparse.bind_tables(t)
    R0 = sparse_init_rows(sparse.feasible_rows(t.N, ids), t.ell_pad).contiguous()
    P = ops.packed_reach_chunk_product(Np, ids)
    R = ops.sparse_reach_rows(Np, ids, R0)
    torch.cuda.synchronize()
    assert torch.equal(P, ops.packed_reach_chunk_product.plain(Np, ids))
    assert torch.equal(R, ops.sparse_reach_rows.plain(Np, ids, R0))


def test_packed_wrappers_count_launches_on_the_card_only(dev):
    rng = np.random.default_rng(1)
    Np = _packed_table(rng, 3, 64, 0.1, torch.device("cpu"))
    ids = torch.tensor(rng.integers(0, 4, size=(2, 5)), dtype=torch.int32)
    R0 = _feasible_r0(rng, 2, 8, 64, torch.device("cpu"))
    ops.reset_launches()
    ops.packed_reach_chunk_product(Np, ids)
    ops.sparse_reach_rows(Np, ids, R0)
    assert ops.packed_reach_chunk_product.launches == 0 and ops.sparse_reach_rows.launches == 0
    ops.packed_reach_chunk_product(Np.to(dev), ids.to(dev))
    ops.sparse_reach_rows(Np.to(dev), ids.to(dev), R0.to(dev))
    assert ops.packed_reach_chunk_product.launches == 1 and ops.sparse_reach_rows.launches == 1


def test_packed_wrappers_refuse_what_the_kernels_do_not_take(dev):
    ids = torch.zeros((1, 4), dtype=torch.int32, device=dev)
    too_wide = torch.zeros((2, 992, 31), dtype=torch.int32, device=dev)   # ℓp > 960
    with pytest.raises(ValueError, match="shared memory"):
        ops.packed_reach_chunk_product(too_wide, ids)
    Np = torch.zeros((2, 64, 2), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        ops.packed_reach_chunk_product(Np.float(), ids)                    # not words
    with pytest.raises(ValueError):
        ops.packed_reach_chunk_product(torch.zeros((2, 64, 3), dtype=torch.int32, device=dev), ids)
    with pytest.raises(ValueError):              # class ids are range-checked on the host
        check_class_ids(np.full((1, 4), 2, dtype=np.int32), Np.shape[0])
    with pytest.raises(ValueError, match="exceed"):
        ops.sparse_reach_rows(Np, ids, torch.zeros((1, 65, 2), dtype=torch.int32, device=dev))
    with pytest.raises(ValueError):
        ops.sparse_reach_rows(Np, ids, torch.zeros((1, 8, 3), dtype=torch.int32, device=dev))
    with pytest.raises(ValueError):
        ops.sparse_reach_rows(Np, ids, torch.zeros((2, 8, 2), dtype=torch.int32, device=dev))


# ---------------------------------------------------------------- tenant axis
#
# K1, K2, K4 and K5 over a stack of T tenant tables (the fleet's bucket
# dispatch): each chunk reads its own tenant's table, one launch for all.

TENANTS = (1, 3, 32)


def _tenant_case(rng, T, n_classes, lp, Ct, k, dev):
    """T random tables (PAD, the last class, the identity) and T runs of Ct
    chunks: a padded bucket's tail and an all-PAD chunk in each run."""
    N = (rng.random((T, n_classes, lp, lp)) < 3.0 / lp).astype(np.float32)
    N[:, -1] = np.eye(lp, dtype=np.float32)
    ids = rng.integers(0, n_classes, size=(T, Ct, k))
    ids[:, Ct // 2:, k // 2:] = n_classes - 1
    ids[:, -1] = n_classes - 1
    return (torch.tensor(N, device=dev),
            torch.tensor(ids.reshape(T * Ct, k), dtype=torch.int32, device=dev))


TENANT_REACH = [(lp, a, v) for lp, a in ((64, 19), (288, 4)) for v in _reach_variants(a, lp)]


@pytest.mark.parametrize("lp,n_classes,variant", TENANT_REACH)
@pytest.mark.parametrize("T", TENANTS)
def test_reach_kernel_tenant_axis_every_plan_variant(dev, monkeypatch, lp, n_classes, variant, T):
    """K1 over T tenant tables in one launch, bit for bit the plain version,
    in each kernel the plan can choose (the strip fallback included)."""
    monkeypatch.setattr(reach_launcher, "plan", lambda n, l, lw=None: variant)
    N, ids = _tenant_case(np.random.default_rng(lp + T), T, n_classes, lp, 5, 33, dev)
    ops.reset_launches()
    got = ops.reach_chunk_product(N, ids)
    torch.cuda.synchronize()
    assert ops.reach_chunk_product.launches == 1
    assert torch.equal(got, ops.reach_chunk_product.plain(N, ids))


TENANT_BUILD = [(lp, 4, v) for lp in (64, 288) for v in _build_variants(4, lp)]


@pytest.mark.parametrize("lp,n_classes,variant", TENANT_BUILD)
@pytest.mark.parametrize("T", TENANTS)
def test_build_merge_kernel_tenant_axis_every_plan_variant(dev, monkeypatch, lp, n_classes,
                                                           variant, T):
    """K2 over T tenant tables in one launch: 9 chunks a tenant (not a
    multiple of the 4 a warp walks, so a warp's chunks stay one tenant's),
    in each walk variant and the row fallback."""
    monkeypatch.setattr(build_launcher, "plan", lambda n, l, c, lw=None: variant)
    rng = np.random.default_rng(lp * 3 + T)
    N, ids = _tenant_case(rng, T, n_classes, lp, 9, 65, dev)
    ef = torch.tensor((rng.random((ids.shape[0], lp)) < 0.3).astype(np.float32), device=dev)
    eb = torch.tensor((rng.random((ids.shape[0], lp)) < 0.3).astype(np.float32), device=dev)
    ops.reset_launches()
    got = ops.build_merge_packed(N, ids, ef, eb)
    torch.cuda.synchronize()
    assert ops.build_merge_packed.launches == 1
    assert torch.equal(got, build_merge_packed_ref(N, ids, ef, eb))


TENANT_WORDS = [(lp, a, rows, v) for lp, a, rows in ((64, 19, None), (64, 19, 8), (288, 4, 8))
                for v in _word_variants(a, lp, lp if rows is None else rows)]


@pytest.mark.parametrize("lp,n_classes,rows,variant", TENANT_WORDS)
@pytest.mark.parametrize("T", TENANTS)
def test_word_reach_kernels_tenant_axis_every_plan_variant(dev, monkeypatch, lp, n_classes,
                                                           rows, variant, T):
    """K4 (rows None) or K5 over T tenant tables in one launch: 9 chunks a
    tenant, so that the chunks a warp packs at S = 8 straddle no tenant, in
    each walk variant and the fold fallback."""
    monkeypatch.setattr(packed_launcher, "plan", lambda n, l, r: variant)
    rng = np.random.default_rng(lp + T + (rows or 0))
    N, ids = _tenant_case(rng, T, n_classes, lp, 9, 33, dev)
    Np = pack_transition_table_torch(N)
    ops.reset_launches()
    if rows is None:
        kernel, args = ops.packed_reach_chunk_product, (Np, ids)
    else:
        kernel, args = ops.sparse_reach_rows, (Np, ids, _feasible_r0(rng, ids.shape[0], rows, lp, dev))
    got = kernel(*args)
    torch.cuda.synchronize()
    assert kernel.launches == 1
    assert torch.equal(got, kernel.plain(*args))


# ----------------------------------------------------------- live window
#
# K1's group kernel and K2's walk over a stack padded past its live states
# (``kernels/window.py``): they walk the ℓ' live states and write the padded
# part from the block algebra, bit for bit the plain versions over all ℓp.


def _window_case(rng, T, lp, ell, n_real, n_ident, Ct, k, dev):
    """T block-structured tables as the fleet pads them: ``n_real`` random
    classes inside [0, ell)², then ``n_ident`` identities over all ℓp (PAD
    last); T runs of Ct chunks: random ids, all-PAD chunks, chunks whose one
    real step is the first or the last, chunks of identity classes alone."""
    A1 = n_real + n_ident
    N = np.zeros((T, A1, lp, lp), dtype=np.float32)
    N[:, :n_real, :ell, :ell] = rng.random((T, n_real, ell, ell)) < 3.0 / ell
    N[:, n_real:] = np.eye(lp, dtype=np.float32)
    ids = rng.integers(0, A1, size=(T, Ct, k))
    if k:
        ids[:, 1] = A1 - 1
        ids[:, 2] = rng.integers(n_real, A1, size=(T, k))
        ids[:, 3, 1:] = A1 - 1
        ids[:, 4, :-1] = A1 - 1
        ids[:, 3, 0] = ids[:, 4, -1] = 0
    N = torch.tensor(N, device=dev)
    ids = torch.tensor(ids.reshape(T * Ct, k), dtype=torch.int32, device=dev)
    ef = torch.tensor((rng.random((T * Ct, lp)) < 0.5).astype(np.float32), device=dev)
    eb = torch.tensor((rng.random((T * Ct, lp)) < 0.5).astype(np.float32), device=dev)
    return N, ids, ef, eb


# (ℓp, ℓ, real classes, identity classes, k): e125's bucket (ℓ' = 288 of 512),
# narrow and wide windows, ℓp past K1's group kernel and K2's walk (1024)
WINDOW_CASES = [(512, 257, 3, 1, 1024), (512, 257, 3, 1, 33), (512, 20, 2, 2, 65),
                (64, 17, 5, 3, 40), (1024, 100, 3, 1, 9), (512, 480, 1, 1, 7), (512, 257, 3, 1, 0)]


@pytest.mark.parametrize("lp,ell,n_real,n_ident,k", WINDOW_CASES)
@pytest.mark.parametrize("T", (1, 3, 16))
def test_window_kernels_equal_plain_on_block_structured_stacks(dev, lp, ell, n_real, n_ident,
                                                               k, T):
    """K1 and K2 with the stack's window attached: the group kernel and the
    walk at ℓ', one launch each, bit for bit the plain versions at ℓp."""
    from repro_torch.kernels import window

    rng = np.random.default_rng(lp + ell + k + T)
    N, ids, ef, eb = _window_case(rng, T, lp, ell, n_real, n_ident, 6, k, dev)
    win = window.live_window(N)
    assert win.width == -(-ell // 32) * 32
    window.attach(N, win)
    A1 = n_real + n_ident
    assert reach_launcher.plan(A1, lp, win.width)[0] == "group"
    assert build_launcher.plan(A1, lp, ids.shape[0], win.width).kernel == "walk"
    ops.reset_launches()
    got = ops.reach_chunk_product(N, ids)
    cols = ops.build_merge_packed(N, ids, ef, eb)
    torch.cuda.synchronize()
    assert ops.reach_chunk_product.launches == 1 and ops.build_merge_packed.launches == 1
    assert torch.equal(got, ops.reach_chunk_product.plain(N, ids))
    assert torch.equal(cols, build_merge_packed_ref(N, ids, ef, eb))


@pytest.mark.parametrize("T", (1, 3, 16))
def test_window_kernels_on_the_e125_fleet_stack(dev, T):
    """e125's ℓp-512 stack as the fleet compiles it (ℓ' = 288), with ids of
    e125 texts and join-like entries: the group kernel at g = 4 and the
    walk, bit for bit."""
    from repro_torch.core.fleet import _compile_tables
    from repro_torch.kernels import window

    ct = _compile_tables(build_matrices(compute_segments(JOIN_PATTERNS["e125"])), 32)
    N = torch.tensor(np.stack([ct.N] * T), device=dev)
    win = window.live_window(N)
    assert (ct.ell_pad, win.width) == (512, 288)
    window.attach(N, win)
    assert reach_launcher.plan(4, 512, 288) == ("group", 4)
    rng = np.random.default_rng(T)
    ids = rng.integers(0, ct.pad_class, size=(T * 8, 1024))
    ids[1::4, 700:] = ct.pad_class
    ids[2::8] = ct.pad_class
    ids = torch.tensor(ids, dtype=torch.int32, device=dev)
    got = ops.reach_chunk_product(N, ids)
    want = ops.reach_chunk_product.plain(N, ids)
    assert torch.equal(got, want)
    F = torch.tensor(ct.F, device=dev).expand(ids.shape[0], 512).contiguous()
    ef = (want[:, :, 0] > 0).float().contiguous()           # a frontier from state 0
    assert torch.equal(ops.build_merge_packed(N, ids, ef, F),
                       build_merge_packed_ref(N, ids, ef, F))


def test_strip_and_row_kernels_still_serve_tables_without_the_structure(dev):
    """A stack whose padded block is broken (an arc into the last padded
    state) has ℓ' = ℓp: K1 takes the strip kernel and K2 the row kernel,
    bit for bit."""
    from repro_torch.kernels import window

    rng = np.random.default_rng(5)
    N, ids, ef, eb = _window_case(rng, 3, 512, 257, 3, 1, 6, 33, dev)
    N[:, 0, 0, 511] = 1.0
    win = window.live_window(N)
    assert win.width == 512
    window.attach(N, win)
    assert reach_launcher.plan(4, 512, win.width) == ("strip", 0)
    assert build_launcher.plan(4, 512, ids.shape[0], win.width) == build_launcher.ROWS
    assert torch.equal(ops.reach_chunk_product(N, ids), ops.reach_chunk_product.plain(N, ids))
    assert torch.equal(ops.build_merge_packed(N, ids, ef, eb),
                       build_merge_packed_ref(N, ids, ef, eb))


def test_fleet_e125_bucket_takes_the_window_on_the_card(dev):
    """e125 tenants in the fleet's ℓp-512 bucket with a/b tenants beside
    them: each result equals its solo Parser's, one K1 and one K2 launch a
    dispatch, the gathered stack's window 288."""
    from repro_torch import ParserFleet
    from repro_torch.kernels import window

    e125 = JOIN_PATTERNS["e125"]
    cfgs = {f"e{i}": ParserConfig(regex=e125, n_chunks=8) for i in range(3)}
    cfgs["ab"] = ParserConfig(regex="(a|b)*abb", n_chunks=8)
    fleet = ParserFleet(cfgs, device=dev, max_batch=64)
    rng = np.random.default_rng(11)
    items = [(tid, bytes(rng.choice(list(b"ab"), size=int(n))))
             for tid in cfgs for n in (0, 130, 3000)]
    ops.reset_launches()
    got = fleet.parse_batch(items)
    dispatches = fleet.stats()["batches_run"]
    assert ops.reach_chunk_product.launches == dispatches
    assert ops.build_merge_packed.launches == dispatches
    eng = fleet.engine
    runner = eng.runner(eng.tenant("e0").bucket_key)
    assert runner.ell_pad == 512
    rows, _ = runner.host_batch(8, 512, {t: [np.zeros(1, np.int32)] for t in runner.tenant_rows})
    assert window.attached(runner.operands(rows)[0]).width == 288
    solos = {tid: Parser(cfg, device=dev) for tid, cfg in cfgs.items()}
    for (tid, text), r in zip(items, got):
        want = solos[tid].parse(text)
        assert r.ok == want.ok
        assert np.array_equal(r.forest.pack(), want.forest.pack())


FLEET_PATTERNS = ["(a|b)*abb", "(a|b)" * 10, "a" * 40, "a?" * 6, "(a|b|ab)+"]


@pytest.mark.parametrize("setting", [
    {"backend": "cuda"}, {"backend": "packed", "kernel": True},
    {"backend": "sparse", "kernel": True},
])
def test_fleet_on_the_card_equals_solo_parsers(dev, setting):
    """A fleet on the card: every tenant's result equals its solo Parser's,
    and each bucket dispatch makes one reach launch and one K2 launch."""
    from repro_torch import ParserFleet

    cfgs = {f"t{i}": ParserConfig(regex=p, n_chunks=4, **setting)
            for i, p in enumerate(FLEET_PATTERNS)}
    fleet = ParserFleet(cfgs, device=dev, max_batch=64)
    rng = np.random.default_rng(7)
    items = [(tid, bytes(rng.choice(list(b"ab"), size=int(n))))
             for tid in cfgs for n in (0, 3, 40, 200)]
    ops.reset_launches()
    got = fleet.parse_batch(items)
    dispatches = fleet.stats()["batches_run"]
    reach = {"cuda": ops.reach_chunk_product, "packed": ops.packed_reach_chunk_product,
             "sparse": ops.sparse_reach_rows}[setting["backend"]]
    assert reach.launches == dispatches and ops.build_merge_packed.launches == dispatches
    solos = {tid: Parser(cfg, device=dev) for tid, cfg in cfgs.items()}
    for (tid, text), r in zip(items, got):
        want = solos[tid].parse(text)
        assert r.ok == want.ok
        assert np.array_equal(r.forest.pack(), want.forest.pack())


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("setting", [
    {"backend": "packed", "kernel": True}, {"backend": "sparse", "kernel": True},
    {"backend": "sparse", "kernel": True, "feasible_depth": 2},
])
def test_packed_and_sparse_kernel_backends_equal_torch_backend(dev, pattern, setting):
    cfg = ParserConfig(regex=pattern, n_chunks=4, **setting)
    p_kern = Parser(cfg, device=dev)
    p_torch = Parser(ParserConfig(regex=pattern, n_chunks=4, backend="torch"), device=dev)
    rng = np.random.default_rng(len(pattern))
    texts = [b"", b"a", b"ab" * 9, b"xyzyyz", b"ba" * 40 + b"~"]
    texts += [bytes(rng.choice(list(b"abxyz"), size=int(n))) for n in (3, 17, 100)]
    ops.reset_launches()
    for got, want in zip(p_kern.parse_batch(texts), p_torch.parse_batch(texts)):
        assert got.ok == want.ok
        assert np.array_equal(got.forest.pack(), want.forest.pack())
    kernel = ops.sparse_reach_rows if setting["backend"] == "sparse" else ops.packed_reach_chunk_product
    assert kernel.launches >= 1 and ops.reach_chunk_product.launches == 0
    assert ops.build_merge_packed.launches == kernel.launches       # build&merge through K2
    assert p_kern.backend_name == setting["backend"]


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("setting", [
    {"backend": "cuda"}, {"backend": "packed", "kernel": True},
    {"backend": "sparse", "kernel": True},
])
def test_one_rank_mesh_parses_equal_the_non_mesh_parse(dev, pattern, setting):
    """``mesh="host"`` on one process (the 1-rank mesh): ``parse``,
    ``parse_batch`` and a stream through the mesh layer, on the kernels,
    equal to the same config without a mesh."""
    from repro_torch.core.stream import StreamingParser

    cfg = ParserConfig(regex=pattern, n_chunks=4, **setting)
    p_mesh = Parser(cfg.replace(mesh="host"), device=dev)
    p_one = Parser(cfg, device=dev)
    assert p_mesh.engine.dist.transport == "local"
    rng = np.random.default_rng(len(pattern))
    texts = [b"", b"a", b"ab" * 9, b"xyzyyz", b"ba" * 40 + b"~"]
    texts += [bytes(rng.choice(list(b"abxyz"), size=int(n))) for n in (3, 17, 100)]
    prefixes = [b"".join(texts[:i + 1]) for i in range(len(texts))]
    want = [p_one.parse(t).forest for t in texts]
    want_batch = [r.forest for r in p_one.parse_batch(texts)]
    want_stream = [p_one.parse(t).forest for t in prefixes]
    ops.reset_launches()                      # the mesh runs' launches only
    for text, w in zip(texts, want):
        got = p_mesh.parse(text)
        assert got.ok == w.accepted and np.array_equal(got.forest.pack(), w.pack())
    for got, w in zip(p_mesh.parse_batch(texts), want_batch):
        assert np.array_equal(got.forest.pack(), w.pack())
    sp = StreamingParser(p_mesh.engine, first_seal_len=4)
    for piece, w in zip(texts, want_stream):
        sp.append(piece)
        assert np.array_equal(sp.current_slpf().pack(), w.pack())
    reach = {"cuda": ops.reach_chunk_product, "packed": ops.packed_reach_chunk_product,
             "sparse": ops.sparse_reach_rows}[setting["backend"]]
    assert reach.launches >= 1 and ops.build_merge_packed.launches >= 1
    if setting["backend"] == "cuda":
        assert ops.semiring_matmul.launches >= 1


def test_cuda_kernel_setting_is_the_cuda_backend(dev):
    p = Parser(ParserConfig(regex="(a|b|ab)+", n_chunks=4, kernel=True), device=dev)
    want = Parser(ParserConfig(regex="(a|b|ab)+", n_chunks=4, backend="torch"), device=dev)
    assert p.backend_name == "cuda"
    assert np.array_equal(p.parse(b"abab").forest.pack(), want.parse(b"abab").forest.pack())


# ------------------------------------------------------------ LM kernels


def _qkv(rng, b, L, Lk, h, hd, dtype, dev):
    return [torch.tensor(rng.standard_normal((b, n, h, hd)).astype(np.float32), device=dev)
            .to(dtype) for n in (L, Lk, Lk)]


@pytest.mark.parametrize("b,L,h,hd", [
    (2, 256, 4, 80), (1, 37, 3, 80), (2, 130, 2, 64), (1, 1, 2, 32), (1, 257, 2, 128),
    (3, 100, 5, 16), (1, 64, 1, 96), (2, 90, 2, 120), (1, 33, 4, 8),
])
@pytest.mark.parametrize("window", [None, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel_equals_plain(dev, b, L, h, hd, window, dtype):
    dtype = getattr(torch, dtype)
    rng = np.random.default_rng(L * 7 + hd)
    q, k, v = _qkv(rng, b, L, L, h, hd, dtype, dev)
    got = ops.flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    want = ops.flash_attention.plain(q, k, v, causal=True, window=window)
    assert got.dtype == dtype and got.shape == q.shape
    atol = 3e-5 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel_non_causal_and_longer_keys(dev, dtype):
    dtype = getattr(torch, dtype)
    rng = np.random.default_rng(5)
    q, k, v = _qkv(rng, 2, 70, 150, 2, 64, dtype, dev)
    atol = 3e-5 if dtype == torch.float32 else 3e-2
    for causal, window in ((False, None), (True, None), (False, 9)):
        got = ops.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        want = ops.flash_attention.plain(q, k, v, causal=causal, window=window)
        torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


# beside K6's absolute limits, the largest error of one output row (one
# batch, position and head) relative to that row: a fault confined to late
# rows, whose outputs are about as small as the absolute limit, shows here
K6_ROW_REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _assert_flash_close(got, want, dtype):
    atol = 3e-5 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
    g, w = got.float(), want.float()
    rel = ((g - w).norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30)).max().item()
    assert rel <= K6_ROW_REL_TOL[dtype], f"row-relative error {rel}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel_at_the_prefill_shape(dev, dtype):
    """zamba2-2.7b's prefill: q, k, v (2, 2048, 32, 80), causal."""
    dtype = getattr(torch, dtype)
    rng = np.random.default_rng(80)
    q, k, v = _qkv(rng, 2, 2048, 2048, 32, 80, dtype, dev)
    got = ops.flash_attention(q, k, v, causal=True, window=None)
    torch.cuda.synchronize()
    want = ops.flash_attention.plain(q, k, v, causal=True, window=None)
    _assert_flash_close(got, want, dtype)


@pytest.mark.parametrize("L,Lk,causal,window", [
    (1, 1, True, None),          # one row, one key
    (1, 100, False, None),       # one row, Lk not a multiple of the 64-key stage
    (100, 150, False, None),
    (150, 100, True, None),      # more queries than keys
    (1000, 1000, True, None),    # 16 key tiles: the ring wraps five times
    (700, 700, True, 40),        # the window's edge inside a key tile
    (300, 300, False, 100),      # window without the causal mask
    (129, 129, True, 65),        # one row past a query tile, window past a key tile
])
@pytest.mark.parametrize("hd", [40, 80, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel_ring_edges(dev, L, Lk, causal, window, hd, dtype):
    dtype = getattr(torch, dtype)
    rng = np.random.default_rng(L + Lk + hd)
    q, k, v = _qkv(rng, 1, L, Lk, 3, hd, dtype, dev)
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    want = ops.flash_attention.plain(q, k, v, causal=causal, window=window)
    _assert_flash_close(got, want, dtype)


def _ssd_inputs(rng, P, q, hp, n, dtype, dev):
    def t(x, dt=torch.float32):
        return torch.tensor(x.astype(np.float32), device=dev).to(dt)

    xdt = t(rng.standard_normal((P, q, hp)) * 0.3, dtype)
    cs = t(np.cumsum(-rng.uniform(0.01, 0.4, (P, q, 1)), axis=1))
    B = t(rng.standard_normal((P, q, n)) * 0.3, dtype)
    C = t(rng.standard_normal((P, q, n)) * 0.3, dtype)
    S = t(rng.standard_normal((P, hp, n)) * 0.3)
    return xdt, cs, B, C, S


@pytest.mark.parametrize("P,q,hp,n", [
    (3, 256, 64, 64), (5, 100, 16, 32), (2, 64, 128, 128), (4, 1, 16, 16), (2, 300, 32, 16),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunk_kernel_equals_plain(dev, P, q, hp, n, dtype):
    rng = np.random.default_rng(q + hp + n)
    args = _ssd_inputs(rng, P, q, hp, n, getattr(torch, dtype), dev)
    y, S_c = ops.ssd_chunk(*args)
    torch.cuda.synchronize()
    y_ref, S_ref = ops.ssd_chunk.plain(*args)
    assert y.shape == (P, q, hp) and S_c.shape == (P, n, hp)
    torch.testing.assert_close(y, y_ref, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(S_c, S_ref, rtol=2e-4, atol=2e-4)


SSD_OUTPUTS = ("both", "state", "y")


def _assert_ssd_outputs(args, outputs):
    y, S_c = ops.ssd_chunk(*args, outputs=outputs)
    torch.cuda.synchronize()
    y_ref, S_ref = ops.ssd_chunk.plain(*args, outputs=outputs)
    assert (y is None) == (outputs == "state") and (S_c is None) == (outputs == "y")
    for got, want in ((y, y_ref), (S_c, S_ref)):
        if want is not None:
            assert got.shape == want.shape
            torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("q", [8, 64, 256])
@pytest.mark.parametrize("hp", [16, 64, 128])
@pytest.mark.parametrize("n", [16, 64, 128])
@pytest.mark.parametrize("outputs", SSD_OUTPUTS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunk_every_output_mode(dev, q, hp, n, outputs, dtype):
    """Each ``outputs`` mode against the plain version, an odd number of
    programs; bf16 runs on the tensor-core kernel at every one of these
    shapes but a y launch at q = 256, hp = n = 128, whose program does not
    fit in shared memory with S_prev's hi / lo copy (the SIMT kernel's); f32
    on the 3xTF32 tensor-core kernel at every one."""
    rng = np.random.default_rng(q * 3 + hp + n)
    args = _ssd_inputs(rng, 3, q, hp, n, getattr(torch, dtype), dev)
    lib = ops.build()[ssd_launcher.SOURCE]
    too_long = (q, hp, n) == (256, 128, 128) and outputs != "state"
    want_kernel = "tf32" if dtype == "float32" else "simt" if too_long else "mma"
    assert ssd_launcher.plan(lib, args[0], args[2], args[3], args[4], outputs) == want_kernel
    _assert_ssd_outputs(args, outputs)


@pytest.mark.parametrize("outputs", SSD_OUTPUTS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunk_at_the_prefill_shape(dev, outputs, dtype):
    """zamba2-2.7b's prefill: P = 1280 programs, q = 256, hp = n = 64."""
    args = _ssd_inputs(np.random.default_rng(1280), 1280, 256, 64, 64, getattr(torch, dtype), dev)
    _assert_ssd_outputs(args, outputs)


@pytest.mark.parametrize("kernel", ["tf32", "simt"])
@pytest.mark.parametrize("outputs", SSD_OUTPUTS)
@pytest.mark.parametrize("P,hp,n", [(1280, 64, 64), (7, 128, 128)])
def test_ssd_chunk_f32_on_each_kernel(dev, monkeypatch, kernel, outputs, P, hp, n):
    """f32 programs of q = 256 on the 3xTF32 tensor-core kernel (the plan's
    choice) and on the SIMT kernel, forced through the plan: zamba2-2.7b's
    prefill shape (P = 1280, hp = n = 64) and the widest head and state."""
    monkeypatch.setattr(ssd_launcher, "plan", lambda *a: kernel)
    args = _ssd_inputs(np.random.default_rng(P + hp), P, 256, hp, n, torch.float32, dev)
    _assert_ssd_outputs(args, outputs)


@pytest.mark.parametrize("outputs", SSD_OUTPUTS)
def test_ssd_chunk_bf16_on_the_simt_kernel(dev, monkeypatch, outputs):
    """The SIMT kernel, the plan's choice for bf16 programs too long for the
    tensor-core kernel, forced through the plan."""
    monkeypatch.setattr(ssd_launcher, "plan", lambda *a: "simt")
    args = _ssd_inputs(np.random.default_rng(7), 5, 100, 32, 48, torch.bfloat16, dev)
    _assert_ssd_outputs(args, outputs)


def test_lm_wrappers_count_launches_on_the_card_only(dev):
    rng = np.random.default_rng(2)
    q, k, v = _qkv(rng, 1, 16, 16, 2, 32, torch.float32, torch.device("cpu"))
    args = _ssd_inputs(rng, 2, 16, 16, 16, torch.float32, torch.device("cpu"))
    ops.reset_launches()
    ops.flash_attention(q, k, v, causal=True, window=None)
    ops.ssd_chunk(*args)
    assert ops.flash_attention.launches == 0 and ops.ssd_chunk.launches == 0
    ops.flash_attention(q.to(dev), k.to(dev), v.to(dev), causal=True, window=4)
    ops.ssd_chunk(*[a.to(dev) for a in args])
    assert ops.flash_attention.launches == 1 and ops.ssd_chunk.launches == 1
    x, cs, B, C, _ = (a.to(dev) for a in args)
    _, S_c = ops.ssd_chunk(x, cs, B, C, None, outputs="state")          # S_prev unread
    torch.testing.assert_close(S_c, ops.ssd_chunk.plain(x, cs, B, C, None, outputs="state")[1],
                               rtol=2e-4, atol=2e-4)
    assert ops.ssd_chunk.launches == 2
    assert ops.ssd_chunk.case_launches == {"both": 1, "state": 1}


def test_lm_wrappers_refuse_what_the_kernels_do_not_take(dev):
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng, 1, 32, 32, 2, 64, torch.bfloat16, dev)
    with pytest.raises(ValueError):
        ops.flash_attention(q.half(), k.half(), v.half())                 # f16
    with pytest.raises(ValueError):
        ops.flash_attention(q, k.float(), v)                              # mixed dtypes
    with pytest.raises(ValueError):
        ops.flash_attention(q.transpose(1, 2), k, v)                      # not contiguous
    q36, k36, v36 = _qkv(rng, 1, 32, 32, 2, 36, torch.bfloat16, dev)
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention(q36, k36, v36)                                # not a multiple of 8
    q_wide = _qkv(rng, 1, 8, 8, 1, 136, torch.float32, dev)
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention(*q_wide)                                      # above 128
    with pytest.raises(ValueError):
        ops.flash_attention(q, k[:, :, :1].contiguous(), v[:, :, :1].contiguous())
    xdt, cs, B, C, S = _ssd_inputs(rng, 2, 32, 16, 16, torch.bfloat16, dev)
    with pytest.raises(ValueError):
        ops.ssd_chunk(xdt, cs.to(torch.bfloat16), B, C, S)                # cs not f32
    with pytest.raises(ValueError):
        ops.ssd_chunk(xdt, cs, B.float(), C, S)                           # mixed dtypes
    with pytest.raises(ValueError):
        ops.ssd_chunk(xdt.transpose(1, 2).contiguous().transpose(1, 2), cs, B, C, S)
    x24, _, B24, C24, S24 = _ssd_inputs(rng, 2, 32, 24, 16, torch.float32, dev)
    with pytest.raises(ValueError, match="multiples of 16"):
        ops.ssd_chunk(x24, cs, B24, C24, S24)
    with pytest.raises(ValueError, match="outputs"):
        ops.ssd_chunk(xdt, cs, B, C, S, outputs="S_c")
    with pytest.raises(ValueError, match="needs S_prev"):
        ops.ssd_chunk(xdt, cs, B, C, None, outputs="y")


# ------------------------------------------------------------- LM prefill


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "tinyllama-1.1b", "mamba2-2.7b",
                                  "h2o-danube-3-4b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_on_the_card_equals_the_plain_versions(dev, arch, dtype):
    """The smoke model's prefill through K6 and K7 on the card against the same
    model on its plain versions on the CPU (f32: atol 1e-4; bf16: 5e-2 of the
    logits' scale, bf16 rounding at other places), then decode on both."""
    import dataclasses

    from repro_torch.configs import get_smoke
    from repro_torch.models import model

    cfg = dataclasses.replace(get_smoke(arch), dtype=dtype, param_dtype=dtype,
                              attn_p_dtype=dtype)
    params = model.init_params(cfg, seed=1, device="cpu")
    on_card = _to(params, dev)
    toks = torch.tensor(np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 24)))
    want, _ = model.prefill(params, toks, cfg)
    ops.reset_launches()
    got, _ = model.prefill(on_card, toks.to(dev), cfg)
    torch.cuda.synchronize()
    kinds = cfg.layer_kinds
    n_attn = kinds.count("attn") + (len(kinds) // cfg.shared_attn_every if cfg.shared_attn_every else 0)
    assert ops.flash_attention.launches == n_attn
    assert ops.ssd_chunk.launches == 2 * kinds.count("ssm")
    counts = ops.launch_counts()
    assert counts.get("ssd_chunk/state", 0) == counts.get("ssd_chunk/y", 0) == kinds.count("ssm")
    got, want = got.float().cpu(), want.float()
    tol = 1e-4 if dtype == "float32" else 5e-2 * max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= tol
    caches = model.make_cache(cfg, 2, 8, device=dev)
    cpu_caches = model.make_cache(cfg, 2, 8, device="cpu")
    for t in range(4):
        a, caches = model.decode_step(on_card, caches, toks[:, t : t + 1].to(dev), cfg)
        b, cpu_caches = model.decode_step(params, cpu_caches, toks[:, t : t + 1], cfg)
        assert (a.float().cpu() - b.float()).abs().max().item() <= tol


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}


# ------------------------------------------------ streams and services on the card

STREAM_SETTINGS = [{"backend": "cuda"}, {"backend": "packed", "kernel": True},
                   {"backend": "sparse", "kernel": True}]
STREAM_REACH = {"cuda": "reach_chunk_product", "packed": "packed_reach_chunk_product",
                "sparse": "sparse_reach_rows"}


def _log_text(n_bytes, seed):
    rng = np.random.default_rng(seed)
    lines = []
    while sum(map(len, lines)) < n_bytes:
        path = "".join(rng.choice(list("abc0/"), int(rng.integers(0, 9))))
        lines.append(f"GET /{path} {int(rng.integers(100, 999))} ok\n")
    return "".join(lines)


@pytest.mark.parametrize("setting", STREAM_SETTINGS)
def test_stream_on_the_card_equals_torch_backend(dev, setting):
    """A few KiB streamed in pieces, then spliced, on each kernel backend:
    ``result()`` equals a cold parse on the ``torch`` backend after the
    appends and after every splice, and the reach kernel and K2 launch."""
    pattern = r"((GET|POST) /([a-c0-9]|/)* ([0-9]{3}) ok\n)+"
    cfg = ParserConfig(regex=pattern, n_chunks=16, first_seal_len=8, max_seal_len=512,
                       **setting)
    p = Parser(cfg, device=dev)
    cold = Parser(ParserConfig(regex=pattern, backend="torch", n_chunks=16), device=dev)
    text = _log_text(6000, 5)
    ops.reset_launches()
    with p.open_stream() as st:
        for i in range(0, len(text), 700):
            st.append(text[i:i + 700])
        assert np.array_equal(st.result().forest.pack(), cold.parse(text).forest.pack())
        for lo, hi, repl in ((100, 180, "GET /a0 200 ok\n"), (2000, 2600, ""),
                             (3000, 3000, "GET /bb 404 ok\n"), (51, 52, "~")):
            st.edit(lo, hi, repl)
            text = text[:lo] + repl + text[hi:]
            got = st.result()
            want = cold.parse(text)
            assert st.accepted == want.ok
            assert np.array_equal(got.forest.pack(), want.forest.pack()), (lo, hi)
        assert not st.accepted
    counts = ops.launch_counts()
    assert counts[STREAM_REACH[setting["backend"]]] > 0 and counts["build_merge_packed"] > 0
    if setting["backend"] == "cuda":
        assert counts["semiring_matmul"] > 0


@pytest.mark.parametrize("setting", STREAM_SETTINGS)
def test_grouped_build_merge_on_the_card_equals_per_leaf(dev, setting):
    from repro_torch.core.stream import StreamingParser

    pattern = "(a|b|ab)+"
    p = Parser(ParserConfig(regex=pattern, **setting), device=dev)
    sp = StreamingParser(p.engine, first_seal_len=4, max_seal_len=64)
    sp.append("ab" * 300 + "b")
    chunks = sp._chunk_classes()
    Jf, Jb, _, _ = sp._joined()
    ops.reset_launches()
    grouped = sp._build_merge_grouped(chunks, Jf, Jb)
    lengths = {sp._bucket_len(len(c)) for c in chunks}
    assert ops.launch_counts()["build_merge_packed"] == len(lengths)
    eng = p.engine
    for i, ch in enumerate(chunks):
        k = sp._bucket_len(len(ch))
        one = eng.phases.build_merge(eng.tables.N, eng.chunks_tensor(eng._pad_to(ch, 1, k)),
                                     Jf[i][None].contiguous(), Jb[i][None].contiguous())
        assert np.array_equal(grouped[i], one[0, : len(ch)].cpu().numpy()), i


def test_stream_service_step_is_one_reach_launch(dev):
    p = Parser(ParserConfig(regex="(a|b|ab)+", first_seal_len=8, max_batch=8), device=dev)
    streams = [p.open_stream() for _ in range(4)]
    svc = p.stream_service
    for st in streams:
        st.append("abab")
    ops.reset_launches()
    assert svc.step() is True and svc.step() is False
    assert ops.launch_counts()["reach_chunk_product"] == 1
    cold = Parser(ParserConfig(regex="(a|b|ab)+", backend="torch"), device=dev)
    for st in streams:
        assert np.array_equal(st.result().forest.pack(), cold.parse("abab").forest.pack())


# ------------------------------------------------ the forest's columns on the card

# (ℓ, W) of the scans' buckets, 1024 chunks × 1024: TRAFFIC's and e125's
UNPACK_SHAPES = [(37, 2), (257, 9)]


@pytest.mark.parametrize("ell,W", UNPACK_SHAPES)
def test_unpack_columns_kernel_equals_plain_version(dev, ell, W):
    """The unpack kernel over a group of B = 4 batch rows at the scans'
    bucket, texts of ragged lengths, against its plain version on the card:
    one launch, each text's (n+1, ℓ) bool columns equal."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(ell)
    B, c, k = 4, 1024, 1024
    lo, hi = -(2**31), 2**31 - 1
    col0 = torch.randint(lo, hi, (B, W), generator=gen, dtype=torch.int32, device=dev)
    cols = torch.randint(lo, hi, (B, c, k, W), generator=gen, dtype=torch.int32, device=dev)
    lengths = (c * k, c * k - 777, 300_001, 5)
    ops.reset_launches()
    got = ops.unpack_columns(col0, cols, lengths=lengths, ell=ell)
    assert ops.unpack_columns.launches == 1
    want = ops.unpack_columns.plain(col0, cols, lengths=lengths, ell=ell)
    for n, g, w in zip(lengths, got, want):
        assert g.is_contiguous() and g.dtype == torch.bool and g.shape == (n + 1, ell)
        assert torch.equal(g, w), n


def test_parse_batch_unpacks_on_the_card(dev):
    """A traced ``parse_batch`` of ragged texts in three buckets makes one
    unpack launch a bucket, its host builds read ``unpacked_on`` "device",
    and its columns equal the host route's (``_assemble``)."""
    p = Parser(ParserConfig(regex="(a|b|ab)+", n_chunks=8, obs={"enabled": True}), device=dev)
    eng = p.engine
    texts = ["ab" * 50 + "a", "abba" * 30, "b" * 7, "ab" * 3000 + "b"]
    ops.reset_launches()
    results = p.parse_batch(texts)
    torch.cuda.synchronize()
    buckets = {eng.bucket_shape(len(t), 8) for t in texts}
    assert ops.unpack_columns.launches == len(buckets) == 3
    builds = [s for s in p.obs.tracer.spans if s.name == "phase.host_build"]
    assert len(builds) == len(texts) and {s.attrs["unpacked_on"] for s in builds} == {"device"}
    for text, r in zip(texts, results):
        classes = eng.classes_of_text(text)
        c, k = eng.bucket_shape(len(classes), 8)
        col0, cols = eng.run(eng.chunks_tensor(eng._pad_to(classes, c, k)))
        want = eng._assemble(col0.cpu().numpy(), cols.cpu().numpy(), classes)
        assert np.array_equal(r.forest.columns, want.columns), len(text)
        assert r.forest.columns.flags.c_contiguous and r.forest.columns.flags.writeable
    p.close()


def test_engine_parses_from_threads_through_one_staging_buffer(dev):
    """Threads parsing on one engine at once (more threads than cores, a
    short switch interval), in buckets of several sizes: every result
    equals the single-threaded parse of its text."""
    import os
    import sys
    import threading

    eng = Parser(ParserConfig(regex="(a|b|ab)+", n_chunks=8), device=dev).engine
    texts = ["ab" * (40 + 300 * i) + "a" for i in range(6)]
    want = [eng.parse(t, n_chunks=8).columns for t in texts]
    errors = []

    def worker(j):
        try:
            for r in range(6):
                i = (j + r) % len(texts)
                if not np.array_equal(eng.parse(texts[i], n_chunks=8).columns, want[i]):
                    errors.append((j, r))
        except Exception as e:                  # reported by the assertion below
            errors.append(repr(e))

    threads = [threading.Thread(target=worker, args=(j,)) for j in range((os.cpu_count() or 4) + 2)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []


# ------------------------------------------------- softcap and training


@pytest.mark.parametrize("b,L,h,hd", [(2, 256, 4, 80), (1, 37, 3, 64), (1, 130, 2, 128)])
@pytest.mark.parametrize("window,softcap", [(None, 1.0), (16, 1.0), (None, 30.0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_softcap_kernel_equals_plain(dev, b, L, h, hd, window, softcap, dtype):
    dtype = getattr(torch, dtype)
    rng = np.random.default_rng(L + hd)
    q, k, v = _qkv(rng, b, L, L, h, hd, dtype, dev)
    kw = dict(causal=True, window=window, softcap=softcap)
    got = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    want = ops.flash_attention.plain(q, k, v, **kw)
    atol = 3e-5 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
    if softcap == 1.0:       # the cap bends unit-scale scores: the output moves
        uncapped = ops.flash_attention.plain(q, k, v, causal=True, window=window)
        assert (uncapped.float() - want.float()).abs().max().item() > atol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_autograd_functions_on_the_card(dev, dtype):
    """K6 and K7 under autograd on CUDA tensors: the output has a grad_fn,
    the kernel launched, and the gradients equal those of the plain versions
    on the same card (the backward recomputes them: f32 atol 1e-5, bf16
    2e-2 of the gradients' scale)."""
    dtype = getattr(torch, dtype)
    rng = np.random.default_rng(9)
    qkv = [t.requires_grad_(True) for t in _qkv(rng, 1, 96, 96, 2, 64, dtype, dev)]
    ops.reset_launches()
    out = ops.flash_attention(*qkv, causal=True, window=32, softcap=30.0)
    assert out.grad_fn is not None and ops.flash_attention.launches == 1
    g = torch.randn_like(out)
    got = torch.autograd.grad(out, qkv, g)
    plain = ops.flash_attention.plain(*qkv, causal=True, window=32, softcap=30.0)
    want = torch.autograd.grad(plain, qkv, g)
    for a, w in zip(got, want):
        tol = 1e-5 if dtype == torch.float32 else 2e-2 * w.float().abs().max().item()
        assert (a.float() - w.float()).abs().max().item() <= tol

    P, q, hp, n = 6, 64, 32, 16
    t = lambda *s: torch.tensor(rng.standard_normal(s).astype(np.float32) * 0.3,  # noqa: E731
                                device=dev)
    xdt, B, C = (t(*s).to(dtype).requires_grad_(True) for s in ((P, q, hp), (P, q, n), (P, q, n)))
    cs = torch.cumsum(-(torch.tensor(rng.random((P, q, 1)), dtype=torch.float32, device=dev)
                        * 0.3 + 0.01), 1).requires_grad_(True)
    S = t(P, hp, n).requires_grad_(True)
    for outputs in ("state", "y"):
        args = (xdt, cs, B, C, None if outputs == "state" else S)
        ops.reset_launches()
        res = ops.ssd_chunk(*args, outputs=outputs)
        assert ops.launch_counts()[f"ssd_chunk/{outputs}"] == 1
        o = res[1] if outputs == "state" else res[0]
        assert o.grad_fn is not None
        wrt = [a for a in args if a is not None]
        go = torch.randn_like(o)
        got = torch.autograd.grad(o, wrt, go, allow_unused=True)
        pres = ops.ssd_chunk.plain(*args, outputs=outputs)
        want = torch.autograd.grad(pres[1] if outputs == "state" else pres[0], wrt, go,
                                   allow_unused=True)
        for a, w in zip(got, want):
            assert (a is None) == (w is None)
            if w is not None:
                tol = 1e-5 if dtype == torch.float32 else 2e-2 * w.float().abs().max().item()
                assert (a.float() - w.float()).abs().max().item() <= tol + 1e-6


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "tinyllama-1.1b", "mixtral-8x22b",
                                  "llama4-scout-17b-a16e", "internvl2-1b"])
def test_forward_train_on_the_card_equals_the_plain_versions(dev, arch):
    """The smoke model's loss and gradients in f32 through K6 and K7 on the
    card (and remat) against the same model on the plain versions on the CPU:
    loss rtol 1e-4, each gradient's relative L2 error within 1e-3."""
    import dataclasses

    from repro_torch.configs import get_smoke
    from repro_torch.models import model
    from repro_torch.optim.adamw import tree_leaves, tree_map

    cfg = dataclasses.replace(get_smoke(arch), dtype="float32", param_dtype="float32",
                              attn_p_dtype="float32")
    params = model.init_params(cfg, seed=3, device="cpu")
    rng = np.random.default_rng(4)
    batch = {"tokens": torch.tensor(rng.integers(0, cfg.vocab_size, (2, 32)))}
    if cfg.frontend is not None:
        fe = cfg.frontend
        batch["extra"] = torch.tensor(rng.standard_normal((2, fe.n_extra_tokens,
                                                           fe.feature_dim)).astype(np.float32))

    def run(tree, b):
        live = tree_map(lambda p: p.detach().requires_grad_(True), tree)
        total, _ = model.forward_train(live, b, cfg)
        return float(total.detach()), torch.autograd.grad(total, tree_leaves(live))

    ops.reset_launches()
    got_loss, got = run(_to(params, dev), {k: v.to(dev) for k, v in batch.items()})
    assert ops.flash_attention.launches + ops.ssd_chunk.launches > 0
    want_loss, want = run(params, batch)
    assert abs(got_loss - want_loss) <= 1e-4 * abs(want_loss)
    for a, w in zip(got, want):
        rel = ((a.cpu() - w).norm() / w.norm().clamp_min(1e-30)).item()
        assert rel <= 1e-3


@pytest.mark.parametrize("backend", ["cuda", "packed", "sparse"])
def test_phase_static_cost_models_the_real_launches(dev, backend):
    """``phase_static_cost`` at a TRAFFIC log's bucket: the modeled launches
    by kernel (``phase_traces``) equal the launches of the same engine's real
    parse of the log (counted from 0)."""
    rng = np.random.default_rng(5)
    lines = [f"{m} /{'x' * int(rng.integers(1, 9))} {int(rng.integers(100, 600))} ok\n"
             for m in rng.choice(["GET", "POST", "PUT"], 400)]
    text = "".join(lines).encode()
    p = Parser(ParserConfig(regex=JOIN_PATTERNS["traffic"], backend=backend,
                            kernel=backend != "cuda", n_chunks=64), device=dev)
    eng = p.engine
    c, k = eng.bucket_shape(len(eng.classes_of_text(text)), 64)
    modeled: dict = {}
    for stats in eng.phase_traces(c, k).values():
        for name, n in stats.kernel_launches.items():
            modeled[name] = modeled.get(name, 0) + n
    assert set(eng.phase_static_cost(c, k)) == {"reach", "join", "build_merge", "total"}
    ops.reset_launches()
    assert p.parse(text).ok
    torch.cuda.synchronize()
    # the phase programs' launches, then the forest's unpack (no phase program)
    assert {name: n for name, n in ops.launch_counts().items() if n} == {
        **modeled, "unpack_columns": 1}
