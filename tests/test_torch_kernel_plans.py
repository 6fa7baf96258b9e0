"""The pure-Python parts of the K1–K7 launchers, on the CPU.

K1's launcher (``repro_torch/kernels/reach.py``) picks the group kernel and
its group width, or the strip kernel, by the table's size; K2's
(``kernels/build.py``) the walk kernel with its group width, lanes a chunk,
round and table layout, or the row kernel, and a torch emulation of the
walk's tables and steps is held against the plain version; K4's and K5's
(``kernels/packed_reach.py``, ``kernels/sparse_reach.py``) the walk kernel
and its group width, or the fold kernel, and for the walk how many chunks a
warp packs; K3's
(``kernels/semiring.py``) one of three CUDA kernels by shape and, for the
tiled one, an output tile; K6's (``kernels/flash_attention.py``) bounds the
grid by query tiles; K7's (``kernels/ssd_chunk.py``) picks the tensor-core or
the SIMT kernel and passes the outputs asked for.  No choice changes a
result (the kernels are held against their plain versions on the card by
``tests/test_torch_cuda.py``), but a wrong choice sends a shape to a kernel
that does not take it, so the dispatch is checked here with a stand-in for
the compiled library that records each call.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import backend  # noqa: E402
from repro_torch.core.matrices import pack_bits_torch  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as flash_launcher  # noqa: E402
from repro_torch.kernels import packed_reach, reach  # noqa: E402
from repro_torch.kernels import semiring  # noqa: E402
from repro_torch.kernels import sparse_reach as sparse_launcher  # noqa: E402
from repro_torch.kernels import ssd_chunk as ssd_launcher  # noqa: E402
from repro_torch.kernels.checks import MAX_SMEM_BYTES  # noqa: E402
from repro_torch.kernels.ref import build_merge_packed_ref  # noqa: E402


class _RecordingLib:
    """Stands in for a compiled kernel library: every C function returns 0
    (success) and records its name and integer arguments."""

    def __init__(self, **results):
        self.calls = []
        self._results = results

    def __getattr__(self, fn):
        def call(*args):
            self.calls.append((fn, args))
            return self._results.get(fn, 0)
        return call


@pytest.mark.parametrize("m,n,want", [
    (64, 64, ("tiled", 64)),        # TRAFFIC's join: one 64 x 64 tile a product
    (288, 288, ("tiled", 96)),      # e125's join: 3 x 3 tiles of 96, no padding
    (64, 1, ("matvec", 0)),         # the join's forward act: (b, ℓp, ℓp) · (b, ℓp, 1)
    (1, 64, ("vecmat", 0)),         # its backward act and the start column
    (1, 288, ("vecmat", 0)),
    (1, 1, ("matvec", 0)),
    (130, 33, ("tiled", 64)),
    (128, 128, ("tiled", 64)),
    (192, 192, ("tiled", 96)),     # a tie: the larger tile re-reads less
])
def test_semiring_plan_picks_the_kernel_by_shape(m, n, want):
    assert semiring.plan(m, n) == want


@pytest.mark.parametrize("m", [2, 31, 64, 65, 96, 97, 160, 288, 300, 512, 1000])
@pytest.mark.parametrize("n", [2, 33, 64, 96, 288, 640])
def test_semiring_plan_tile_pads_least(m, n):
    kind, tile = semiring.plan(m, n)
    assert kind == "tiled" and tile in semiring.TILES

    def cover(t):
        return math.ceil(m / t) * math.ceil(n / t) * t * t

    assert cover(tile) == min(cover(t) for t in semiring.TILES)
    assert cover(tile) >= m * n


def _launch_semiring(monkeypatch, a, b):
    lib = _RecordingLib()
    monkeypatch.setattr(semiring, "stream", lambda t: 0)
    out = semiring.launch(lib, a, b)
    assert out.shape == (a.shape[0], a.shape[1], b.shape[2])
    (fn, args), = lib.calls
    return fn, args


@pytest.mark.parametrize("b,m,k,n,fn,ints", [
    (1023, 64, 64, 64, "repro_semiring_matmul", (1023, 64, 64, 64, 64)),
    (5, 288, 288, 288, "repro_semiring_matmul", (5, 288, 288, 288, 96)),
    (1023, 64, 64, 1, "repro_semiring_matvec", (1023, 64, 64)),
    (1023, 1, 64, 64, "repro_semiring_vecmat", (1023, 64, 64)),
    (3, 130, 70, 33, "repro_semiring_matmul", (3, 130, 33, 70, 64)),
])
def test_semiring_launcher_calls_the_planned_kernel(monkeypatch, b, m, k, n, fn, ints):
    a = torch.zeros((b, m, k))
    bb = torch.zeros((b, k, n))
    got_fn, args = _launch_semiring(monkeypatch, a, bb)
    assert got_fn == fn
    assert tuple(x for x in args[3:] if isinstance(x, int) and x != 0) == ints


def test_join_shapes_reach_the_matvec_kernels():
    """The ``cuda`` backend's join and start column give K3 n == 1 and m == 1
    products, which the plan sends to the mat-vec kernels."""
    lp, c = 64, 6
    rng = np.random.default_rng(0)
    P = torch.tensor((rng.random((c, lp, lp)) < 0.1).astype(np.float32))
    I = torch.tensor((rng.random(lp) < 0.5).astype(np.float32))
    F = torch.tensor((rng.random(lp) < 0.5).astype(np.float32))
    shapes = []

    def matmul(a, b):
        shapes.append((a.shape[1], b.shape[2]))
        return torch.clamp(torch.matmul(a, b), max=1.0)

    backend.join_entries(matmul, P, I, F)
    backend.matvec_T(matmul, P[0], F)
    plans = {semiring.plan(m, n)[0] for m, n in shapes}
    assert plans == {"tiled", "matvec", "vecmat"}
    assert semiring.plan(*shapes[-1]) == ("vecmat", 0)


@pytest.mark.parametrize("dtype,tile", [(torch.bfloat16, 128), (torch.float32, 64)])
def test_flash_launcher_bounds_the_grid_by_query_tiles(monkeypatch, dtype, tile):
    monkeypatch.setattr(flash_launcher, "stream", lambda t: 0)
    monkeypatch.setattr(flash_launcher, "MAX_GRID_Y", 3)      # the bound, scaled down
    lib = _RecordingLib(repro_flash_supports=1, repro_flash_query_tile=tile)
    fits = 3 * tile
    q = torch.zeros((1, fits, 1, 8), dtype=dtype)
    flash_launcher.launch(lib, q, q, q, causal=True)
    assert lib.calls[-1][0] == "repro_flash_attention"
    q = torch.zeros((1, fits + 1, 1, 8), dtype=dtype)
    with pytest.raises(ValueError, match="query tiles"):
        flash_launcher.launch(lib, q, q, q, causal=True)
    wide = torch.zeros((40000, 1, 2, 8), dtype=dtype)     # b * h above 65535 is taken
    flash_launcher.launch(lib, wide, wide, wide, causal=True)
    assert lib.calls[-1][0] == "repro_flash_attention"


@pytest.mark.parametrize("n_classes,lp,want", [
    (19, 64, ("group", 4)),       # TRAFFIC: 58 KB of table at g = 4
    (4, 288, ("group", 4)),       # e125: 166 KB
    (300, 32, ("group", 4)),      # ids above 255
    (1, 512, ("group", 4)),       # the widest group-kernel column (W = 16)
    (3, 512, ("group", 2)),       # g = 4 no longer fits, g = 2 does
    (4, 928, ("strip", 0)),       # W = 29: beyond the group kernel's registers
    (40, 288, ("strip", 0)),      # no group width fits 40 classes
    (1, 928, ("strip", 0)),       # the strip kernel's widest table
])
def test_reach_plan_picks_the_kernel_by_table_size(n_classes, lp, want):
    assert reach.plan(n_classes, lp) == want
    if want[0] == "group":
        assert reach.group_table_bytes(n_classes, lp, want[1]) <= MAX_SMEM_BYTES
        wider = [g for g in reach.GROUPS if g > want[1]]
        assert all(reach.group_table_bytes(n_classes, lp, g) > MAX_SMEM_BYTES for g in wider)
    else:
        assert reach.strip_smem_bytes(lp) <= MAX_SMEM_BYTES


@pytest.mark.parametrize("lp", [960, 1024])
def test_reach_plan_raises_beyond_the_strip_kernel(lp):
    with pytest.raises(ValueError, match="shared memory"):
        reach.plan(2, lp)


def _launch_reach(monkeypatch, n_classes, lp, k=5):
    lib = _RecordingLib()
    monkeypatch.setattr(reach, "stream", lambda t: 0)
    N = torch.eye(lp).expand(n_classes, lp, lp).contiguous()
    ids = torch.zeros((3, k), dtype=torch.int32)
    out = reach.launch(lib, N, ids)
    assert out.shape == (3, lp, lp)
    (fn, args), = lib.calls
    return fn, args


@pytest.mark.parametrize("n_classes,lp,g", [(19, 64, 4), (4, 288, 4), (3, 512, 2)])
def test_reach_launcher_sends_a_fitting_table_to_the_group_kernel(monkeypatch, n_classes, lp, g):
    fn, args = _launch_reach(monkeypatch, n_classes, lp)
    assert fn == "repro_reach_group"
    t_words = args[1]
    assert t_words % 4 == 0 and t_words * 4 <= MAX_SMEM_BYTES
    assert t_words * 4 >= reach.group_table_bytes(n_classes, lp, g)
    assert args[4:8] == (3, 5, lp, g)


@pytest.mark.parametrize("n_classes,lp", [(40, 288), (2, 928)])
def test_reach_launcher_sends_other_tables_to_the_strip_kernel(monkeypatch, n_classes, lp):
    fn, args = _launch_reach(monkeypatch, n_classes, lp)
    assert fn == "repro_reach_products"
    assert args[3:6] == (3, 5, lp)


def test_reach_launcher_raises_before_any_call_beyond_the_strip_kernel(monkeypatch):
    lib = _RecordingLib()
    N = torch.eye(960).expand(2, 960, 960).contiguous()
    with pytest.raises(ValueError, match="shared memory"):
        reach.launch(lib, N, torch.zeros((1, 3), dtype=torch.int32))
    assert lib.calls == []


# (classes incl. PAD, ℓp, rows a chunk, plan)
WORD_PLANS = [
    (19, 64, 64, ("walk", 4)),        # TRAFFIC K4: 58 KB of table at g = 4
    (19, 64, 8, ("walk", 4)),         # TRAFFIC K5: 4 chunks a warp, class stride padded
    (4, 288, 288, ("walk", 4)),       # e125 K4: 166 KB
    (4, 288, 256, ("walk", 4)),       # e125 K5
    (1, 512, 512, ("walk", 4)),       # the widest walk row (W = 16)
    (2, 512, 512, ("walk", 2)),       # g = 4 no longer fits, g = 2 does
    (3, 512, 8, ("walk", 2)),
    (4, 512, 512, ("fold", 0)),       # no group width fits
    (2, 544, 544, ("fold", 0)),       # W = 17: beyond the walk's registers
    (2, 544, 8, ("fold", 0)),
    (2, 960, 960, ("fold", 0)),       # the fold kernel's widest table
    (2, 960, 1, ("fold", 0)),
    (40, 288, 288, ("fold", 0)),
    (300, 32, 1, ("walk", 4)),        # ids above 255, 32 chunks a warp
]


@pytest.mark.parametrize("n_classes,lp,rows,want", WORD_PLANS)
def test_word_reach_plan_picks_the_kernel_by_table_size(n_classes, lp, rows, want):
    assert packed_reach.plan(n_classes, lp, rows) == want
    if want[0] == "walk":
        assert packed_reach.walk_table_bytes(n_classes, lp, rows, want[1]) <= MAX_SMEM_BYTES
        wider = [g for g in packed_reach.GROUPS if g > want[1]]
        assert all(packed_reach.walk_table_bytes(n_classes, lp, rows, g) > MAX_SMEM_BYTES
                   for g in wider)
    else:
        assert lp // 32 > packed_reach.MAX_GROUP_W or all(
            packed_reach.walk_table_bytes(n_classes, lp, rows, g) > MAX_SMEM_BYTES
            for g in packed_reach.GROUPS)
        assert packed_reach.fold_smem_bytes(lp, rows) <= MAX_SMEM_BYTES


@pytest.mark.parametrize("lp", [992, 1024])
def test_word_reach_plan_raises_beyond_the_fold_kernel(lp):
    with pytest.raises(ValueError, match="shared memory"):
        packed_reach.plan(2, lp, lp)


# rows a chunk → (chunks a warp, warps a chunk)
LANES = {1: (32, 1), 8: (4, 1), 13: (2, 1), 31: (1, 1), 32: (1, 1), 33: (1, 2), 256: (1, 8)}


@pytest.mark.parametrize("rows", sorted(LANES))
@pytest.mark.parametrize("n_chunks", [1, 5, 7, 64, 1024])
def test_walk_lane_packing_covers_every_row_once(rows, n_chunks):
    """The walk kernel's units and lanes, as its source maps them: unit u
    takes chunks (u // strips)·cpw … + cpw − 1 and strip u % strips; lane l
    walks row (u % strips)·32 + l of the unit's first chunk when cpw = 1,
    else row l % rows of chunk l // rows; every (chunk, row) once, no lane
    past the last chunk or row live."""
    cpw, strips = packed_reach.lanes(rows)
    assert (cpw, strips) == LANES[rows]
    assert cpw * min(rows, 32) <= 32 and strips * 32 >= rows
    units = -(-n_chunks // cpw) * strips
    seen = []
    for u in range(units):
        c0, strip = u // strips * cpw, u % strips
        for lane in range(32):
            slot = 0 if cpw == 1 else lane // rows
            row = strip * 32 + lane - slot * rows
            if slot < cpw and c0 + slot < n_chunks and row < rows:
                seen.append((c0 + slot, row))
    assert sorted(seen) == [(c, r) for c in range(n_chunks) for r in range(rows)]
    # ids: lane l loads step l % (32 // cpw) of chunk l // (32 // cpw); every
    # chunk of the warp gets 32 // cpw ≥ 1 steps a round
    rpc = 32 // cpw
    assert rpc >= 1 and {lane // rpc for lane in range(32) if lane // rpc < cpw} == set(range(cpw))


@pytest.mark.parametrize("rows", [1, 2, 3, 8, 13, 16, 31])
@pytest.mark.parametrize("lp,g", [(64, 4), (64, 2), (288, 4), (96, 2)])
def test_walk_class_stride_spreads_a_warps_classes_over_banks(rows, lp, g):
    """With cpw chunks a warp, one value v of one group in the (up to) cpw
    classes of those chunks lies in cpw distinct banks."""
    cpw, _ = packed_reach.lanes(rows)
    stride = packed_reach.class_stride(lp, g, rows)
    words = (lp // g) * (1 << g) * ((lp // 32) | 1)
    assert words <= stride < words + 32
    assert len({(d * stride) % 32 for d in range(cpw)}) == cpw


def _launch_words(monkeypatch, n_classes, lp, rows, k=5, C=3):
    lib = _RecordingLib()
    monkeypatch.setattr(packed_reach, "stream", lambda t: 0)
    Np = torch.zeros((n_classes, lp, lp // 32), dtype=torch.int32)
    ids = torch.zeros((C, k), dtype=torch.int32)
    if rows is None:
        out = packed_reach.launch(lib, Np, ids)
        rows = lp
    else:
        out = sparse_launcher.launch(lib, Np, ids, torch.zeros((C, rows, lp // 32),
                                                               dtype=torch.int32))
    assert out.shape == (C, rows, lp // 32) and out.dtype == torch.int32
    (fn, args), = lib.calls
    return fn, args


@pytest.mark.parametrize("n_classes,lp,rows,g", [
    (19, 64, None, 4), (19, 64, 8, 4), (4, 288, None, 4), (4, 288, 256, 4), (2, 512, None, 2),
    (3, 512, 13, 2), (5, 64, 1, 4),
])
def test_word_launchers_send_a_fitting_table_to_the_walk_kernel(monkeypatch, n_classes, lp,
                                                                rows, g):
    fn, args = _launch_words(monkeypatch, n_classes, lp, rows)
    assert fn == "repro_packed_walk"
    r = lp if rows is None else rows
    assert (args[2] is None) == (rows is None)                 # K4 folds the identity rows
    cpw = packed_reach.lanes(r)[0]
    stride = packed_reach.class_stride(lp, g, r)
    assert args[4:12] == (n_classes, 3, 5, lp, r, g, cpw, stride)
    assert n_classes * stride * 4 <= MAX_SMEM_BYTES


@pytest.mark.parametrize("n_classes,lp,rows,fn", [
    (40, 288, None, "repro_packed_reach_products"), (2, 544, None, "repro_packed_reach_products"),
    (40, 288, 8, "repro_sparse_reach_rows"), (2, 960, 256, "repro_sparse_reach_rows"),
])
def test_word_launchers_send_other_tables_to_the_fold_kernel(monkeypatch, n_classes, lp, rows, fn):
    got, args = _launch_words(monkeypatch, n_classes, lp, rows)
    assert got == fn
    if rows is None:
        assert args[3:6] == (3, 5, lp)
    else:
        assert args[2] is not None and args[4:8] == (3, 5, lp, rows)


@pytest.mark.parametrize("variant", [("walk", 4), ("walk", 2), ("fold", 0)])
@pytest.mark.parametrize("rows", [None, 8])
def test_word_launchers_follow_a_forced_plan(monkeypatch, variant, rows):
    """The card tests force each plan variant through ``packed_reach.plan``;
    both launchers read it from there."""
    monkeypatch.setattr(packed_reach, "plan", lambda n, l, r: variant)
    fn, args = _launch_words(monkeypatch, 3, 64, rows)
    if variant[0] == "walk":
        assert fn == "repro_packed_walk" and args[9] == variant[1]
    else:
        assert fn == ("repro_packed_reach_products" if rows is None else "repro_sparse_reach_rows")


@pytest.mark.parametrize("rows", [None, 8])
def test_word_launchers_raise_before_any_call_beyond_the_fold_kernel(monkeypatch, rows):
    lib = _RecordingLib()
    monkeypatch.setattr(packed_reach, "stream", lambda t: 0)
    Np = torch.zeros((2, 992, 31), dtype=torch.int32)
    ids = torch.zeros((1, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="shared memory"):
        if rows is None:
            packed_reach.launch(lib, Np, ids)
        else:
            sparse_launcher.launch(lib, Np, ids, torch.zeros((1, rows, 31), dtype=torch.int32))
    assert lib.calls == []


# (classes incl. PAD, ℓp, chunks) → K2's plan
BUILD_PLANS = [
    ((19, 64, 1024), build.Plan("walk", 4, 8, 128, True, 776)),    # TRAFFIC: both tables, 2 warps
    ((4, 288, 1024), build.Plan("walk", 4, 8, 64, False, 10376)),  # e125: 166 KB, rebuilt
    ((6, 288, 1024), build.Plan("walk", 2, 8, 128, False, 5192)),  # g = 4 no longer fits alone
    ((4, 96, 9), build.Plan("walk", 4, 8, 128, True, 1160)),
    ((2, 32, 1), build.Plan("walk", 4, 8, 128, True, 136)),
    ((300, 32, 1), build.Plan("walk", 4, 8, 128, False, 136)),     # ids above 255, rebuilt
    ((19, 64, 32768), build.Plan("walk", 4, 8, 32, True, 776)),    # 32 warps: shorter rounds
    ((1, 512, 1024), build.Plan("walk", 4, 8, 64, False, 34824)),  # the widest walk (W = 16)
    ((3, 512, 9), build.Plan("walk", 2, 8, 32, False, 17416)),
    ((4, 512, 9), build.ROWS),                                     # no group width fits
    ((12, 288, 1024), build.ROWS),
    ((2, 544, 4), build.ROWS),                                     # W = 17: beyond the walk's registers
    ((1, 1024, 4), build.ROWS),                                    # the row kernel's widest table
]


@pytest.mark.parametrize("args,want", BUILD_PLANS)
def test_build_plan_picks_kernel_g_and_lanes_by_table_size(args, want):
    n_classes, lp, C = args
    got = build.plan(n_classes, lp, C)
    assert got == want
    ww = build.walk_warps(C)
    if got.kernel == "walk":
        need = (2 if got.both else 1) * build.table_bytes(n_classes, lp, got.g, got.lanes)
        assert need + ww * build.ring_bytes(lp, got.lanes, got.round) <= MAX_SMEM_BYTES
        longer = [rs for rs in build.ROUNDS if rs > got.round]
        assert all(build.table_bytes(n_classes, lp, got.g, got.lanes)
                   + ww * build.ring_bytes(lp, got.lanes, rs) > MAX_SMEM_BYTES for rs in longer)
        if not got.both:                       # both tables would not fit with this round
            assert need * 2 + ww * build.ring_bytes(lp, got.lanes, got.round) > MAX_SMEM_BYTES
    else:
        assert lp // 32 > build.MAX_GROUP_W or all(
            build.table_bytes(n_classes, lp, g, build.LANES)
            + build.ring_bytes(lp, build.LANES, build.ROUNDS[-1]) > MAX_SMEM_BYTES
            for g in build.GROUPS)


@pytest.mark.parametrize("lp", [1056, 2048, 48, 0])
def test_build_plan_raises_beyond_the_row_kernel(lp):
    with pytest.raises(ValueError, match="multiple of 32 up to 1024"):
        build.plan(2, lp, 4)


@pytest.mark.parametrize("n_chunks,want", [(1, 1), (528, 1), (529, 2), (1024, 2), (8192, 16),
                                           (16896, 32), (10 ** 6, 32)])
def test_build_walk_warps_spread_the_units_over_the_sms(n_chunks, want):
    """A unit is 4 chunks (8 lanes each); one block an SM walks as many
    units as the 132 SMs leave it, up to 32 warps."""
    assert build.walk_warps(n_chunks) == want


def _launch_build(monkeypatch, n_classes, lp, C=3, k=5):
    lib = _RecordingLib()
    monkeypatch.setattr(build, "stream", lambda t: 0)
    N = torch.eye(lp).expand(n_classes, lp, lp).contiguous()
    ids = torch.zeros((C, k), dtype=torch.int32)
    e = torch.zeros((C, lp))
    out = build.launch(lib, N, ids, e, e)
    assert out.shape == (C, k, lp // 32) and out.dtype == torch.int32
    (fn, args), = lib.calls
    return fn, args


@pytest.mark.parametrize("n_classes,lp", [(19, 64), (4, 288), (6, 288), (3, 512), (2, 32)])
def test_build_launcher_sends_a_fitting_table_to_the_walk_kernel(monkeypatch, n_classes, lp):
    fn, args = _launch_build(monkeypatch, n_classes, lp)
    p = build.plan(n_classes, lp, 3)
    assert fn == "repro_build_merge_walk"
    assert args[5:14] == (n_classes, 3, 5, lp, p.g, p.lanes, p.round, int(p.both), p.cls_stride)


@pytest.mark.parametrize("n_classes,lp", [(4, 512), (2, 544), (1, 1024)])
def test_build_launcher_sends_other_tables_to_the_row_kernel(monkeypatch, n_classes, lp):
    fn, args = _launch_build(monkeypatch, n_classes, lp)
    assert fn == "repro_build_merge_packed" and args[6:9] == (3, 5, lp)


@pytest.mark.parametrize("variant", [
    build.Plan("walk", 4, 8, 128, True, 776), build.Plan("walk", 2, 8, 16, False, 200),
    build.Plan("walk", 4, 8, 7, False, 776), build.ROWS,
])
def test_build_launcher_follows_a_forced_plan(monkeypatch, variant):
    """The card tests force each plan variant through ``build.plan``."""
    monkeypatch.setattr(build, "plan", lambda n, l, c, lw=None: variant)
    fn, args = _launch_build(monkeypatch, 3, 64)
    if variant.kernel == "walk":
        assert fn == "repro_build_merge_walk"
        assert args[9:14] == (variant.g, variant.lanes, variant.round, int(variant.both),
                              variant.cls_stride)
    else:
        assert fn == "repro_build_merge_packed"


def test_build_launcher_raises_before_any_call_beyond_the_row_kernel(monkeypatch):
    lib = _RecordingLib()
    N = torch.eye(1056).expand(2, 1056, 1056).contiguous()
    e = torch.zeros((1, 1056))
    with pytest.raises(ValueError, match="up to 1024"):
        build.launch(lib, N, torch.zeros((1, 3), dtype=torch.int32), e, e)
    assert lib.calls == []


@pytest.mark.parametrize("lanes", [1, 2, 4, 8])
@pytest.mark.parametrize("n_chunks", [1, 5, 7, 64, 1024, 5000])
@pytest.mark.parametrize("g", build.GROUPS)
def test_build_walk_lane_and_chunk_packing_covers_every_chunk_once(lanes, n_chunks, g):
    """The walk kernel's units, warps and lanes as its launcher and source map
    them (132 SMs, one block an SM, ``walk_warps`` warps a block walking):
    unit u takes chunks u·cpw … u·cpw + cpw − 1, lane l walks chunk l // L of
    its warp's unit with sub-lane l % L, and sub-lane s looks up groups s,
    s + L, … of every word.  Every chunk is walked once, by L lanes that
    together look up every group of a word once (the source is built for
    L = 8; the mapping holds for any power of two up to 32/g)."""
    sms, cpw = 132, 32 // lanes
    units = -(-n_chunks // cpw)
    ww = min(max(-(-units // sms), 1), 32)
    blocks = min(-(-units // ww), sms)
    seen = []
    for block in range(blocks):
        for warp in range(ww):
            for u in range(warp * blocks + block, units, ww * blocks):
                for lane in range(32):
                    slot, sub = lane // lanes, lane % lanes
                    if u * cpw + slot < n_chunks:
                        seen.append((u * cpw + slot, sub))
    assert sorted(seen) == [(c, s) for c in range(n_chunks) for s in range(lanes)]
    gpw, gpl = 32 // g, 32 // g // lanes
    assert sorted(j * lanes + s for s in range(lanes) for j in range(gpl)) == list(range(gpw))


def _u32_to_i32(words: torch.Tensor) -> torch.Tensor:
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def _walk_tables(N: torch.Tensor, g: int, lanes: int):
    """The walk kernel's forward and backward tables as flat int64 word arrays,
    built as its ``build_tables`` builds them: per 32 x 32 tile (x, a, b) of
    N[x], the packed columns (lane l: bit r = N[x][32a + r][32b + l]) and rows
    (lane l: bit c = N[x][32a + l][32b + c]), combined into the entries of
    each g-group at x · stride + (grp · 2^g + v) · (W | 1) + word."""
    A1, lp, _ = N.shape
    W, V, gpw = lp // 32, 1 << g, 32 // g
    WS = W | 1
    stride = build.class_stride(lp, g, lanes)
    tf = torch.zeros(A1 * stride, dtype=torch.int64)
    tb = torch.zeros(A1 * stride, dtype=torch.int64)
    shifts = torch.arange(32, dtype=torch.int64)
    bits = torch.tensor([[(v >> b) & 1 for b in range(g)] for v in range(V)], dtype=torch.bool)
    for x in range(A1):
        for a in range(W):
            for b in range(W):
                tile = (N[x, 32 * a:32 * a + 32, 32 * b:32 * b + 32] != 0).long()   # [r, c]
                col = (tile << shifts[:, None]).sum(0)          # lane l: column 32b + l
                row = (tile << shifts[None, :]).sum(1)          # lane l: row 32a + l
                for words, table, blk, word in ((col, tf, b, a), (row, tb, a, b)):
                    grp = words.view(gpw, g)
                    ent = torch.zeros((gpw, V), dtype=torch.int64)
                    for bit in range(g):
                        ent |= torch.where(bits[None, :, bit], grp[:, bit:bit + 1], 0)
                    gi = torch.arange(gpw)[:, None]
                    v = torch.arange(V)[None, :]
                    table[x * stride + ((blk * gpw + gi) * V + v) * WS + word] = ent
    return tf, tb, stride


def _walk_step(table, stride, x, f, lp, g, lanes):
    """One step of every chunk: each of the L sub-lanes looks up groups s,
    s + L, … of every word of f (C, W) int64, then the lanes' words are ORed
    (the kernel's __shfl_xor_sync rounds)."""
    W, V, gpw = lp // 32, 1 << g, 32 // g
    WS, GROUP = W | 1, V * (W | 1)
    i = torch.arange(W)
    new = torch.zeros_like(f)
    for sub in range(lanes):
        for w in range(W):
            word = f[:, w] >> (sub * g)
            for j in range(gpw // lanes):
                nib = (word >> (j * lanes * g)) & (V - 1)
                base = x * stride + sub * GROUP + w * gpw * GROUP + j * lanes * GROUP + nib * WS
                new |= table[base[:, None] + i[None, :]]
    return new


def emulate_walk(N, ids, ef, eb, g, lanes):
    """The walk kernel's arithmetic in torch: (C, k, W) int32 packed columns."""
    lp = N.shape[-1]
    tf, tb, stride = _walk_tables(N, g, lanes)
    C, k = ids.shape
    ids = ids.long()
    out = torch.zeros((C, k, lp // 32), dtype=torch.int64)
    f = pack_bits_torch(ef).long() & 0xFFFFFFFF
    for t in range(k):
        f = _walk_step(tf, stride, ids[:, t], f, lp, g, lanes)
        out[:, t] = f
    beta = pack_bits_torch(eb).long() & 0xFFFFFFFF
    for t in range(k - 1, -1, -1):
        out[:, t] &= beta
        beta = _walk_step(tb, stride, ids[:, t], beta, lp, g, lanes)
    return _u32_to_i32(out)


@pytest.mark.parametrize("lp", [32, 64, 96, 288])
@pytest.mark.parametrize("g", build.GROUPS)
@pytest.mark.parametrize("lanes", [1, 2, 4, 8])
def test_build_walk_emulation_equals_plain(lp, g, lanes):
    """The group-table frontier walk, forward and backward with the AND, bit
    for bit against ``build_merge_packed_ref``: random tables with PAD (the
    last class) the identity, a padded bucket (chunks ending in PAD) and an
    all-PAD chunk."""
    assert lanes <= 32 // g                # any such L; the source is built for 8
    rng = np.random.default_rng(lp + 7 * g + lanes)
    A1, C, k = 4, 5, 9
    N = (rng.random((A1, lp, lp)) < 3.0 / lp).astype(np.float32)
    N[-1] = np.eye(lp, dtype=np.float32)
    ids = rng.integers(0, A1, size=(C, k))
    ids[2:, k // 2:] = A1 - 1
    ids[-1] = A1 - 1
    N, ids = torch.tensor(N), torch.tensor(ids, dtype=torch.int32)
    ef = torch.tensor((rng.random((C, lp)) < 0.4).astype(np.float32))
    eb = torch.tensor((rng.random((C, lp)) < 0.4).astype(np.float32))
    want = build_merge_packed_ref(N, ids, ef, eb)
    assert want.any()                                 # not an empty forest
    assert torch.equal(emulate_walk(N, ids, ef, eb, g, lanes), want)


def _ssd_args(dtype, P=3, q=256, hp=64, n=64):
    return (torch.zeros((P, q, hp), dtype=dtype), torch.zeros((P, q, 1)),
            torch.zeros((P, q, n), dtype=dtype), torch.zeros((P, q, n), dtype=dtype),
            torch.zeros((P, hp, n)))


@pytest.mark.parametrize("outputs,roles", [("both", 3), ("state", 2), ("y", 1)])
@pytest.mark.parametrize("dtype,tc_smem,kernel", [
    (torch.bfloat16, 115712, 1),        # the prefill's program fits: tensor cores
    (torch.bfloat16, -1, 0),            # it does not: the SIMT kernel
    (torch.float32, 115712, 0),         # f32 operands: the SIMT kernel
])
def test_ssd_launcher_plans_and_passes_the_outputs(monkeypatch, outputs, roles, dtype,
                                                   tc_smem, kernel):
    lib = _RecordingLib(repro_ssd_chunk_tc_smem_bytes=tc_smem, repro_ssd_chunk_smem_bytes=60000)
    monkeypatch.setattr(ssd_launcher, "stream", lambda t: 0)
    y, S_c = ssd_launcher.launch(lib, *_ssd_args(dtype), outputs=outputs)
    assert (y is None) == (outputs == "state") and (S_c is None) == (outputs == "y")
    fn, args = lib.calls[-1]
    assert fn == "repro_ssd_chunk"
    assert (args[5] is None) == (outputs == "state") and (args[6] is None) == (outputs == "y")
    assert args[7:14] == (int(dtype == torch.bfloat16), 3, 256, 64, 64, roles, kernel)


@pytest.mark.parametrize("outputs,roles", [("both", 3), ("state", 2), ("y", 1)])
@pytest.mark.parametrize("tf32_smem,aligned,kernel", [
    (152576, True, 2),       # the f32 prefill's program fits: the 3xTF32 tensor-core kernel
    (-1, True, 0),           # it does not: the SIMT kernel
    (152576, False, 0),      # a tensor not 16-byte aligned: the SIMT kernel
])
def test_ssd_launcher_sends_f32_programs_to_the_tf32_kernel(monkeypatch, outputs, roles,
                                                           tf32_smem, aligned, kernel):
    lib = _RecordingLib(repro_ssd_chunk_tf32_smem_bytes=tf32_smem,
                        repro_ssd_chunk_tc_smem_bytes=115712, repro_ssd_chunk_smem_bytes=60000)
    monkeypatch.setattr(ssd_launcher, "stream", lambda t: 0)
    x, cs, B, C, S = _ssd_args(torch.float32)
    if not aligned:
        B = torch.zeros(3 * 256 * 64 + 1)[1:].view(3, 256, 64)
    y, S_c = ssd_launcher.launch(lib, x, cs, B, C, S, outputs=outputs)
    sized = [args for fn, args in lib.calls if fn == "repro_ssd_chunk_tf32_smem_bytes"]
    assert sized == [(256, 64, 64, roles)]
    fn, args = lib.calls[-1]
    assert fn == "repro_ssd_chunk" and args[7] == 0 and args[12:14] == (roles, kernel)
    assert ssd_launcher.KERNELS["tf32"] == 2


@pytest.mark.parametrize("dtype,kernel", [(torch.bfloat16, 1), (torch.float32, 0)])
def test_ssd_launcher_passes_no_state_for_a_state_launch(monkeypatch, dtype, kernel):
    """``outputs="state"`` takes S_prev = None (the source reads none) and
    passes a null pointer; a y launch without S_prev raises before any call."""
    lib = _RecordingLib(repro_ssd_chunk_tc_smem_bytes=66560, repro_ssd_chunk_smem_bytes=60000)
    monkeypatch.setattr(ssd_launcher, "stream", lambda t: 0)
    x, cs, B, C, _ = _ssd_args(dtype)
    y, S_c = ssd_launcher.launch(lib, x, cs, B, C, None, outputs="state")
    assert y is None and S_c.shape == (3, 64, 64)
    fn, args = lib.calls[-1]
    assert fn == "repro_ssd_chunk" and args[4] is None and args[5] is None
    assert args[12:14] == (2, kernel)
    n_calls = len(lib.calls)
    for outputs in ("y", "both"):
        with pytest.raises(ValueError, match="needs S_prev"):
            ssd_launcher.launch(lib, x, cs, B, C, None, outputs=outputs)
    assert len(lib.calls) == n_calls


def test_ssd_launcher_raises_on_unknown_outputs_and_oversized_programs(monkeypatch):
    monkeypatch.setattr(ssd_launcher, "stream", lambda t: 0)
    lib = _RecordingLib(repro_ssd_chunk_tc_smem_bytes=-1,
                        repro_ssd_chunk_smem_bytes=MAX_SMEM_BYTES + 4)
    with pytest.raises(ValueError, match="outputs"):
        ssd_launcher.launch(lib, *_ssd_args(torch.bfloat16), outputs="S_c")
    with pytest.raises(ValueError, match="shared memory"):
        ssd_launcher.launch(lib, *_ssd_args(torch.bfloat16), outputs="y")
    assert [fn for fn, _ in lib.calls if fn == "repro_ssd_chunk"] == []


# ------------------------------------------------------------ tenant axis
#
# K1, K2, K4 and K5 over a stack of T tenant tables (the fleet's bucket
# dispatch): the launchers pass T to the source, whose kernels find each
# chunk's tenant; the plans are those of one tenant's table (K2's over the
# launch's total chunks), and the grids give each tenant its own blocks.


def _tenant_stack(T, n_classes, lp, packed=False):
    if packed:
        return torch.zeros((T, n_classes, lp, lp // 32), dtype=torch.int32)
    return torch.eye(lp).expand(T, n_classes, lp, lp).contiguous()


@pytest.mark.parametrize("T", [1, 3, 32])
@pytest.mark.parametrize("n_classes,lp,fn", [(19, 64, "repro_reach_group"),
                                             (40, 288, "repro_reach_products")])
def test_reach_launcher_passes_the_tenants(monkeypatch, T, n_classes, lp, fn):
    lib = _RecordingLib()
    monkeypatch.setattr(reach, "stream", lambda t: 0)
    ids = torch.zeros((T * 3, 5), dtype=torch.int32)
    out = reach.launch(lib, _tenant_stack(T, n_classes, lp), ids)
    assert out.shape == (T * 3, lp, lp)
    (got, args), = lib.calls
    assert got == fn
    if fn == "repro_reach_group":                  # T tables of t_words, one a tenant
        assert args[4:9] == (T * 3, 5, lp, 4, T)
        assert args[1] * 4 >= reach.group_table_bytes(n_classes, lp, 4)
        assert args[1] * 4 <= MAX_SMEM_BYTES       # one tenant's table a block
    else:
        assert args[3:8] == (T * 3, 5, lp, n_classes, T)


@pytest.mark.parametrize("T", [1, 3, 32])
@pytest.mark.parametrize("n_classes,lp,fn", [(19, 64, "repro_build_merge_walk"),
                                             (4, 512, "repro_build_merge_packed")])
def test_build_launcher_passes_the_tenants(monkeypatch, T, n_classes, lp, fn):
    lib = _RecordingLib()
    monkeypatch.setattr(build, "stream", lambda t: 0)
    C = T * 9
    e = torch.zeros((C, lp))
    out = build.launch(lib, _tenant_stack(T, n_classes, lp), torch.zeros((C, 5), dtype=torch.int32),
                       e, e)
    assert out.shape == (C, 5, lp // 32)
    (got, args), = lib.calls
    assert got == fn
    if fn == "repro_build_merge_walk":
        p = build.plan(n_classes, lp, C)               # the launch's total chunks
        assert args[5:15] == (n_classes, C, 5, lp, p.g, p.lanes, p.round, int(p.both),
                              p.cls_stride, T)
    else:
        assert args[6:11] == (C, 5, lp, n_classes, T)


@pytest.mark.parametrize("T", [1, 3, 32])
@pytest.mark.parametrize("n_classes,lp,rows,fn", [
    (19, 64, None, "repro_packed_walk"), (19, 64, 8, "repro_packed_walk"),
    (40, 288, None, "repro_packed_reach_products"), (40, 288, 8, "repro_sparse_reach_rows"),
])
def test_word_launchers_pass_the_tenants(monkeypatch, T, n_classes, lp, rows, fn):
    lib = _RecordingLib()
    monkeypatch.setattr(packed_reach, "stream", lambda t: 0)
    C = T * 9
    Np = _tenant_stack(T, n_classes, lp, packed=True)
    ids = torch.zeros((C, 5), dtype=torch.int32)
    if rows is None:
        packed_reach.launch(lib, Np, ids)
    else:
        sparse_launcher.launch(lib, Np, ids, torch.zeros((C, rows, lp // 32), dtype=torch.int32))
    (got, args), = lib.calls
    assert got == fn
    r = lp if rows is None else rows
    if fn == "repro_packed_walk":
        assert args[4:13] == (n_classes, C, 5, lp, r, 4, packed_reach.lanes(r)[0],
                              packed_reach.class_stride(lp, 4, r), T)
    elif rows is None:
        assert args[3:8] == (C, 5, lp, n_classes, T)
    else:
        assert args[4:10] == (C, 5, lp, rows, n_classes, T)


def test_launchers_refuse_chunks_that_do_not_split_over_the_tenants(monkeypatch):
    lib = _RecordingLib()
    for mod in (reach, build, packed_reach):
        monkeypatch.setattr(mod, "stream", lambda t: 0)
    ids = torch.zeros((7, 5), dtype=torch.int32)
    e = torch.zeros((7, 64))
    with pytest.raises(ValueError, match="split evenly"):
        reach.launch(lib, _tenant_stack(3, 4, 64), ids)
    with pytest.raises(ValueError, match="split evenly"):
        build.launch(lib, _tenant_stack(3, 4, 64), ids, e, e)
    with pytest.raises(ValueError, match="split evenly"):
        packed_reach.launch(lib, _tenant_stack(3, 4, 64, packed=True), ids)
    assert lib.calls == []


# (launcher grid args) → (grid x, grid y, threads): the fleet's buckets at
# chip_smoke.py's sizes and the solo parse shapes
GRIDS = [
    # 192 a/b tenants (Tp 256) × 4 texts × 4 chunks: 16 units a tenant, one block each
    ("reach", (4, 32, 256 * 16, 256), (1, 256, 512)),
    # TRAFFIC's 16 tenants × 4 texts × 64 chunks: 512 units a tenant over 8 blocks
    ("reach", (32, 64, 16 * 256, 16), (8, 16, 1024)),
    ("reach", (19, 64, 1024, 1), (128, 1, 512)),        # a solo TRAFFIC parse: as before
    ("reach", (4, 512, 16 * 64, 16), (1024, 16, 128)),  # e125 at ℓp 512: the strip fallback
    ("build", (4, 32, 256 * 16, 256), (1, 256, 1024)),
    ("build", (32, 64, 16 * 256, 16), (8, 16, 1024)),
    ("build", (19, 64, 1024, 1), (128, 1, 1024)),
    ("build", (4, 512, 16 * 64, 16), (1024, 1, 512)),   # the row fallback
    ("words", (32, 64, 8, 16 * 256, 16), (8, 16, 256)),  # K5: 4 chunks a warp
    ("words", (32, 64, 64, 16 * 256, 16), (8, 16, 1024)),
    ("words", (4, 512, 512, 64, 1), (64, 32, 256)),     # the fold fallback: 16 rows a block
]


@pytest.mark.parametrize("which,args,want", GRIDS)
def test_tenant_grids(which, args, want):
    """Each tenant gets its own blocks (grid y = tenants) of no more warps
    than it has units; the resident blocks are shared out over the
    tenants; a fallback's grid covers every chunk."""
    fn = {"reach": reach.grid, "build": build.grid, "words": packed_reach.grid}[which]
    got = fn(*args)
    assert got == want
    gx, gy, threads = got
    assert 1 <= gx and 1 <= gy <= 65535 and 32 <= threads <= 1024 and threads % 32 == 0


def test_class_ids_are_checked_on_the_host():
    """Out-of-range class ids raise in numpy before the upload (the engine's
    ``chunks_tensor``), so no launcher reads a value back from the card."""
    from repro_torch.core.engine import ParserEngine
    from repro_torch.core.matrices import build_matrices
    from repro_torch.core.segments import compute_segments
    from repro_torch.kernels.checks import check_class_ids

    check_class_ids(np.array([[0, 3]], dtype=np.int32), 4)
    check_class_ids(np.zeros((0, 5), dtype=np.int32), 1)
    for bad in ([[0, 4]], [[-1, 0]]):
        with pytest.raises(ValueError, match=r"\[0, 4\)"):
            check_class_ids(np.array(bad, dtype=np.int32), 4)
    eng = ParserEngine(build_matrices(compute_segments("(a|b)*abb")), backend="torch",
                       device="cpu")
    with pytest.raises(ValueError, match="class ids"):
        eng.chunks_tensor(np.full((1, 8), eng.tables.N.shape[0], dtype=np.int32))


@pytest.mark.parametrize("which", ["reach", "build", "packed", "sparse"])
def test_launchers_read_no_value_back(monkeypatch, which):
    """The host-sync lint finds nothing in a launch: no id is read back
    (the range check is the host's), K1's group tables are derived once a
    table."""
    from repro_torch.analyze import lint_program

    lib = _RecordingLib()
    for mod in (reach, build, packed_reach):
        monkeypatch.setattr(mod, "stream", lambda t: 0)
    N, ids = _tenant_stack(3, 19, 64), torch.zeros((9, 5), dtype=torch.int32)
    Np, e = _tenant_stack(3, 19, 64, packed=True), torch.zeros((9, 64))
    call = {"reach": lambda: reach.launch(lib, N, ids),
            "build": lambda: build.launch(lib, N, ids, e, e),
            "packed": lambda: packed_reach.launch(lib, Np, ids),
            "sparse": lambda: sparse_launcher.launch(lib, Np, ids,
                                                     torch.zeros((9, 8, 2), dtype=torch.int32))}
    assert lint_program(call[which], (), which) == []


def test_derived_tables_are_kept_while_the_table_lives(monkeypatch):
    """K1's group tables are built once a table tensor: again only after an
    in-place write, or for another tensor."""
    built = []
    real = reach.tenant_group_tables
    monkeypatch.setattr(reach, "tenant_group_tables",
                        lambda N, g: built.append(g) or real(N, g))
    monkeypatch.setattr(reach, "stream", lambda t: 0)
    lib = _RecordingLib()
    N, ids = _tenant_stack(2, 4, 64), torch.zeros((4, 3), dtype=torch.int32)
    reach.launch(lib, N, ids)
    reach.launch(lib, N, ids)
    assert len(built) == 1
    N[0, 0, 0, 1] = 1.0                                  # an in-place write: rebuilt
    reach.launch(lib, N, ids)
    reach.launch(lib, N.clone(), ids)                    # another tensor: its own
    assert len(built) == 3


# ------------------------------------------------------------ live window
#
# A table padded past its live states (the fleet's e125 bucket: ℓ = 257 at
# ℓp 512) with its window attached (``kernels/window.py``): K1's group
# kernel and K2's walk are planned, tabulated and launched at the ℓ' live
# states, the ℓp-wide outputs kept; without a window, as before.


def _window_stack(T, n_real, ell, lp, attach=True):
    """T tables as the fleet pads them: ``n_real`` classes inside [0, ell)²,
    the last class the identity over all ℓp; the window attached."""
    from repro_torch.kernels import window

    N = torch.zeros((T, n_real + 1, lp, lp))
    N[:, :n_real, :ell, :ell] = (torch.arange(ell)[:, None] + torch.arange(ell) < ell).float()
    N[:, -1] = torch.eye(lp)
    if attach:
        window.attach(N, window.live_window(N))
    return N


@pytest.mark.parametrize("n_classes,lp,lw,want", [
    (4, 512, 288, ("group", 4)),      # e125's bucket at its window: the solo e125 table
    (4, 512, 512, ("strip", 0)),      # no window: 557 KB at g = 4 does not fit
    (3, 512, 480, ("group", 2)),
    (4, 1024, 288, ("group", 4)),     # past the strip kernel's ℓp, inside the walk
    (40, 512, 288, ("strip", 0)),     # no group width fits 40 classes even at ℓ'
])
def test_reach_plan_walks_the_window(n_classes, lp, lw, want):
    assert reach.plan(n_classes, lp, lw) == want


@pytest.mark.parametrize("n_classes,lp,C,lw,want", [
    (4, 512, 1024, 288, build.Plan("walk", 4, 8, 64, False, 10376)),   # the solo e125 walk
    (4, 512, 1024, 512, build.ROWS),
    (4, 1024, 9, 64, build.Plan("walk", 4, 8, 128, True, 776)),
])
def test_build_plan_walks_the_window(n_classes, lp, C, lw, want):
    assert build.plan(n_classes, lp, C, lw) == want
    assert build.plan(n_classes, lp, C, None) == build.plan(n_classes, lp, C)


@pytest.mark.parametrize("T", [1, 3, 16])
def test_reach_launcher_passes_the_window(monkeypatch, T):
    """e125's bucket with its window: the group kernel at g = 4 over a table
    of the 288 live states, ℓp 512 outputs, the tenants' flags; without
    the window the strip kernel."""
    lib = _RecordingLib()
    monkeypatch.setattr(reach, "stream", lambda t: 0)
    N = _window_stack(T, 3, 257, 512)
    ids = torch.zeros((T * 3, 5), dtype=torch.int32)
    out = reach.launch(lib, N, ids)
    assert out.shape == (T * 3, 512, 512)
    (fn, args), = lib.calls
    assert fn == "repro_reach_group"
    assert args[4:12] == (T * 3, 5, 512, 4, T, 288, N._repro_derived["window"][1].ident.data_ptr(), 4)
    assert args[1] * 4 >= reach.group_table_bytes(4, 288, 4) and args[1] * 4 <= MAX_SMEM_BYTES
    lib.calls.clear()
    reach.launch(lib, N.clone(), ids)
    (fn, args), = lib.calls
    assert fn == "repro_reach_products"


def test_reach_launcher_without_a_window_passes_lp_and_no_flags(monkeypatch):
    fn, args = _launch_reach(monkeypatch, 4, 288)
    assert fn == "repro_reach_group" and args[9:12] == (288, None, 4)


def test_window_group_table_is_the_live_blocks():
    """The group table K1 walks at ℓ' is that of the [0, ℓ')² block."""
    N = _window_stack(2, 3, 257, 512)
    live = N[..., :288, :288].contiguous()
    assert torch.equal(reach.tenant_group_tables(N[..., :288, :288], 4),
                       reach.tenant_group_tables(live, 4))


@pytest.mark.parametrize("T", [1, 3, 16])
def test_build_launcher_passes_the_window(monkeypatch, T):
    lib = _RecordingLib()
    monkeypatch.setattr(build, "stream", lambda t: 0)
    N = _window_stack(T, 3, 257, 512)
    C = T * 9
    e = torch.zeros((C, 512))
    out = build.launch(lib, N, torch.zeros((C, 5), dtype=torch.int32), e, e)
    assert out.shape == (C, 5, 16)
    (walk, args), (pad, pad_args) = lib.calls
    p = build.plan(4, 512, C, 288)
    assert walk == "repro_build_merge_walk"                # on the live block, into a scratch
    assert args[5:15] == (4, C, 5, 288, p.g, p.lanes, p.round, int(p.both), p.cls_stride, T)
    assert pad == "repro_build_merge_pad"                   # the ℓp-wide columns
    assert pad_args[1] == N._repro_derived["window"][1].ident.data_ptr()
    assert pad_args[4] == args[4] and pad_args[5] == out.data_ptr()
    assert pad_args[6:12] == (C, 5, 512, 288, 4, T)
    lib.calls.clear()
    build.launch(lib, N.clone(), torch.zeros((C, 5), dtype=torch.int32), e, e)
    (fn, args), = lib.calls
    assert fn == "repro_build_merge_packed"


@pytest.mark.parametrize("which,args,want", [
    ("reach", (4, 512, 16 * 64, 16), (8, 16, 1024)),     # e125's bucket: 576 units a tenant
    ("build", (4, 512, 16 * 64, 16), (8, 16, 1024)),     # 16 units a tenant, 2 walking warps
])
def test_tenant_grids_at_the_window(which, args, want):
    fn = {"reach": reach.grid, "build": build.grid}[which]
    assert fn(*args, lw=288) == want
    assert fn(*args) != want                           # the strip / row fallback's


@pytest.mark.parametrize("which", ["reach", "build"])
def test_window_launchers_read_no_value_back(monkeypatch, which):
    """A launch at an attached window reads nothing back: the window was
    decided before, with the table."""
    from repro_torch.analyze import lint_program

    lib = _RecordingLib()
    for mod in (reach, build):
        monkeypatch.setattr(mod, "stream", lambda t: 0)
    N, ids = _window_stack(3, 3, 40, 128), torch.zeros((9, 5), dtype=torch.int32)
    e = torch.zeros((9, 128))
    call = {"reach": lambda: reach.launch(lib, N, ids),
            "build": lambda: build.launch(lib, N, ids, e, e)}
    assert lint_program(call[which], (), which) == []
    assert lib.calls[0][1][9 if which == "reach" else 8] == 64
