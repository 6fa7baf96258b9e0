"""The pure-Python parts of the K3 and K6 launchers, on the CPU.

K3's launcher (``repro_torch/kernels/semiring.py``) picks one of three CUDA
kernels by shape and, for the tiled one, an output tile; K6's launcher
(``kernels/flash_attention.py``) bounds the grid by query tiles.  Neither
choice changes a result (the kernels are held against their plain versions
on the card by ``tests/test_torch_cuda.py``), but a wrong choice sends a
shape to a kernel that does not take it, so the dispatch is checked here
with a stand-in for the compiled library that records each call.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import backend  # noqa: E402
from repro_torch.kernels import flash_attention as flash_launcher  # noqa: E402
from repro_torch.kernels import semiring  # noqa: E402


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
