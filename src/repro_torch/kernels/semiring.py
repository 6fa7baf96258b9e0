"""K3 launcher: batched Boolean matmul through ``csrc/semiring.cu``.

Replaces ``repro/kernels/semiring.py::semiring_matmul``.  In the port it is
the ``cuda`` backend's compose and the join's combine and act.  :func:`plan`
picks one of the source's three kernels by shape: the mat-vec (n == 1), the
vec-mat (m == 1), or the tensor-core tiled kernel with the output tile that
pads least.  The plain version is ``kernels/ref.py::semiring_matmul_ref``.

The operands are f32 holding only 0 and 1, as every caller's Boolean
matrices do: the tiled kernel rounds them to bf16, which is exact on {0, 1}
(and an f32 accumulator is exact below 2^24), and would round other values.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .checks import check_status, require, stream
from .cost import INT8_OPS, Cost

SOURCE = "semiring"
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "repro_semiring_matmul": (_I, [_P, _P, _P, _I, _I, _I, _I, _I, _P]),
    "repro_semiring_matvec": (_I, [_P, _P, _P, _I, _I, _I, _P]),
    "repro_semiring_vecmat": (_I, [_P, _P, _P, _I, _I, _I, _P]),
}
TILES = (64, 96)   # output tiles of the tiled kernel


def plan(m: int, n: int) -> Tuple[str, int]:
    """Kernel for an (·, m, k) × (·, k, n) product, and its output tile.

    ``("matvec", 0)`` for n == 1, ``("vecmat", 0)`` for m == 1, else
    ``("tiled", T)`` with the T of ``TILES`` whose tile grid covers the
    fewest padded elements (the larger T on a tie: fewer re-reads).
    """
    if n == 1:
        return "matvec", 0
    if m == 1:
        return "vecmat", 0
    cover = {t: -(-m // t) * -(-n // t) * t * t for t in TILES}
    return "tiled", min(TILES, key=lambda t: (cover[t], -t))


def shapes(a, b):
    """The output's (shape, dtype): (n, m, n') f32."""
    return (a.shape[0], a.shape[1], b.shape[2]), torch.float32


def cost(a, b, *, ell=None) -> Cost:
    """2·m·k·n' operations a product of the batch, each of m, k, n' that is
    not 1 counted at ``ell`` live states where given (the parser's ℓ of ℓp);
    bytes: both operands and the output, each once."""
    batch, m, k = a.shape
    n = b.shape[2]
    live = [d if ell is None or d == 1 else ell for d in (m, k, n)]
    return Cost(2.0 * batch * live[0] * live[1] * live[2],
                4.0 * batch * (m * k + k * n + m * n), INT8_OPS)


def launch(lib: ctypes.CDLL, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(n, m, k) × (n, k, n') f32 → clamp(a @ b) (n, m, n') f32; the
    operands must hold only 0 and 1 (see the module note)."""
    name = "semiring_matmul"
    require(
        a.dtype == torch.float32 and b.dtype == torch.float32,
        f"{name}: operands must be float32, got {a.dtype} and {b.dtype}",
    )
    require(
        a.dim() == 3 and b.dim() == 3 and a.shape[0] == b.shape[0]
        and a.shape[2] == b.shape[1],
        f"{name}: need (b, m, k) x (b, k, n), got {tuple(a.shape)} x {tuple(b.shape)}",
    )
    batch, m, k = a.shape
    n = b.shape[2]
    out = torch.empty((batch, m, n), dtype=torch.float32, device=a.device)
    kind, tile = plan(m, n)
    if kind == "matvec":
        status = lib.repro_semiring_matvec(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), batch, m, k, stream(a)
        )
    elif kind == "vecmat":
        status = lib.repro_semiring_vecmat(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), batch, k, n, stream(a)
        )
    else:
        status = lib.repro_semiring_matmul(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), batch, m, n, k, tile, stream(a)
        )
    check_status(status, name)
    return out
