"""K5 launcher: sparse reach rows through ``csrc/packed_reach.cu``.

Replaces ``repro/kernels/sparse_reach.py::sparse_reach_rows``.  The same
kernels and plan as K4 (``kernels/packed_reach.py``), seeded from the S
gathered feasible-start rows R0 instead of the identity; one launch covers
every chunk, of one table or of a tenant stack.  The plain version is ``kernels/ref.py::sparse_reach_rows_ref``.
"""

from __future__ import annotations

import ctypes

import torch

from . import packed_reach
from .checks import check_ids, require
from .cost import INT8_OPS, Cost, total

SOURCE = "packed_reach"
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "repro_sparse_reach_rows": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]),
}


def shapes(Np, ids, R0):
    """The output's (shape, dtype): (C, S, W) int32 folded rows."""
    return tuple(R0.shape), torch.int32


def cost(Np, ids, R0, *, steps=None, ell=None, rows=None) -> Cost:
    """2·w̄·ℓ² operations a step (w̄ rows through an ℓ × ℓ table) over
    ``steps`` steps (default all C·k), ℓ live states (default ℓp) and w̄
    rows a chunk (default all S, the run's mean feasible width where it is
    known); bytes: the ids, Np, R0 and the output, each once."""
    C, k = ids.shape
    S, W = R0.shape[1], R0.shape[2]
    lp = Np.shape[-2]
    steps = C * k if steps is None else steps
    ell = lp if ell is None else ell
    rows = S if rows is None else rows
    return Cost(total(lambda s, w, e: 2 * s * w * e * e, steps, rows, ell),
                4.0 * (C * k + Np.numel() + 2 * C * S * W), INT8_OPS)


def launch(
    lib: ctypes.CDLL, Np: torch.Tensor, ids: torch.Tensor, R0: torch.Tensor
) -> torch.Tensor:
    """Np (A+1, ℓp, W) int32, or a tenant stack (T, A+1, ℓp, W) whose
    tenants own equal runs of the chunks; ids (C, k) int32, R0 (C, S, W)
    int32 → (C, S, W) int32 folded rows."""
    name = "sparse_reach_rows"
    check_ids(name, ids)
    C = ids.shape[0]
    require(
        R0.dtype == torch.int32 and R0.dim() == 3 and R0.shape[0] == C,
        f"{name}: R0 must be int32 ({C}, S, W), got {R0.dtype} {tuple(R0.shape)}",
    )
    require(R0.shape[2] == Np.shape[-1],
            f"{name}: R0 rows must have W={Np.shape[-1]} words, got {R0.shape[2]}")
    return packed_reach.fold_rows(lib, name, Np, ids, R0)
