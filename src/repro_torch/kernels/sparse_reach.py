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

SOURCE = "packed_reach"
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "repro_sparse_reach_rows": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]),
}


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
