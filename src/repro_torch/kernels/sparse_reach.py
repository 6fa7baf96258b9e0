"""K5 launcher: sparse reach rows through ``csrc/packed_reach.cu``.

Replaces ``repro/kernels/sparse_reach.py::sparse_reach_rows``.  The same
kernel as K4 (``kernels/packed_reach.py``), seeded from the S gathered
feasible-start rows R0 instead of the identity; one launch covers every
chunk.  The plain version is ``kernels/ref.py::sparse_reach_rows_ref``.
"""

from __future__ import annotations

import ctypes

import torch

from .checks import check_fold, check_ids, check_status, require, stream

SOURCE = "packed_reach"
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "repro_sparse_reach_rows": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _P]),
    "repro_packed_fold_smem_bytes": (ctypes.c_longlong, [_I, _I]),
}


def launch(
    lib: ctypes.CDLL, Np: torch.Tensor, ids: torch.Tensor, R0: torch.Tensor
) -> torch.Tensor:
    """Np (A+1, ℓp, W) int32, ids (C, k) int32, R0 (C, S, W) int32 →
    (C, S, W) int32 folded rows."""
    name = "sparse_reach_rows"
    check_ids(name, ids, Np.shape[0])
    C, k = ids.shape
    require(
        R0.dtype == torch.int32 and R0.dim() == 3 and R0.shape[0] == C,
        f"{name}: R0 must be int32 ({C}, S, W), got {R0.dtype} {tuple(R0.shape)}",
    )
    S = R0.shape[1]
    lp, W = check_fold(name, lib, Np, S)
    require(R0.shape[2] == W, f"{name}: R0 rows must have W={W} words, got {R0.shape[2]}")
    out = torch.empty((C, S, W), dtype=torch.int32, device=Np.device)
    status = lib.repro_sparse_reach_rows(
        Np.data_ptr(), ids.data_ptr(), R0.data_ptr(), out.data_ptr(), C, k, lp, S,
        stream(Np),
    )
    check_status(status, name)
    return out
