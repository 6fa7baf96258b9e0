"""K4 launcher: packed reach chunk products through ``csrc/packed_reach.cu``.

Replaces ``repro/kernels/packed_reach.py::packed_reach_chunk_product``.  One
launch covers every chunk: a grid of (chunks) × (row groups), each block
folding its chunk's k characters over packed rows seeded with the identity
(see the note at the top of the source).  The plain version is
``kernels/ref.py::packed_reach_chunk_product_ref``.
"""

from __future__ import annotations

import ctypes

import torch

from .checks import check_fold, check_ids, check_status, stream

SOURCE = "packed_reach"
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "repro_packed_reach_products": (_I, [_P, _P, _P, _I, _I, _I, _P]),
    "repro_packed_fold_smem_bytes": (ctypes.c_longlong, [_I, _I]),
}


def launch(lib: ctypes.CDLL, Np: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Np (A+1, ℓp, W) int32, ids (C, k) int32 → (C, ℓp, W) int32 products."""
    name = "packed_reach_chunk_product"
    lp, W = check_fold(name, lib, Np, Np.shape[1])
    check_ids(name, ids, Np.shape[0])
    C, k = ids.shape
    out = torch.empty((C, lp, W), dtype=torch.int32, device=Np.device)
    status = lib.repro_packed_reach_products(
        Np.data_ptr(), ids.data_ptr(), out.data_ptr(), C, k, lp, stream(Np)
    )
    check_status(status, name)
    return out
