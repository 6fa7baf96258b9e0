"""K1 launcher: reach chunk products through ``csrc/reach.cu``.

Replaces ``repro/kernels/reach.py::reach_chunk_product``.  One launch covers
every chunk: a grid of (chunks) × (ℓp / 32 column strips), each block walking
its chunk's k class ids over a bit-packed strip of the product (see the note
at the top of the source).  The plain version is
``kernels/ref.py::reach_chunk_product_ref``.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.matrices import pack_bits_torch
from .checks import MAX_SMEM_BYTES, check_ids, check_status, check_table, require, stream

SOURCE = "reach"
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "repro_reach_products": (_I, [_P, _P, _P, _I, _I, _I, _P]),
    "repro_reach_smem_bytes": (ctypes.c_longlong, [_I]),
}


def launch(lib: ctypes.CDLL, N: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """N (A+1, ℓp, ℓp) f32, ids (C, k) int32 → (C, ℓp, ℓp) f32 products."""
    name = "reach_chunk_product"
    lp = check_table(name, N)
    check_ids(name, ids, N.shape[0])
    smem = lib.repro_reach_smem_bytes(lp)
    require(smem <= MAX_SMEM_BYTES, f"{name}: ℓp={lp} needs {smem} B of shared memory")
    C, k = ids.shape
    nr = pack_bits_torch(N)                           # (A+1, ℓp, W) row-packed
    out = torch.empty((C, lp, lp), dtype=torch.float32, device=N.device)
    status = lib.repro_reach_products(
        nr.data_ptr(), ids.data_ptr(), out.data_ptr(), C, k, lp, stream(N)
    )
    check_status(status, name)
    return out
