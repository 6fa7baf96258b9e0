"""K7 launcher: the SSD intra-chunk kernel through ``csrc/ssd_chunk.cu``.

Replaces ``repro/kernels/ssd_chunk.py::ssd_chunk``.  One launch covers every
flattened program p = (batch, chunk, head): per program, one block for each
64-row tile of y and one block for the state contribution S_c (see the note
at the top of the source).  The plain version is
``kernels/ref.py::ssd_chunk_ref``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .checks import MAX_SMEM_BYTES, check_status, require, stream

SOURCE = "ssd_chunk"
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "repro_ssd_chunk": (_I, [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
    "repro_ssd_chunk_smem_bytes": (ctypes.c_longlong, [_I, _I, _I]),
}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def launch(
    lib: ctypes.CDLL,
    xdt: torch.Tensor,
    cs: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    S_prev: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """xdt (P, q, hp), cs (P, q, 1) f32, B and C (P, q, n) in xdt's dtype,
    S_prev (P, hp, n) f32 → (y (P, q, hp) f32, S_c (P, n, hp) f32)."""
    name = "ssd_chunk"
    require(
        xdt.dtype in DTYPES and B.dtype == xdt.dtype and C.dtype == xdt.dtype,
        f"{name}: xdt, B, C must all be float32 or all bfloat16, got "
        f"{xdt.dtype}, {B.dtype}, {C.dtype}",
    )
    require(
        cs.dtype == torch.float32 and S_prev.dtype == torch.float32,
        f"{name}: cs and S_prev must be float32, got {cs.dtype} and {S_prev.dtype}",
    )
    require(xdt.dim() == 3, f"{name}: xdt must be (P, q, hp), got {tuple(xdt.shape)}")
    P, q, hp = xdt.shape
    require(B.dim() == 3 and B.shape[:2] == (P, q), f"{name}: B must be ({P}, {q}, n)")
    n = B.shape[2]
    require(tuple(C.shape) == (P, q, n), f"{name}: C must be ({P}, {q}, {n})")
    require(tuple(cs.shape) == (P, q, 1), f"{name}: cs must be ({P}, {q}, 1)")
    require(tuple(S_prev.shape) == (P, hp, n), f"{name}: S_prev must be ({P}, {hp}, {n})")
    require(
        hp % 16 == 0 and n % 16 == 0 and 0 < hp <= 128 and 0 < n <= 128,
        f"{name}: hp and n must be multiples of 16 up to 128, got hp={hp}, n={n}",
    )
    smem = lib.repro_ssd_chunk_smem_bytes(q, hp, n)
    require(smem <= MAX_SMEM_BYTES, f"{name}: q={q} needs {smem} B of shared memory")
    y = torch.empty((P, q, hp), dtype=torch.float32, device=xdt.device)
    S_c = torch.empty((P, n, hp), dtype=torch.float32, device=xdt.device)
    status = lib.repro_ssd_chunk(
        xdt.data_ptr(), cs.data_ptr(), B.data_ptr(), C.data_ptr(), S_prev.data_ptr(),
        y.data_ptr(), S_c.data_ptr(), DTYPES[xdt.dtype], P, q, hp, n, stream(xdt),
    )
    check_status(status, name)
    return y, S_c
