"""K2 launcher: fused build&merge through ``csrc/build_merge.cu``.

Replaces ``repro/kernels/build.py::build_merge_chunk``.  One launch covers
every chunk (one block each, one thread per state row) and emits the clean
columns already packed, so no (C, k, ℓp) f32 buffer exists.  The plain
version is ``kernels/ref.py::build_merge_packed_ref``.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.matrices import pack_bits_torch
from .checks import check_ids, check_status, check_table, require, stream

SOURCE = "build_merge"
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "repro_build_merge_packed": (_I, [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P]),
}


def launch(
    lib: ctypes.CDLL,
    N: torch.Tensor,
    ids: torch.Tensor,
    entry_f: torch.Tensor,
    entry_b: torch.Tensor,
) -> torch.Tensor:
    """N (A+1, ℓp, ℓp) f32, ids (C, k) int32, entries (C, ℓp) f32 →
    (C, k, ℓp/32) int32 packed clean columns."""
    name = "build_merge_packed"
    lp = check_table(name, N)
    require(lp <= 1024, f"{name}: ℓp={lp} exceeds one thread per state (1024)")
    check_ids(name, ids, N.shape[0])
    C, k = ids.shape
    for e in (entry_f, entry_b):
        require(
            e.dtype == torch.float32 and tuple(e.shape) == (C, lp),
            f"{name}: entries must be float32 ({C}, {lp}), got {e.dtype} {tuple(e.shape)}",
        )
    nr = pack_bits_torch(N)                           # row-packed
    nc = pack_bits_torch(N.transpose(-1, -2))         # column-packed
    out = torch.empty((C, k, lp // 32), dtype=torch.int32, device=N.device)
    status = lib.repro_build_merge_packed(
        nr.data_ptr(), nc.data_ptr(), ids.data_ptr(), entry_f.data_ptr(),
        entry_b.data_ptr(), out.data_ptr(), C, k, lp, stream(N),
    )
    check_status(status, name)
    return out
