"""The forest's columns on the card: ``unpack_columns`` through
``csrc/build_merge.cu``.

Replaces no TPU kernel: the reference unpacks the packed columns on the host
(``repro/core/engine.py::_assemble``).  One launch takes a bucket group's
packed C₀ (B, W) and columns (B, c, k, W), as the fused core returns them,
and writes each text's (n+1, ℓ) bool ``SLPF.columns``, row 0 C₀ and row r
packed row r − 1, into one buffer on the card: each text's bytes start at a
multiple of 16 (the kernel's 16-byte stores), so each text's view is
contiguous and comes back in one copy (``core/engine.py``).  The plain
version is ``kernels/ref.py::unpack_columns_ref``.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from .checks import check_status, require, stream
from .cost import INT8_OPS, Cost

SOURCE = "build_merge"
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SIGNATURES = {
    "repro_unpack_columns": (_I, [_P, _P, _P, _P, _I, _I, _I, _L, _L, _P]),
}
ALIGN = 16                # bytes: where each text's columns start in the buffer
MAX_TEXTS = 65535         # the launch's grid.y


def offsets(lengths: Sequence[int], ell: int) -> Tuple[list, int]:
    """Each text's byte offset in the buffer, and the buffer's bytes: the
    texts' (n+1)·ℓ bytes in turn, each rounded up to ``ALIGN``."""
    offs, at = [], 0
    for n in lengths:
        offs.append(at)
        at += -(-(n + 1) * ell // ALIGN) * ALIGN
    return offs, at


def shapes(col0, cols, *, lengths, ell):
    """The outputs' (shape, dtype): (n+1, ℓ) bool for each text."""
    return tuple(((n + 1, ell), torch.bool) for n in lengths)


def cost(col0, cols, *, lengths, ell) -> Cost:
    """No operations; bytes: each forest row's W words read once and its ℓ
    bytes written once, (n+1)·(4W + ℓ) a text."""
    rows = sum(n + 1 for n in lengths)
    return Cost(0.0, float(rows * (4 * col0.shape[-1] + ell)), INT8_OPS)


def launch(lib: ctypes.CDLL, col0: torch.Tensor, cols: torch.Tensor, *,
           lengths: Sequence[int], ell: int) -> Tuple[torch.Tensor, ...]:
    """col0 (B, W) and cols (B, c, k, W) int32 words; the first
    len(``lengths``) batch rows are texts of those lengths (n ≤ c·k), the
    rest padding → each text's (n+1, ℓ) bool columns, views of one buffer."""
    name = "unpack_columns"
    require(col0.dtype == torch.int32 and cols.dtype == torch.int32,
            f"{name}: words must be int32, got {col0.dtype} and {cols.dtype}")
    require(col0.dim() == 2 and cols.dim() == 4 and cols.shape[0] == col0.shape[0]
            and cols.shape[-1] == col0.shape[-1],
            f"{name}: col0 must be (B, W) and cols (B, c, k, W), got "
            f"{tuple(col0.shape)} and {tuple(cols.shape)}")
    B, c, k, W = cols.shape
    lengths = [int(n) for n in lengths]
    require(len(lengths) <= min(B, MAX_TEXTS),
            f"{name}: {len(lengths)} texts over {B} batch rows (at most {MAX_TEXTS})")
    require(all(0 <= n <= c * k for n in lengths),
            f"{name}: text lengths must lie in [0, {c * k}], got {lengths}")
    require(1 <= ell <= 32 * W, f"{name}: ℓ={ell} must lie in [1, {32 * W}]")
    offs, total = offsets(lengths, ell)
    out = torch.empty(total, dtype=torch.bool, device=cols.device)
    if lengths:
        meta = torch.tensor([v for n, off in zip(lengths, offs) for v in (n + 1, off)],
                            dtype=torch.int64).to(cols.device, non_blocking=True)
        status = lib.repro_unpack_columns(
            col0.data_ptr(), cols.data_ptr(), meta.data_ptr(), out.data_ptr(), len(lengths),
            W, ell, c * k, max(lengths) + 1, stream(cols),
        )
        check_status(status, name)
    return tuple(out[off:off + (n + 1) * ell].view(n + 1, ell)
                 for n, off in zip(lengths, offs))
