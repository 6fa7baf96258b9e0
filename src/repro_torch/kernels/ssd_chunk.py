"""K7 launcher: the SSD intra-chunk kernel through ``csrc/ssd_chunk.cu``.

Replaces ``repro/kernels/ssd_chunk.py::ssd_chunk``.  One launch covers every
flattened program p = (batch, chunk, head) and computes the outputs asked for
(``outputs``: ``"both"``, ``"state"`` for S_c alone, ``"y"`` for y alone).
:func:`plan` picks one of the source's three kernels: for bf16 operands the
tensor-core kernel (one block a program and role, the program's operands in
shared memory), for f32 operands the 3xTF32 tensor-core kernel (the same
roles, B and xdt streamed through a ring of row tiles), each where its
program fits, else the SIMT kernel (see the note at the top of the source).
The plain version is ``kernels/ref.py::ssd_chunk_ref``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .checks import MAX_SMEM_BYTES, check_status, require, stream
from .cost import Cost, float_rate

SOURCE = "ssd_chunk"
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "repro_ssd_chunk": (_I, [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]),
    "repro_ssd_chunk_smem_bytes": (ctypes.c_longlong, [_I, _I, _I]),
    "repro_ssd_chunk_tc_smem_bytes": (ctypes.c_longlong, [_I, _I, _I, _I]),
    "repro_ssd_chunk_tf32_smem_bytes": (ctypes.c_longlong, [_I, _I, _I, _I]),
}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
OUTPUTS = {"y": 1, "state": 2, "both": 3}     # the source's roles
KERNELS = {"simt": 0, "mma": 1, "tf32": 2}
# the tensor-core kernel of each operand type, and the C function that sizes it
TENSOR_CORE = {torch.bfloat16: ("mma", "repro_ssd_chunk_tc_smem_bytes"),
               torch.float32: ("tf32", "repro_ssd_chunk_tf32_smem_bytes")}


def shapes(xdt, cs, B, C, S_prev, *, outputs="both"):
    """The outputs' (shape, dtype): y (P, q, hp) f32 and S_c (P, n, hp)
    f32, each None where ``outputs`` does not ask for it."""
    P, q, hp = xdt.shape
    n = B.shape[2]
    return ((P, q, hp), torch.float32) if outputs in ("both", "y") else None, \
        ((P, n, hp), torch.float32) if outputs in ("both", "state") else None


def cost(xdt, cs, B, C, S_prev, *, outputs="both") -> Cost:
    """By ``outputs``: y reads xdt, cs, B, C, S_prev and writes y with
    q(q+1)(n + hp) + 2qn·hp operations a program (C·Bᵀ and (L∘CB)·xdt over
    the triangle, C·S_prevᵀ); S_c reads xdt, cs, B and writes S_c with
    2qn·hp; ``"both"``, the union; at the rate of the operands' type."""
    P, q, hp = xdt.shape
    n = B.shape[2]
    e = xdt.element_size()
    ops_y = q * (q + 1) * (n + hp) + 2.0 * q * n * hp
    ops_s = 2.0 * q * n * hp
    common = q * hp * e + 4 * q + q * n * e                     # xdt, cs, B
    bytes_y = q * n * e + 4 * hp * n + 4 * q * hp                # C, S_prev, y
    bytes_s = 4 * n * hp                                         # S_c
    n_ops = P * {"y": ops_y, "state": ops_s}.get(outputs, ops_y + ops_s)
    n_bytes = P * (common + {"y": bytes_y, "state": bytes_s}.get(outputs, bytes_y + bytes_s))
    return Cost(float(n_ops), float(n_bytes), float_rate(xdt.dtype))


def plan(lib, xdt: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
         S_prev: Optional[torch.Tensor], outputs: str) -> str:
    """The tensor-core kernel of the operands' type (``"mma"`` for bf16,
    ``"tf32"`` for f32) where its program fits one block's shared memory and
    the tensors are 16-byte aligned (its copies move 16 bytes at a time),
    else ``"simt"``."""
    _, q, hp = xdt.shape
    n = B.shape[2]
    kernel, smem_fn = TENSOR_CORE[xdt.dtype]
    smem = getattr(lib, smem_fn)(q, hp, n, OUTPUTS[outputs])
    aligned = all(t.data_ptr() % 16 == 0 for t in (xdt, B, C, S_prev) if t is not None)
    if 0 < smem <= MAX_SMEM_BYTES and aligned:
        return kernel
    smem = lib.repro_ssd_chunk_smem_bytes(q, hp, n)
    require(smem <= MAX_SMEM_BYTES, f"ssd_chunk: q={q} needs {smem} B of shared memory")
    return "simt"


def launch(
    lib: ctypes.CDLL,
    xdt: torch.Tensor,
    cs: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    S_prev: Optional[torch.Tensor],
    *,
    outputs: str = "both",
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """xdt (P, q, hp), cs (P, q, 1) f32, B and C (P, q, n) in xdt's dtype,
    S_prev (P, hp, n) f32 (None for ``outputs="state"``, which does not read
    it) → (y (P, q, hp) f32, S_c (P, n, hp) f32), each None where
    ``outputs`` does not ask for it."""
    name = "ssd_chunk"
    require(outputs in OUTPUTS, f"{name}: outputs must be one of {sorted(OUTPUTS)}, got {outputs!r}")
    require(
        xdt.dtype in DTYPES and B.dtype == xdt.dtype and C.dtype == xdt.dtype,
        f"{name}: xdt, B, C must all be float32 or all bfloat16, got "
        f"{xdt.dtype}, {B.dtype}, {C.dtype}",
    )
    want_y, want_s = outputs in ("both", "y"), outputs in ("both", "state")
    require(S_prev is not None or not want_y, f"{name}: outputs={outputs!r} needs S_prev")
    require(cs.dtype == torch.float32, f"{name}: cs must be float32, got {cs.dtype}")
    require(
        S_prev is None or S_prev.dtype == torch.float32,
        f"{name}: S_prev must be float32, got {getattr(S_prev, 'dtype', None)}",
    )
    require(xdt.dim() == 3, f"{name}: xdt must be (P, q, hp), got {tuple(xdt.shape)}")
    P, q, hp = xdt.shape
    require(B.dim() == 3 and B.shape[:2] == (P, q), f"{name}: B must be ({P}, {q}, n)")
    n = B.shape[2]
    require(tuple(C.shape) == (P, q, n), f"{name}: C must be ({P}, {q}, {n})")
    require(tuple(cs.shape) == (P, q, 1), f"{name}: cs must be ({P}, {q}, 1)")
    require(
        S_prev is None or tuple(S_prev.shape) == (P, hp, n),
        f"{name}: S_prev must be ({P}, {hp}, {n})",
    )
    require(
        hp % 16 == 0 and n % 16 == 0 and 0 < hp <= 128 and 0 < n <= 128,
        f"{name}: hp and n must be multiples of 16 up to 128, got hp={hp}, n={n}",
    )
    kernel = plan(lib, xdt, B, C, S_prev, outputs)
    y = torch.empty((P, q, hp), dtype=torch.float32, device=xdt.device) if want_y else None
    S_c = torch.empty((P, n, hp), dtype=torch.float32, device=xdt.device) if want_s else None
    status = lib.repro_ssd_chunk(
        xdt.data_ptr(), cs.data_ptr(), B.data_ptr(), C.data_ptr(),
        S_prev.data_ptr() if S_prev is not None else None,
        y.data_ptr() if want_y else None, S_c.data_ptr() if want_s else None,
        DTYPES[xdt.dtype], P, q, hp, n, OUTPUTS[outputs], KERNELS[kernel], stream(xdt),
    )
    check_status(status, name)
    return y, S_c
