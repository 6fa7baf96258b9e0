"""K3 launcher: batched Boolean matmul through ``csrc/semiring.cu``.

Replaces ``repro/kernels/semiring.py::semiring_matmul``.  In the port it is
the ``cuda`` backend's compose and the join's combine and act.  The plain
version is ``kernels/ref.py::semiring_matmul_ref``.
"""

from __future__ import annotations

import ctypes

import torch

from .checks import check_status, require, stream

SOURCE = "semiring"
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "repro_semiring_matmul": (_I, [_P, _P, _P, _I, _I, _I, _I, _P]),
}


def launch(lib: ctypes.CDLL, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(n, m, k) × (n, k, n') {0,1} f32 → clamp(a @ b) (n, m, n') f32."""
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
    status = lib.repro_semiring_matmul(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), batch, m, n, k, stream(a)
    )
    check_status(status, name)
    return out
