"""K4 launcher: packed reach chunk products through ``csrc/packed_reach.cu``,
and the plan and launch that K4 and K5 (``kernels/sparse_reach.py``) share.

Replaces ``repro/kernels/packed_reach.py::packed_reach_chunk_product``.  One
launch covers every chunk.  :func:`plan` picks one of the source's two
kernels by the table's size: the walk kernel, one lane a row walking over a
group table that each block builds in shared memory from Np, with the widest
group ``g`` of ``GROUPS`` whose table fits; else the fold kernel, a grid of
(chunks) × (row groups) that copies N[x_t] into shared memory at every step
(see the note at the top of the source).  K4 folds the identity rows, K5 the
rows it is given.  Np may be a tenant stack (T, A+1, ℓp, W) whose tenants own
equal runs of the chunks (the fleet's bucket dispatch): the walk kernel's
grid then has a tenant dimension and each block builds its own tenant's
table; the fold kernel reads each chunk's tenant's table.  The plain version is
``kernels/ref.py::packed_reach_chunk_product_ref``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .checks import MAX_SMEM_BYTES, check_fold, check_ids, check_status, require, stream, tenants
from .cost import INT8_OPS, Cost, total
from .reach import GROUPS, MAX_GROUP_W

SOURCE = "packed_reach"
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "repro_packed_walk": (_I, [_P, _P, _P, _P] + [_I] * 9 + [_P]),
    "repro_packed_reach_products": (_I, [_P, _P, _P, _I, _I, _I, _I, _I, _P]),
}
FOLD_THREADS = 256        # threads of one fold-kernel block


def lanes(rows: int) -> Tuple[int, int]:
    """(chunks a warp, warps a chunk) of the walk kernel for ``rows`` rows a
    chunk: below 32 rows a warp walks the rows of 32 // rows chunks (its
    other lanes idle), else each warp a 32-row strip of one chunk."""
    if rows < 32:
        return 32 // rows, 1
    return 1, -(-rows // 32)


def class_stride(lp: int, g: int, rows: int) -> int:
    """Words of one class in the walk kernel's table: ℓp/g groups of 2^g
    entries of W|1 words, padded where a warp walks cpw > 1 chunks (so looks
    up to cpw classes at once) to ≡ 32 / 2^⌈log2 cpw⌉ mod 32, so that one
    value of a group in the classes of a warp's chunks lies in distinct
    banks."""
    words = (lp // g) * (1 << g) * ((lp // 32) | 1)
    cpw, _ = lanes(rows)
    if cpw == 1:
        return words
    return words + ((32 >> (cpw - 1).bit_length()) - words) % 32


def walk_table_bytes(n_classes: int, lp: int, rows: int, g: int) -> int:
    """Shared memory of the walk kernel's table for ``n_classes`` classes."""
    return n_classes * class_stride(lp, g, rows) * 4


def fold_smem_bytes(lp: int, rows: int) -> int:
    """Shared memory of one fold-kernel block: two copies of N[x] and of the
    block's rows."""
    W = lp // 32
    rpb = max(1, min(FOLD_THREADS // W, rows))
    return (2 * lp * W + 2 * rpb * W) * 4


def plan(n_classes: int, lp: int, rows: int) -> Tuple[str, int]:
    """Kernel for folding ``rows`` rows a chunk over ``n_classes`` (ℓp, W)
    packed tables: ``("walk", g)`` with the widest g of ``GROUPS`` whose
    table fits in one block's shared memory (ℓp ≤ 512), else ``("fold", 0)``
    (ℓp ≤ 960); raises beyond that."""
    if lp // 32 <= MAX_GROUP_W:
        for g in GROUPS:
            if walk_table_bytes(n_classes, lp, rows, g) <= MAX_SMEM_BYTES:
                return "walk", g
    need = fold_smem_bytes(lp, rows)
    require(need <= MAX_SMEM_BYTES,
            f"packed reach: ℓp={lp} with {rows} rows needs {need} B of shared memory")
    return "fold", 0


def grid(n_classes: int, lp: int, rows: int, n_chunks: int, n_tenants: int = 1,
         sms: int = 132, per_sm: int = 1) -> Tuple[int, int, int]:
    """(grid x, grid y, threads a block) of the launch that :func:`plan`
    picks, as the source's launcher sizes it on ``sms`` SMs with ``per_sm``
    resident blocks an SM: the walk kernel's (blocks a tenant, tenants),
    about as many warps an SM as there are units (a warp's chunks of one
    tenant, or a 32-row strip), the resident blocks shared out over the
    tenants; the fold kernel's (chunks, row groups)."""
    kind, _ = plan(n_classes, lp, rows)
    W = lp // 32
    if kind == "fold":
        rpb = max(1, min(FOLD_THREADS // W, rows))
        return n_chunks, -(-rows // rpb), rpb * W
    cpw, strips = lanes(rows)
    tenant_units = -(-(n_chunks // n_tenants) // cpw) * strips
    wpb = min(max(min(-(-tenant_units * n_tenants // sms), tenant_units), 1), 32)
    blocks = min(-(-tenant_units // wpb), max(sms * per_sm // n_tenants, 1))
    return blocks, n_tenants, 32 * wpb


def shapes(Np, ids):
    """The output's (shape, dtype): (C, ℓp, W) int32 packed products."""
    return (ids.shape[0], Np.shape[-2], Np.shape[-1]), torch.int32


def cost(Np, ids, *, steps=None, ell=None) -> Cost:
    """2·ℓ³ operations a step (K1's product, on words) over ``steps`` steps
    (default all C·k) and ℓ live states (default ℓp); bytes: the ids, Np and
    the products, each once."""
    C, k = ids.shape
    lp, W = Np.shape[-2], Np.shape[-1]
    steps = C * k if steps is None else steps
    ell = lp if ell is None else ell
    return Cost(total(lambda s, e: 2 * s * e ** 3, steps, ell),
                4.0 * (C * k + Np.numel() + C * lp * W), INT8_OPS)


def fold_rows(
    lib: ctypes.CDLL, name: str, Np: torch.Tensor, ids: torch.Tensor,
    R0: Optional[torch.Tensor],
) -> torch.Tensor:
    """Np (A+1, ℓp, W) int32, or a tenant stack (T, A+1, ℓp, W) whose
    tenants own equal runs of the chunks; ids (C, k) int32 and R0 (C, rows,
    W) int32, or None for the ℓp identity rows → (C, rows, W) int32 folded
    rows, through the kernel that :func:`plan` picks."""
    rows = Np.shape[-2] if R0 is None else R0.shape[1]
    lp, W = check_fold(name, Np, rows)
    T, _ = tenants(name, Np, ids)
    A1 = Np.shape[-3]
    kind, g = plan(A1, lp, rows)
    C, k = ids.shape
    out = torch.empty((C, rows, W), dtype=torch.int32, device=Np.device)
    r0 = None if R0 is None else R0.data_ptr()
    if kind == "walk":
        status = lib.repro_packed_walk(
            Np.data_ptr(), ids.data_ptr(), r0, out.data_ptr(), A1, C, k, lp, rows, g,
            lanes(rows)[0], class_stride(lp, g, rows), T, stream(Np),
        )
    elif R0 is None:
        status = lib.repro_packed_reach_products(
            Np.data_ptr(), ids.data_ptr(), out.data_ptr(), C, k, lp, A1, T, stream(Np)
        )
    else:
        status = lib.repro_sparse_reach_rows(
            Np.data_ptr(), ids.data_ptr(), r0, out.data_ptr(), C, k, lp, rows, A1, T, stream(Np)
        )
    check_status(status, name)
    return out


def launch(lib: ctypes.CDLL, Np: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Np ([T,] A+1, ℓp, W) int32, ids (C, k) int32 → (C, ℓp, W) int32
    products."""
    name = "packed_reach_chunk_product"
    check_ids(name, ids)
    return fold_rows(lib, name, Np, ids, None)
