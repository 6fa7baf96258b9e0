"""K1 launcher: reach chunk products through ``csrc/reach.cu``.

Replaces ``repro/kernels/reach.py::reach_chunk_product``.  One launch covers
every chunk, of one table or of a tenant stack of tables (T, A+1, ℓp, ℓp)
whose tenants own equal runs of the chunks (the fleet's bucket dispatch):
the group kernel's grid has a tenant dimension, and each block builds only
its tenant's table; the strip kernel reads each chunk's own tenant's table.
:func:`plan` picks one of the source's two kernels by the size of one table: the group kernel, one thread a column walking over a group
table (:func:`group_table`) held in shared memory, with the widest group
``g`` of ``GROUPS`` whose table fits; else the strip kernel, a grid of
(chunks) × (ℓp / 32 column strips) folding row-packed N (see the note at the
top of the source).  Where a window is kept with N (``kernels/window.py``:
the fleet's buckets padded past their live states), the group kernel walks
and tabulates only the ℓ' live states and writes the padded part of each
product from the block algebra; so e125's ℓp-512 bucket walks its 288 live
states in a 166 KB table, where a table of all 512 would not fit.  The plain
version is ``kernels/ref.py::reach_chunk_product_ref``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.matrices import pack_bits_torch
from .checks import (
    MAX_SMEM_BYTES, check_ids, check_status, check_table, derived, require, stream, tenants,
)
from .cost import INT8_OPS, Cost, total
from .window import attached

SOURCE = "reach"
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "repro_reach_products": (_I, [_P, _P, _P, _I, _I, _I, _I, _I, _P]),
    "repro_reach_group": (_I, [_P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _P, _I, _P]),
}
# group widths, widest (fewest lookups a step) first; g = 1 would need as
# many table bytes as g = 2 (2^g / g entries a state) for twice the lookups
GROUPS = (4, 2)
MAX_GROUP_W = 16          # the group kernel holds a column in W ≤ 16 words: ℓp ≤ 512
STRIP = 32


def group_table_bytes(n_classes: int, lp: int, g: int) -> int:
    """Bytes of :func:`group_table` for ``n_classes`` (ℓp, ℓp) tables."""
    return n_classes * (lp // g) * (1 << g) * ((lp // 32) | 1) * 4


def strip_smem_bytes(lp: int) -> int:
    """Shared memory of one strip-kernel block: two row-packed N[x] and two
    bit strips."""
    W = lp // 32
    return (2 * lp * W + 2 * STRIP * W) * 4


def plan(n_classes: int, lp: int, lw: Optional[int] = None) -> Tuple[str, int]:
    """Kernel for ``n_classes`` (ℓp, ℓp) tables whose live window is ``lw``
    states (default ℓp): ``("group", g)`` with the widest g of ``GROUPS``
    whose table of the ℓ' = ``lw`` live states fits in one block's shared
    memory (ℓ' ≤ 512), else ``("strip", 0)`` over all ℓp (ℓp ≤ 928); raises
    beyond that."""
    lw = lp if lw is None else lw
    if lw // 32 <= MAX_GROUP_W:
        for g in GROUPS:
            if group_table_bytes(n_classes, lw, g) <= MAX_SMEM_BYTES:
                return "group", g
    require(
        strip_smem_bytes(lp) <= MAX_SMEM_BYTES,
        f"reach_chunk_product: ℓp={lp} needs {strip_smem_bytes(lp)} B of shared memory",
    )
    return "strip", 0


def grid(n_classes: int, lp: int, n_chunks: int, n_tenants: int = 1,
         sms: int = 132, per_sm: int = 1, lw: Optional[int] = None) -> Tuple[int, int, int]:
    """(grid x, grid y, threads a block) of the launch that :func:`plan`
    picks, as the source's launcher sizes it on ``sms`` SMs with ``per_sm``
    resident blocks an SM: the group kernel's (blocks a tenant, tenants),
    about as many warps an SM as there are units of 32 live columns (at
    most a tenant's units a block), the resident blocks shared out over the
    tenants; the strip kernel's
    (chunks, ℓp / 32 strips)."""
    kind, _ = plan(n_classes, lp, lw)
    if kind == "strip":
        return n_chunks, lp // STRIP, 128
    W = (lp if lw is None else lw) // 32
    tenant_units = n_chunks // n_tenants * W
    wpb = min(max(min(-(-n_chunks * W // sms), tenant_units), 1), 32)
    blocks = -(-tenant_units // wpb)
    return min(blocks, max(sms * per_sm // n_tenants, 1)), n_tenants, 32 * wpb


def group_table(N: torch.Tensor, g: int) -> torch.Tensor:
    """(…, A+1, ℓp/g, 2^g, W|1) int32 group table of N (…, A+1, ℓp, ℓp)
    {0,1}, per leading index (a tenant stack gives one table a tenant).

    Entry [x][grp][v] is the OR of the columns grp·g + b of N[x] over the set
    bits b of v, packed over the rows as ``pack_bits`` packs (bit i of word w
    is row 32·w + i); a word beyond W, when W is even, is zero.
    """
    *lead, A1, lp, _ = N.shape
    V = 1 << g
    v = torch.arange(V, device=N.device)
    bits = ((v[:, None] >> torch.arange(g, device=N.device)[None, :]) & 1).to(N.dtype)
    cols = N.transpose(-1, -2).reshape(*lead, A1, lp // g, g, lp)   # [x][grp][b][row]
    T = torch.clamp(torch.einsum("vb,...xcbi->...xcvi", bits, cols), max=1.0)
    words = pack_bits_torch(T)                                      # (…, A+1, ℓp/g, 2^g, W)
    W = lp // 32
    return F.pad(words, (0, (W | 1) - W))


def tenant_group_tables(N: torch.Tensor, g: int) -> torch.Tensor:
    """(T, words) int32: each tenant's :func:`group_table`, flat and padded
    to a multiple of 4 words (the kernel copies whole 16-byte vectors); a
    shared table N (A+1, ℓp, ℓp) is one tenant."""
    T = 1 if N.dim() == 3 else N.shape[0]
    flat = group_table(N, g).reshape(T, -1)
    return F.pad(flat, (0, -flat.shape[1] % 4)).contiguous()


def shapes(N, ids):
    """The output's (shape, dtype): (C, ℓp, ℓp) f32 products."""
    lp = N.shape[-1]
    return (ids.shape[0], lp, lp), torch.float32


def cost(N, ids, *, steps=None, ell=None) -> Cost:
    """2·ℓ³ operations a step (one ℓ × ℓ Boolean product) over ``steps``
    steps (default every one of the C·k) and ℓ live states (default ℓp);
    bytes: the ids, N and the products, each once."""
    C, k = ids.shape
    lp = N.shape[-1]
    steps = C * k if steps is None else steps
    ell = lp if ell is None else ell
    return Cost(total(lambda s, e: 2 * s * e ** 3, steps, ell),
                4.0 * (C * k + N.numel() + C * lp * lp), INT8_OPS)


def launch(lib: ctypes.CDLL, N: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """N (A+1, ℓp, ℓp) f32, or a tenant stack (T, A+1, ℓp, ℓp) whose tenants
    own equal runs of the chunks; ids (C, k) int32 → (C, ℓp, ℓp) f32
    products.  What is derived from N (the group tables, the row-packed
    table) is kept while N lives (``checks.derived``); so is its window, if
    one was attached (``window.attach``), which the group kernel walks."""
    name = "reach_chunk_product"
    lp = check_table(name, N)
    check_ids(name, ids)
    T, cpt = tenants(name, N, ids)
    win = attached(N)
    lw = lp if win is None else win.width
    kind, g = plan(N.shape[-3], lp, lw)
    C, k = ids.shape
    out = torch.empty((C, lp, lp), dtype=torch.float32, device=N.device)
    if kind == "group":
        tab = derived(N, f"reach/group{g}/{lw}", lambda: tenant_group_tables(N[..., :lw, :lw], g))
        status = lib.repro_reach_group(
            tab.data_ptr(), tab.shape[1], ids.data_ptr(), out.data_ptr(), C, k, lp, g, T,
            lw, win.ident.data_ptr() if lw < lp else None, N.shape[-3], stream(N),
        )
    else:
        nr = derived(N, "rows", lambda: pack_bits_torch(N))     # ([T,] A+1, ℓp, W) row-packed
        status = lib.repro_reach_products(
            nr.data_ptr(), ids.data_ptr(), out.data_ptr(), C, k, lp, N.shape[-3], T, stream(N)
        )
    check_status(status, name)
    return out
