"""K2 launcher: fused build&merge through ``csrc/build_merge.cu``.

Replaces ``repro/kernels/build.py::build_merge_chunk``.  One launch covers
every chunk and emits the clean columns already packed, so no (C, k, ℓp) f32
buffer exists.  N may be a tenant stack (T, A+1, ℓp, ℓp) whose tenants own
equal runs of the chunks (the fleet's bucket dispatch): the walk kernel's
grid then has a tenant dimension and each block builds its own tenant's
tables; the row kernel reads each chunk's tenant's packed tables.  :func:`plan` picks one of the source's two kernels by the
table's size: the walk kernel, 8 lanes a chunk walking the frontier over
group tables that each block builds in shared memory from f32 N (nothing is
packed per call); else the row kernel, one block a chunk and one thread a
state row over N packed by this launcher (see the note at the top of the
source).  Where a window is kept with N (``kernels/window.py``), the walk
runs on the live block (the tables and entries of the ℓ' live states) into a
scratch of ℓ'/32 words a column, and the source's pad kernel writes the
ℓp/32-word columns: the walk's words, then the padded words from the block
algebra; so e125's ℓp-512 fleet bucket takes the walk at ℓ' = 288, as the
solo e125 parse does.  The plain version is
``kernels/ref.py::build_merge_packed_ref``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from ..core.matrices import pack_bits_torch
from .checks import (
    MAX_SMEM_BYTES, check_ids, check_status, check_table, derived, require, stream, tenants,
)
from .cost import INT8_OPS, Cost, total
from .reach import GROUPS, MAX_GROUP_W
from .window import attached

SOURCE = "build_merge"
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "repro_build_merge_packed": (_I, [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
    "repro_build_merge_walk": (_I, [_P, _P, _P, _P, _P] + [_I] * 10 + [_P]),
    "repro_build_merge_pad": (_I, [_P] * 6 + [_I] * 6 + [_P]),
}
ROUNDS = (128, 64, 32, 16, 8)   # steps a round of staged ids and rows, longest first
# lanes a chunk of the walk (the one count its source is built for): a step is
# then (ℓp/g)/8 lookups a lane and three __shfl_xor_sync rounds; measured on
# the H100 at 2, 4 and 8 lanes, 8 was fastest on TRAFFIC and e125
LANES = 8
SMS = 132                 # streaming multiprocessors of an H100 SXM, for the round
MAX_LP = 1024             # the row kernel's one thread a state


class Plan(NamedTuple):
    kernel: str           # "walk" or "rows"
    g: int                # group width (walk)
    lanes: int            # lanes a chunk (walk)
    round: int            # steps a round (walk)
    both: bool            # both tables stay in shared memory; else the backward one is rebuilt
    cls_stride: int       # words of one class in a table (walk)


ROWS = Plan("rows", 0, 0, 0, False, 0)


def class_stride(lp: int, g: int, lanes: int) -> int:
    """Words of one class in a walk table: ℓp/g groups of 2^g entries of
    W|1 words, padded where a warp walks 32/lanes > 1 chunks (so looks up
    that many classes at once) to ≡ 32 / 2^⌈log2 cpw⌉ mod 32, so that one
    entry of the classes of a warp's chunks lies in distinct banks (K4's
    rule)."""
    words = (lp // g) * (1 << g) * ((lp // 32) | 1)
    cpw = 32 // lanes
    if cpw == 1:
        return words
    return words + ((32 >> (cpw - 1).bit_length()) - words) % 32


def table_bytes(n_classes: int, lp: int, g: int, lanes: int) -> int:
    """Shared memory of one walk table (forward or backward)."""
    return n_classes * class_stride(lp, g, lanes) * 4


def ring_bytes(lp: int, lanes: int, rs: int) -> int:
    """Shared memory of one walking warp's ring: two rounds of ids and rows
    for each of its 32/lanes chunks, each run padded by a word."""
    return 4 * 2 * (32 // lanes) * ((rs + 1) + (rs * (lp // 32) + 1))


def walk_warps(n_chunks: int) -> int:
    """Walking warps a block, as the source's launcher counts them: one for
    each unit of 32/LANES chunks (of the launch, over all its tenants),
    spread over SMS SMs (one block an SM), 1 to 32."""
    units = -(-n_chunks // (32 // LANES))
    return min(max(-(-units // SMS), 1), 32)


def grid(n_classes: int, lp: int, n_chunks: int, n_tenants: int = 1,
         lw: Optional[int] = None) -> Tuple[int, int, int]:
    """(blocks a tenant, tenants, threads a block) of the launch that
    :func:`plan` picks, as the source's launcher sizes it on SMS SMs: the
    walk kernel's walking warps as :func:`walk_warps` counts them, at most
    a tenant's units and as shared memory fits, one block an SM shared out
    over the tenants; the row
    kernel's one block a chunk of ℓp threads (tenants 1: its chunks find
    their tables)."""
    p = plan(n_classes, lp, n_chunks, lw)
    if p.kernel == "rows":
        return n_chunks, 1, lp
    lw = lp if lw is None else lw
    table = (2 if p.both else 1) * table_bytes(n_classes, lw, p.g, p.lanes)
    tenant_units = -(-(n_chunks // n_tenants) // (32 // p.lanes))
    ww = max(min(walk_warps(n_chunks), tenant_units,
                 (MAX_SMEM_BYTES - table) // ring_bytes(lw, p.lanes, p.round)), 1)
    return min(-(-tenant_units // ww), max(SMS // n_tenants, 1)), n_tenants, 1024


def plan(n_classes: int, lp: int, n_chunks: int, lw: Optional[int] = None) -> Plan:
    """Kernel for ``n_chunks`` chunks (the launch's, over all of its
    tenants) over ``n_classes`` (ℓp, ℓp) tables a tenant whose live window
    is ``lw`` states (default ℓp): the walk kernel over the ℓ' = ``lw``
    live states (ℓ' ≤ 512) at the widest g of ``GROUPS`` whose table fits in
    one block's shared memory beside the rings of :func:`walk_warps` warps,
    with the longest round of ``ROUNDS`` that fits, both tables where they
    fit with it, else one rebuilt between the passes (on the H100 a round's
    staging costs microseconds, a table's rebuild next to nothing); else the
    row kernel over all ℓp (ℓp ≤ 1024); raises beyond that."""
    require(0 < lp <= MAX_LP and lp % 32 == 0,
            f"build_merge_packed: ℓp={lp} must be a multiple of 32 up to {MAX_LP}")
    lw = lp if lw is None else lw
    if lw // 32 <= MAX_GROUP_W:
        ww = walk_warps(n_chunks)
        for g in GROUPS:
            table = table_bytes(n_classes, lw, g, LANES)
            for rs in ROUNDS:
                for both in (True, False):
                    if (2 if both else 1) * table + ww * ring_bytes(lw, LANES, rs) <= MAX_SMEM_BYTES:
                        return Plan("walk", g, LANES, rs, both, class_stride(lw, g, LANES))
            # not even the shortest round of one warp fits this g: try the next
            if table + ring_bytes(lw, LANES, ROUNDS[-1]) > MAX_SMEM_BYTES:
                continue
            return Plan("walk", g, LANES, ROUNDS[-1], False, class_stride(lw, g, LANES))
    return ROWS


def shapes(N, ids, entry_f, entry_b):
    """The output's (shape, dtype): (C, k, ℓp/32) int32 packed columns."""
    return (*ids.shape, N.shape[-1] // 32), torch.int32


def cost(N, ids, entry_f, entry_b, *, steps=None, ell=None) -> Cost:
    """4·ℓ² operations a step (a forward and a backward ℓ × ℓ mat-vec) over
    ``steps`` steps (default all C·k) and ℓ live states (default ℓp); bytes:
    the ids, N, both entries and the packed columns, each once."""
    C, k = ids.shape
    lp = N.shape[-1]
    steps = C * k if steps is None else steps
    ell = lp if ell is None else ell
    return Cost(total(lambda s, e: 4 * s * e * e, steps, ell),
                4.0 * (C * k + N.numel() + 2 * C * lp + C * k * lp // 32), INT8_OPS)


def launch(
    lib: ctypes.CDLL,
    N: torch.Tensor,
    ids: torch.Tensor,
    entry_f: torch.Tensor,
    entry_b: torch.Tensor,
) -> torch.Tensor:
    """N (A+1, ℓp, ℓp) f32, or a tenant stack (T, A+1, ℓp, ℓp) whose tenants
    own equal runs of the chunks; ids (C, k) int32, entries (C, ℓp) f32 →
    (C, k, ℓp/32) int32 packed clean columns.  The walk visits the window
    kept with N (``window.attach``), if any, else all ℓp states; the live
    block of N it walks is kept while N lives (``checks.derived``)."""
    name = "build_merge_packed"
    lp = check_table(name, N)
    check_ids(name, ids)
    T, _ = tenants(name, N, ids)
    C, k = ids.shape
    for e in (entry_f, entry_b):
        require(
            e.dtype == torch.float32 and tuple(e.shape) == (C, lp),
            f"{name}: entries must be float32 ({C}, {lp}), got {e.dtype} {tuple(e.shape)}",
        )
    A1 = N.shape[-3]
    win = attached(N)
    lw = lp if win is None else win.width
    p = plan(A1, lp, C, lw)
    out = torch.empty((C, k, lp // 32), dtype=torch.int32, device=N.device)
    if p.kernel == "walk" and lw < lp:
        live = derived(N, f"live/{lw}", lambda: N[..., :lw, :lw].contiguous())
        ef, eb = entry_f[:, :lw].contiguous(), entry_b[:, :lw].contiguous()
        words = torch.empty((C, k, lw // 32), dtype=torch.int32, device=N.device)
        status = lib.repro_build_merge_walk(
            live.data_ptr(), ids.data_ptr(), ef.data_ptr(), eb.data_ptr(), words.data_ptr(),
            A1, C, k, lw, p.g, p.lanes, p.round, int(p.both), p.cls_stride, T, stream(N),
        )
        check_status(status, name)
        status = lib.repro_build_merge_pad(
            ids.data_ptr(), win.ident.data_ptr(), entry_f.data_ptr(), entry_b.data_ptr(),
            words.data_ptr(), out.data_ptr(), C, k, lp, lw, A1, T, stream(N),
        )
    elif p.kernel == "walk":
        status = lib.repro_build_merge_walk(
            N.data_ptr(), ids.data_ptr(), entry_f.data_ptr(), entry_b.data_ptr(),
            out.data_ptr(), A1, C, k, lp, p.g, p.lanes, p.round, int(p.both),
            p.cls_stride, T, stream(N),
        )
    else:
        nr = derived(N, "rows", lambda: pack_bits_torch(N))                         # row-packed
        nc = derived(N, "cols", lambda: pack_bits_torch(N.transpose(-1, -2)))      # column-packed
        status = lib.repro_build_merge_packed(
            nr.data_ptr(), nc.data_ptr(), ids.data_ptr(), entry_f.data_ptr(),
            entry_b.data_ptr(), out.data_ptr(), C, k, lp, A1, T, stream(N),
        )
    check_status(status, name)
    return out
