"""The live window of a table: the states that K1's and K2's walks visit.

``core/matrices.py`` ``pad_matrices_bundle`` (the reference's fleet padding,
bit for bit) pads in a fixed way: a tenant's real classes are zero outside
[0, ℓ)², and every other class is the identity over all of ℓp.  So at any
split ℓ' ≥ ℓ every table is block-diagonal, N[x] = diag(A_x, D_x) with
D_x ∈ {0, I}, and the phases follow the blocks:

  reach         a chunk's product is diag(∏A, ∏D), and ∏D = I exactly when
                every step of the chunk is a class whose D is I, else 0;
  build&merge   the padded states' forward frontier is Jf's padded bits
                while the steps so far have D = I, and 0 from the first
                other step; the backward frontier likewise from Jb at the
                chunk's end; so every output column's padded bits are
                Jf ∧ Jb there when every step of the chunk has D = I, else 0.

K1 and K2 (``reach.py``, ``build.py``) walk only [0, ℓ') and write the rest
from that algebra.  ℓ' is decided by the test on N alone (:func:`live_window`),
never by a tenant's ℓ: the smallest multiple of 32 such that, for every class
of every tenant, both cross blocks [0, ℓ') × [ℓ', ℓp) and [ℓ', ℓp) × [0, ℓ')
are zero and the padded block [ℓ', ℓp)² is all 0 or exactly I.  A split that
holds for a table holds for every wider one, so a stack's window is the
widest of its tenants' (:func:`window_of`).  Where no ℓ' < ℓp holds, the
window is ℓp and the kernels walk every state, as they do for a table with
no window attached.

Reading N's values is a host read on the card, so no launcher computes a
window: it takes the one kept with the table (:func:`attach`), or none.
The fleet's bucket runner tests its members' tables on the host and keeps
the window with each gathered stack (``core/fleet.py``), so a dispatch reads
nothing back.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .checks import keep, kept, require

WORD = 32
_KEY = "window"


class Window(NamedTuple):
    width: int              # ℓ': live states, a multiple of 32, at most ℓp
    ident: torch.Tensor     # (T, A+1) int32: 1 where class x of tenant t has D = I


def class_extents(N: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per class of N (…, A+1, ℓp, ℓp): (extent (…, A+1) int64, ident (…,
    A+1) bool).  ``extent`` is the least split ℓ' (any integer) with zero
    cross blocks and a padded block of 0 or I: one past the last state that
    has an off-diagonal entry or a diagonal entry unlike the last state's
    (ℓp where that last entry is neither 0 nor 1).  ``ident`` is whether the
    padded block is I (the last diagonal entry is 1)."""
    lp = N.shape[-1]
    eye = torch.eye(lp, dtype=torch.bool, device=N.device)
    off = (N != 0) & ~eye
    touched = off.any(-1) | off.any(-2)                            # (…, A+1, ℓp)
    diag = N.diagonal(dim1=-2, dim2=-1)
    last = diag[..., -1:]
    after = torch.arange(1, lp + 1, device=N.device)
    extent = torch.maximum((touched * after).amax(-1), ((diag != last) * after).amax(-1))
    last = last[..., 0]
    extent = torch.where((last == 0) | (last == 1), extent, torch.full_like(extent, lp))
    return extent, last == 1


def window_of(extent: torch.Tensor, ident: torch.Tensor, lp: int) -> Window:
    """The window of a stack from its classes' :func:`class_extents`
    (extent and ident (T, A+1), or (A+1,) for one table): the widest
    extent rounded up to a multiple of 32 (at least 32, at most ℓp)."""
    widest = int(extent.max()) if extent.numel() else 0
    width = min(max(-(-widest // WORD) * WORD, WORD), lp)
    return Window(width, ident.reshape(-1, ident.shape[-1]).to(torch.int32))


def live_window(N: torch.Tensor) -> Window:
    """The test on N ([T,] A+1, ℓp, ℓp): its window, the flags on N's device.
    It reads N's values (on the card, one host read): call it outside a
    phase, and :func:`attach` what it gives."""
    return window_of(*class_extents(N), N.shape[-1])


def attach(N: torch.Tensor, window: Window) -> None:
    """Keep ``window`` with N, for the launchers, while N is unchanged (an
    in-place write drops it, as ``checks.derived`` drops what it keeps)."""
    T = 1 if N.dim() == 3 else N.shape[0]
    lp = N.shape[-1]
    require(0 < window.width <= lp and window.width % WORD == 0,
            f"window {window.width} must be a multiple of {WORD} up to ℓp={lp}")
    require(tuple(window.ident.shape) == (T, N.shape[-3]) and window.ident.dtype == torch.int32
            and window.ident.device == N.device,
            f"window flags must be int32 ({T}, {N.shape[-3]}) on {N.device}, got "
            f"{window.ident.dtype} {tuple(window.ident.shape)} on {window.ident.device}")
    keep(N, _KEY, Window(window.width, window.ident.contiguous()))


def attached(N: torch.Tensor) -> Optional[Window]:
    """The window kept with N, or None; a launcher walks ℓp states without
    one."""
    return kept(N, _KEY)


def width(N: torch.Tensor) -> int:
    """The states K1's group kernel and K2's walk visit for N: the kept
    window's width, else ℓp."""
    win = attached(N)
    return N.shape[-1] if win is None else win.width
