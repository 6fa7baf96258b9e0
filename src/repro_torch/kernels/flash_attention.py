"""K6 launcher: causal / sliding-window attention through ``csrc/flash_attention.cu``.

Replaces ``repro/kernels/flash_attention.py::flash_attention_fwd``.  The
kernel reads the public layout (b, L, h, hd) in place, with K and V already
repeated to the query heads, so one launch covers every (batch, head) pair
and no transpose is copied.  An optional logit ``softcap`` c maps each
scaled score s to c·tanh(s/c) before the mask (None or 0: off).  bf16 runs on wgmma (head_dim a multiple of 8 up
to 128), f32 on mma.sync in 3xTF32 (head_dim up to 128).  The plain version
is ``kernels/ref.py::flash_attention_ref``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from .checks import check_status, require, stream
from .cost import Cost, float_rate

SOURCE = "flash_attention"
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "repro_flash_attention": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P]),
    "repro_flash_supports": (_I, [_I, _I]),
    "repro_flash_query_tile": (_I, [_I]),
}
MAX_GRID_Y = 65535   # query tiles of one launch
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def pairs(Lq: int, Lk: int, causal: bool = True, window: Optional[int] = None) -> int:
    """(query, key) pairs the mask keeps: key j ≤ query i where causal, and
    j > i − window where a window is set."""
    i = np.arange(Lq)
    hi = np.minimum(i, Lk - 1) if causal else np.full(Lq, Lk - 1)
    lo = np.maximum(i - window + 1, 0) if window else np.zeros(Lq, dtype=np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def shapes(q, k, v, *, causal=True, window=None, softcap=None):
    """The output's (shape, dtype): q's."""
    return tuple(q.shape), q.dtype


def cost(q, k, v, *, causal=True, window=None, softcap=None) -> Cost:
    """QKᵀ and PV over the pairs the mask keeps, 4·hd operations a pair
    (2·L(L+1)·hd a (batch, head) for causal L × L) at the rate of the
    operands' type; bytes: q, k, v and the output, each once."""
    b, Lq, h, hd = q.shape
    Lk = k.shape[1]
    e = q.element_size()
    return Cost(4.0 * pairs(Lq, Lk, causal, window) * hd * b * h,
                float(e * (2 * b * Lq * h * hd + 2 * b * Lk * h * hd)), float_rate(q.dtype))


def launch(
    lib: ctypes.CDLL,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """q (b, Lq, h, hd), k and v (b, Lk, h, hd), one dtype → (b, Lq, h, hd)."""
    name = "flash_attention"
    require(
        q.dtype in DTYPES and k.dtype == q.dtype and v.dtype == q.dtype,
        f"{name}: q, k, v must all be float32 or all bfloat16, got "
        f"{q.dtype}, {k.dtype}, {v.dtype}",
    )
    require(
        q.dim() == 4 and k.dim() == 4 and k.shape == v.shape and k.shape[0] == q.shape[0]
        and k.shape[2:] == q.shape[2:],
        f"{name}: need q (b, Lq, h, hd) and k, v (b, Lk, h, hd), got "
        f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}",
    )
    b, Lq, h, hd = q.shape
    Lk = k.shape[1]
    dtype = DTYPES[q.dtype]
    require(
        lib.repro_flash_supports(dtype, hd) == 1,
        f"{name}: head_dim {hd} is not supported for {q.dtype}",
    )
    tiles = -(-Lq // lib.repro_flash_query_tile(dtype))
    require(tiles <= MAX_GRID_Y, f"{name}: {tiles} query tiles exceed the grid ({MAX_GRID_Y})")
    require(window is None or window > 0, f"{name}: window must be positive, got {window}")
    require(softcap is None or softcap >= 0, f"{name}: softcap must be >= 0, got {softcap}")
    require(Lk > 0 or Lq == 0, f"{name}: no keys")
    require(
        all(t.data_ptr() % 16 == 0 for t in (q, k, v)),
        f"{name}: tensors must be 16-byte aligned",
    )
    out = torch.empty_like(q)
    status = lib.repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dtype, b, Lq, Lk, h, hd,
        int(causal), 0 if window is None else int(window), float(softcap or 0.0), stream(q),
    )
    check_status(status, name)
    return out
