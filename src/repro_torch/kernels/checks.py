"""Argument checks shared by the kernel launchers (``reach``, ``build``,
``semiring``, ``packed_reach``, ``sparse_reach``, ``flash_attention``,
``ssd_chunk``): what a kernel does not take raises before any launch.

None of them reads a tensor's values, so a launch never waits on the card:
class ids are range-checked on the host, where the engine, the stream and
the fleet build them as numpy arrays (:func:`check_class_ids`), before they
are uploaded.  The parser's launchers also keep, per table tensor, what they
derive from it (:func:`derived`), so that a table used again (an engine's,
a fleet bucket's gathered stack) is not re-derived at every launch.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

MAX_SMEM_BYTES = 232448   # dynamic shared memory one Hopper block may use


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def check_status(status: int, name: str) -> None:
    """Raise on the ``cudaError_t`` a launcher returned."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {status}")


def stream(t: torch.Tensor) -> int:
    """Handle of the current stream on ``t``'s device, for a C launcher."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_cuda(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        require(t.is_cuda, f"{name}: every tensor must be on the card, got {t.device}")
        require(t.device == dev, f"{name}: tensors on {dev} and {t.device}")
        require(t.is_contiguous(), f"{name}: tensors must be contiguous")


def check_class_ids(classes: np.ndarray, n_classes: int, what: str = "class ids") -> None:
    """Host-side range check of class ids before they are uploaded: every
    id in [0, ``n_classes``).  The kernels index their tables with them and
    do not check."""
    if classes.size:
        lo, hi = int(classes.min()), int(classes.max())
        require(lo >= 0 and hi < n_classes,
                f"{what} must lie in [0, {n_classes}), got [{lo}, {hi}]")


def check_ids(name: str, ids: torch.Tensor) -> None:
    """(C, k) int32 class ids; their range is the caller's
    (:func:`check_class_ids`), so this reads no value."""
    require(ids.dtype == torch.int32, f"{name}: ids must be int32, got {ids.dtype}")
    require(ids.dim() == 2, f"{name}: ids must be (C, k), got {tuple(ids.shape)}")


def tenants(name: str, table: torch.Tensor, ids: torch.Tensor, table_dims: int = 3) -> Tuple[int, int]:
    """(T, chunks a tenant) of a launch: T = 1 for a shared table of
    ``table_dims`` axes, else the leading tenant axis of a stack, whose
    tenants own equal runs of the C chunks."""
    T = 1 if table.dim() == table_dims else table.shape[0]
    require(table.dim() in (table_dims, table_dims + 1) and 1 <= T <= 65535,
            f"{name}: table must have {table_dims} axes or a tenant axis of 1..65535 "
            f"before them, got {tuple(table.shape)}")
    C = ids.shape[0]
    require(C % T == 0, f"{name}: {C} chunks do not split evenly over {T} tenants")
    return T, C // T


def check_table(name: str, N: torch.Tensor) -> int:
    """N (A+1, ℓp, ℓp) f32 with ℓp % 32 == 0, or a tenant stack (T, A+1, ℓp,
    ℓp); returns ℓp."""
    require(N.dtype == torch.float32, f"{name}: N must be float32, got {N.dtype}")
    require(
        N.dim() in (3, 4) and N.shape[-1] == N.shape[-2] and N.shape[-1] % 32 == 0,
        f"{name}: N must be ([T,] A+1, ℓp, ℓp) with ℓp % 32 == 0, got {tuple(N.shape)}",
    )
    return N.shape[-1]


def derived(src: torch.Tensor, key: str, build: Callable[[], torch.Tensor]) -> torch.Tensor:
    """``build()``, kept on ``src`` itself for as long as it is unchanged: an
    in-place write (a new ``_version``) rebuilds it, and it goes with the
    tensor."""
    hit = kept(src, key)
    if hit is not None:
        return hit
    out = build()
    keep(src, key, out)
    return out


def keep(src: torch.Tensor, key: str, value) -> None:
    """Keep ``value`` on ``src`` under ``key`` for the tensor as it now is."""
    src.__dict__.setdefault("_repro_derived", {})[key] = (src._version, value)


def kept(src: torch.Tensor, key: str):
    """What :func:`keep` (or :func:`derived`) kept on ``src`` under ``key``,
    or None once ``src`` has been written in place since."""
    hit = src.__dict__.get("_repro_derived", {}).get(key)
    return hit[1] if hit is not None and hit[0] == src._version else None


def check_fold(name: str, Np: torch.Tensor, n_rows: int):
    """Np (A+1, ℓp, W) int32 packed rows with ℓp = 32·W, or a tenant stack
    (T, A+1, ℓp, W), folding ``n_rows`` ≤ ℓp rows; returns (ℓp, W).  Which
    kernel takes the table, and the shared memory it needs, is
    ``packed_reach.plan``'s."""
    require(Np.dtype == torch.int32, f"{name}: Np must be int32 words, got {Np.dtype}")
    require(
        Np.dim() in (3, 4) and Np.shape[-2] == 32 * Np.shape[-1] and Np.shape[-1] >= 1,
        f"{name}: Np must be ([T,] A+1, ℓp, ℓp/32), got {tuple(Np.shape)}",
    )
    lp, W = Np.shape[-2], Np.shape[-1]
    require(n_rows <= lp, f"{name}: {n_rows} rows exceed ℓp={lp}")
    return lp, W
