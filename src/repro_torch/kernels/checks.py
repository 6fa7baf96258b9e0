"""Argument checks shared by the kernel launchers (``reach``, ``build``,
``semiring``, ``packed_reach``, ``sparse_reach``, ``flash_attention``,
``ssd_chunk``): what a kernel does not take raises before any launch."""

from __future__ import annotations

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


def check_ids(name: str, ids: torch.Tensor, n_classes: int) -> None:
    """(C, k) int32 class ids within the table (one host sync)."""
    require(ids.dtype == torch.int32, f"{name}: ids must be int32, got {ids.dtype}")
    require(ids.dim() == 2, f"{name}: ids must be (C, k), got {tuple(ids.shape)}")
    if ids.numel():
        lo, hi = torch.aminmax(ids)
        require(
            int(lo) >= 0 and int(hi) < n_classes,
            f"{name}: class ids must lie in [0, {n_classes})",
        )


def check_table(name: str, N: torch.Tensor) -> int:
    """N (A+1, ℓp, ℓp) f32 with ℓp % 32 == 0; returns ℓp."""
    require(N.dtype == torch.float32, f"{name}: N must be float32, got {N.dtype}")
    require(
        N.dim() == 3 and N.shape[1] == N.shape[2] and N.shape[1] % 32 == 0,
        f"{name}: N must be (A+1, ℓp, ℓp) with ℓp % 32 == 0, got {tuple(N.shape)}",
    )
    return N.shape[-1]


def check_fold(name: str, Np: torch.Tensor, n_rows: int):
    """Np (A+1, ℓp, W) int32 packed rows with ℓp = 32·W, folding ``n_rows``
    ≤ ℓp rows; returns (ℓp, W).  Which kernel takes the table, and the
    shared memory it needs, is ``packed_reach.plan``'s."""
    require(Np.dtype == torch.int32, f"{name}: Np must be int32 words, got {Np.dtype}")
    require(
        Np.dim() == 3 and Np.shape[1] == 32 * Np.shape[2] and Np.shape[2] >= 1,
        f"{name}: Np must be (A+1, ℓp, ℓp/32), got {tuple(Np.shape)}",
    )
    lp, W = Np.shape[1], Np.shape[2]
    require(n_rows <= lp, f"{name}: {n_rows} rows exceed ℓp={lp}")
    return lp, W
