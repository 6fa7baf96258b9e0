"""Plain PyTorch versions of the parser kernels.

Each function has its kernel's signature (``kernels/ops.py``) and a leading
batch-of-chunks axis: one call covers every chunk of every batch row.  They
are the ``torch`` backend's phase bodies, the CPU path of every kernel
wrapper, and what the CUDA kernels are held against on the card.  All
arithmetic is OR-AND over {0,1} f32 (matmul, then min(·, 1)), which is exact,
so a kernel and its plain version agree bit for bit.
"""

from __future__ import annotations

import torch

from ..core.matrices import pack_bits_torch


def semiring_matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Boolean product clamp(a @ b) of (…, m, k) × (…, k, n) {0,1} f32."""
    return torch.clamp(torch.matmul(a, b), max=1.0)


def reach_chunk_product_ref(N: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Chunk products P = N[x_k] ⊗ … ⊗ N[x_1] of C chunks at once.

    N (A+1, ℓp, ℓp) f32 {0,1} with the PAD class the identity; ids (C, k)
    int class ids → (C, ℓp, ℓp) f32.
    """
    C, k = ids.shape
    lp = N.shape[-1]
    P = torch.eye(lp, dtype=N.dtype, device=N.device).expand(C, lp, lp).contiguous()
    for t in range(k):
        P = semiring_matmul_ref(N[ids[:, t]], P)
    return P


def build_merge_chunk_ref(
    N: torch.Tensor, ids: torch.Tensor, entry_f: torch.Tensor, entry_b: torch.Tensor
) -> torch.Tensor:
    """Fig. 14 builder&merger of C chunks: (C, k, ℓp) f32 clean columns.

    Forward from J_{i-1}: fwd[t] = clamp(N[x_t] fwd[t-1]).  Backward from
    Ĵ_{i+1}: β_k = entry_b, β_t = clamp(N[x_t]ᵀ β_{t+1}).  Column t is
    fwd[t] ∧ β_{t+1}.  entry_f, entry_b (C, ℓp) f32.
    """
    C, k = ids.shape
    lp = N.shape[-1]
    M = torch.empty((C, k, lp), dtype=N.dtype, device=N.device)
    v = entry_f.unsqueeze(-1)
    for t in range(k):
        v = semiring_matmul_ref(N[ids[:, t]], v)
        M[:, t] = v[..., 0]
    beta = entry_b.unsqueeze(-2)                      # row vector: βᵀ N = (Nᵀ β)ᵀ
    for t in range(k - 1, -1, -1):
        M[:, t] *= beta[:, 0]
        beta = semiring_matmul_ref(beta, N[ids[:, t]])
    return M


def build_merge_packed_ref(
    N: torch.Tensor, ids: torch.Tensor, entry_f: torch.Tensor, entry_b: torch.Tensor
) -> torch.Tensor:
    """Packed form of :func:`build_merge_chunk_ref`: (C, k, ℓp/32) int32 words
    with the uint32 bit pattern of ``pack_bits`` along ℓp."""
    return pack_bits_torch(build_merge_chunk_ref(N, ids, entry_f, entry_b))
