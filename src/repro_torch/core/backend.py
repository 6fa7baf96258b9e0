"""Pluggable three-phase parse backends (reach / join / build&merge).

The contract is the reference's (``repro/core/backend.py``):

  reach        (…, k) class chunks → (…, ℓp, ℓp) chunk products
  join         (…, c, ℓp, ℓp) product stack + I/F (ℓp,) → f32 (…, c, ℓp)
               forward and backward entry states, an exclusive scan over
               the Boolean OR-AND matrix monoid (``core/scan.py``)
  start_column the text-start column C₀ = I ∧ (P₀ᵀ Ĵ₀), f32 (…, ℓp)
  build&merge  (chunks, entries) → (…, k, W) packed clean columns

Chunk products are backend-owned: only axis slicing and restacking are
legal outside the backend.  Entries are f32 {0,1}; packed columns are int32
words carrying the uint32 bit pattern of the reference's packed columns.
Leading axes (batch rows, chunks) are carried through every phase, so one
call covers all B·c chunks of a batch.

Backends (names map to the reference's: ``torch`` ↔ ``jnp``, ``cuda`` ↔
``pallas``):
  * ``TorchBackend`` — plain tensor code, the twin of ``JnpBackend``; runs
    on the CPU or the card.
  * ``CudaBackend``  — the twin of ``PallasBackend``: reach through kernel
    K1, build&merge through K2 with packed output, compose and the join's
    combine and act through K3 (``kernels/ops.py``).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple, Type, Union

import torch

from ..kernels import ops
from ..kernels.ref import (
    build_merge_chunk_ref,
    reach_chunk_product_ref,
    semiring_matmul_ref,
)
from .matrices import pack_bits_torch
from .scan import exclusive_entries

Matmul = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def pack_columns_u32(cols: torch.Tensor) -> torch.Tensor:
    """(…, ℓp) {0,1} → (…, ℓp/32) int32 words, little-endian bits — the
    engine-boundary packed layout (uint32 bit pattern held in int32)."""
    return pack_bits_torch(cols)


def _batched(matmul: Matmul, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Apply a (n, m, k) × (n, k, n') matmul to operands with any equal
    leading axes (broadcast first), flattening them to one batch axis."""
    lead = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    a = a.expand(lead + a.shape[-2:]).reshape((-1,) + a.shape[-2:]).contiguous()
    b = b.expand(lead + b.shape[-2:]).reshape((-1,) + b.shape[-2:]).contiguous()
    out = matmul(a, b)
    return out.reshape(lead + out.shape[-2:])


def matvec(matmul: Matmul, m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """clamp(m v) for stacks of matrices (…, ℓp, ℓp) and vectors (…, ℓp)."""
    return _batched(matmul, m, v.unsqueeze(-1))[..., 0]


def matvec_T(matmul: Matmul, m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """clamp(mᵀ v), computed as the row vector vᵀ m (no transposed copy)."""
    return _batched(matmul, v.unsqueeze(-2), m)[..., 0, :]


def join_entries(
    matmul: Matmul, P: torch.Tensor, I: torch.Tensor, F: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Join phase (Eq. 7) over a product stack P (…, c, ℓp, ℓp).

    Forward entry of chunk i:  J_i = (P_{i-1} ⊗ … ⊗ P_0) I.
    Backward entry of chunk i: Ĵ_i = (P_{c-1} ⊗ … ⊗ P_{i+1})ᵀ F, the scan
    of the reversed products with flipped composition, acting by the
    transpose.  Returns (Jf, Jb), each f32 (…, c, ℓp).
    """
    Pc = P.movedim(-3, 0).contiguous()                 # chunk axis first
    Jf = exclusive_entries(
        combine=lambda later, earlier: _batched(matmul, later, earlier),
        act=lambda m, v: matvec(matmul, m, v),
        summaries=Pc,
        init=I,
    )
    Jb_rev = exclusive_entries(
        combine=lambda later, earlier: _batched(matmul, earlier, later),
        act=lambda m, v: matvec_T(matmul, m, v),
        summaries=Pc.flip(0),
        init=F,
    )
    return Jf.movedim(0, -2), Jb_rev.flip(0).movedim(0, -2)


class ParserBackend:
    """Swappable phase implementations over the engine's padded tables.

    Tables: N (A+1, ℓp, ℓp) f32 with the PAD class the identity; chunks
    (…, k) int32.  Subclasses give ``matmul`` (the semiring product of
    (n, m, k) × (n, k, n') stacks), ``reach`` and ``build_merge_packed``;
    compose, join and the start column are written on ``matmul``.
    """

    name: str = "abstract"
    min_lane_pad: int = 32     # segment-dim alignment this backend requires
    needs_cuda: bool = False   # True: runs only on tensors on the card

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def reach(self, N: torch.Tensor, chunks: torch.Tensor) -> torch.Tensor:
        """(…, k) chunks → (…, ℓp, ℓp) chunk products."""
        raise NotImplementedError

    def compose(self, later: torch.Tensor, earlier: torch.Tensor) -> torch.Tensor:
        """Monoid composition ``later ⊗ earlier`` of products (or stacks)."""
        return _batched(self.matmul, later, earlier)

    def identity_product(self, ell_pad: int, device=None) -> torch.Tensor:
        return torch.eye(ell_pad, dtype=torch.float32, device=device)

    def join(
        self, P: torch.Tensor, I: torch.Tensor, F: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        return join_entries(self.matmul, P, I, F)

    def start_column(
        self, P: torch.Tensor, I: torch.Tensor, Jb0: torch.Tensor
    ) -> torch.Tensor:
        """C₀ = I ∧ (P₀ᵀ Ĵ₀) as f32 (…, ℓp); P is the (…, c, ℓp, ℓp) stack."""
        return I * matvec_T(self.matmul, P[..., 0, :, :], Jb0)

    def build_merge_packed(
        self, N: torch.Tensor, chunks: torch.Tensor, Jf: torch.Tensor, Jb: torch.Tensor
    ) -> torch.Tensor:
        """(…, k) chunks + (…, ℓp) entries → (…, k, W) int32 packed columns."""
        raise NotImplementedError


def _flat(fn, N, chunks, *entries):
    """Run a (C, k)-chunk phase body on chunks with any leading axes."""
    lead = chunks.shape[:-1]
    k = chunks.shape[-1]
    lp = N.shape[-1]
    flat = [chunks.reshape(-1, k).contiguous()]
    flat += [e.reshape(-1, lp).contiguous() for e in entries]
    out = fn(N, *flat)
    return out.reshape(lead + out.shape[1:])


class TorchBackend(ParserBackend):
    """Plain tensor phase bodies — the twin of the reference's ``jnp``."""

    name = "torch"

    def matmul(self, a, b):
        return semiring_matmul_ref(a, b)

    def reach(self, N, chunks):
        return _flat(reach_chunk_product_ref, N, chunks)

    def build_merge(self, N, chunks, Jf, Jb):
        """(…, k) chunks + entries → (…, k, ℓp) f32 clean columns."""
        return _flat(build_merge_chunk_ref, N, chunks, Jf, Jb)

    def build_merge_packed(self, N, chunks, Jf, Jb):
        return pack_columns_u32(self.build_merge(N, chunks, Jf, Jb))


class CudaBackend(ParserBackend):
    """The hand-written Hopper kernels — the twin of the reference's
    ``pallas``.  Where ``PallasBackend`` walks chunks and batch rows with
    ``lax.map``, each phase here is one launch over all B·c chunks."""

    name = "cuda"
    needs_cuda = True

    def matmul(self, a, b):
        return ops.semiring_matmul(a, b)

    def reach(self, N, chunks):
        return _flat(ops.reach_chunk_product, N, chunks)

    def build_merge_packed(self, N, chunks, Jf, Jb):
        return _flat(ops.build_merge_packed, N, chunks, Jf, Jb)


_BACKENDS: Dict[str, Type[ParserBackend]] = {}


def register_backend(cls: Type[ParserBackend]) -> Type[ParserBackend]:
    _BACKENDS[cls.name] = cls
    return cls


register_backend(TorchBackend)
register_backend(CudaBackend)


def list_backends() -> list:
    """Sorted names of every registered parse backend."""
    return sorted(_BACKENDS)


def get_backend(backend: Union[str, ParserBackend]) -> ParserBackend:
    """Resolve a backend name (or pass an instance through)."""
    if isinstance(backend, ParserBackend):
        return backend
    try:
        return _BACKENDS[backend]()
    except KeyError:
        raise ValueError(
            f"unknown parse backend {backend!r}; known: {sorted(_BACKENDS)}"
        ) from None
