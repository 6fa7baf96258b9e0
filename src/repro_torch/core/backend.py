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
``pallas``, ``packed`` and ``sparse`` keep theirs):
  * ``TorchBackend``  — plain tensor code, the twin of ``JnpBackend``; runs
    on the CPU or the card.
  * ``CudaBackend``   — the twin of ``PallasBackend``: reach through kernel
    K1, build&merge through K2 with packed output, compose and the join's
    combine and act through K3 (``kernels/ops.py``).
  * ``PackedBackend`` — products as (ℓp, W) int32 packed target-set rows and
    every phase as OR-AND word ops (``core/matrices.py``); ``kernel=True``
    sends reach through kernel K4 and build&merge through kernel K2.
  * ``SparseBackend`` — products as (S, 1+W) gathered feasible-start rows,
    the speculation-width reduction; ``kernel=True`` sends the row fold of
    reach through kernel K5 and build&merge through kernel K2.

A backend built with ``kernel=True`` runs only on the card
(``needs_cuda``); its phases called on CPU tensors run the kernels' plain
versions, as every wrapper does.

The tenant axis (the fleet, ``core/fleet.py``): every phase also takes a
stack of T automata of one bucket shape, N (T, A+1, ℓp, ℓp) with chunks
(T, …, k) and I / F broadcasting over the chunk grid's batch axes (the
fleet passes (T, 1, ℓp)).  Reach and build&merge flatten the chunks tenant
by tenant and hand the stack to ONE kernel launch (each chunk reads its own
tenant's table), the join's K3 folds every leading axis into one launch
(``_batched``), and the sparse feasible rows gather each chunk's classes
from its own tenant's table.  A sparse bucket binds the shared width S of
its members with ``bind_shape``.  Backends whose products depend on the
automaton take it in ``bind_tables(tables)``, which the engine calls once
the tables are built; the default is a no-op.  The sparse width S is the
reference's: the worst single-class feasible width rounded up to a power of
two (at least ``min_width``), and S = ℓp when that reaches ℓp (the
dense-fallback rule).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple, Type, Union

import torch

from ..kernels import ops
from ..kernels.checks import derived
from ..kernels.ref import (
    build_merge_chunk_ref,
    class_tables,
    packed_reach_chunk_product_ref,
    reach_chunk_product_ref,
    semiring_matmul_ref,
    sparse_reach_rows_ref,
)
from .matrices import (
    SPARSE_EMPTY,
    pack_bits_torch,
    pack_transition_table_torch,
    packed_identity,
    packed_matvec,
    packed_matvec_T,
    packed_matvec_T_words,
    packed_matvec_words,
    packed_semiring_matmul,
    sparse_compose,
    sparse_identity,
    sparse_init_rows,
    sparse_matvec,
    sparse_matvec_T,
)
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


def scan_join(
    compose: Callable, act: Callable, act_T: Callable,
    P: torch.Tensor, I: torch.Tensor, F: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Join phase (Eq. 7) over a product stack P (…, c, ·, ·) in any product
    representation, given its ``compose(later, earlier)``, its mat-vec
    ``act`` and transposed mat-vec ``act_T``.

    Forward entry of chunk i:  J_i = (P_{i-1} ⊗ … ⊗ P_0) I.
    Backward entry of chunk i: Ĵ_i = (P_{c-1} ⊗ … ⊗ P_{i+1})ᵀ F, the scan
    of the reversed products with flipped composition, acting by the
    transpose.  Returns (Jf, Jb), each f32 (…, c, ℓp).
    """
    Pc = P.movedim(-3, 0).contiguous()                 # chunk axis first
    Jf = exclusive_entries(combine=compose, act=act, summaries=Pc, init=I)
    Jb_rev = exclusive_entries(
        combine=lambda later, earlier: compose(earlier, later),
        act=act_T,
        summaries=Pc.flip(0),
        init=F,
    )
    return Jf.movedim(0, -2), Jb_rev.flip(0).movedim(0, -2)


def join_entries(
    matmul: Matmul, P: torch.Tensor, I: torch.Tensor, F: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`scan_join` over f32 (…, c, ℓp, ℓp) products and a semiring
    ``matmul``."""
    return scan_join(
        lambda later, earlier: _batched(matmul, later, earlier),
        lambda m, v: matvec(matmul, m, v),
        lambda m, v: matvec_T(matmul, m, v),
        P, I, F,
    )


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

    def bind_tables(self, tables) -> None:
        """One-time hook: the ``EngineTables`` this backend will run, given
        by the engine before any phase.  A no-op unless the product
        representation depends on the automaton."""

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


def _flat(fn, N, chunks, *per_chunk):
    """Run a (C, k)-chunk phase body on chunks with any leading axes; each
    ``per_chunk`` tensor carries the same leading axes and one trailing
    axis (entries (…, ℓp), feasible rows (…, S, W) flatten alike).  With a
    tenant stack N (T, …) the chunks' first axis is the tenant's, so the
    flat chunks come tenant by tenant, as the kernels take them."""
    lead = chunks.shape[:-1]
    flat = [chunks.reshape((-1,) + chunks.shape[-1:]).contiguous()]
    flat += [x.reshape((-1,) + x.shape[len(lead):]).contiguous() for x in per_chunk]
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


def packed_build_merge(
    Np: torch.Tensor, ids: torch.Tensor, entry_f: torch.Tensor, entry_b: torch.Tensor
) -> torch.Tensor:
    """Fig. 14 builder&merger of C chunks on packed words: (C, k, W) int32
    clean columns.  Np (A+1, ℓp, W) packed rows, ids (C, k), entries (C, ℓp)
    f32.  The twin of the reference's ``PackedBackend.build_merge_packed``:
    forward frontier words fwd[t] = N[x_t] fwd[t-1], backward β_t =
    N[x_t]ᵀ β_{t+1} from β_k = packed Ĵ, column t = fwd[t] & β_{t+1}."""
    C, k = ids.shape
    M = torch.empty((C, k, Np.shape[-1]), dtype=torch.int32, device=Np.device)
    vp = pack_bits_torch(entry_f)
    for t in range(k):
        vp = packed_matvec_words(class_tables(Np, ids[:, t]), vp)
        M[:, t] = vp
    beta = pack_bits_torch(entry_b)
    for t in range(k - 1, -1, -1):
        M[:, t] &= beta
        beta = packed_matvec_T_words(class_tables(Np, ids[:, t]), beta)
    return M


def packed_tables(N: torch.Tensor) -> torch.Tensor:
    """``pack_transition_table_torch(N)``, kept while N lives unchanged (an
    engine's tables, a fleet bucket's gathered stack), so that a warm call
    packs nothing."""
    return derived(N, "packed", lambda: pack_transition_table_torch(N))



class PackedBackend(ParserBackend):
    """Bit-packed phase bodies — the twin of the reference's ``packed``.

    Chunk products are (ℓp, W = ℓp/32) int32 packed target-set rows (the
    ``pack_transition_table`` orientation).  Reach, compose, the join's
    combine and act, the start column and build&merge run as AND / OR /
    shift word ops; the f32 tables are packed inside each phase, so every
    entry point keeps the engine's table layout.  ``kernel=True`` routes
    reach through kernel K4 and build&merge through kernel K2 (one launch
    each over all B·c chunks; K2 takes the f32 table and returns the same
    packed columns as the word loop ``packed_build_merge``, which stays the
    phase body with ``kernel=False``); compose, the join and the start
    column have no kernel in the reference and stay plain tensor code.
    """

    name = "packed"
    min_lane_pad = 32   # exact word packing needs ℓp % 32 == 0

    def __init__(self, kernel: bool = False):
        self.kernel = bool(kernel)
        self.needs_cuda = self.kernel

    def reach(self, N, chunks):
        fold = ops.packed_reach_chunk_product if self.kernel else packed_reach_chunk_product_ref
        return _flat(fold, packed_tables(N), chunks)

    def compose(self, later, earlier):
        return packed_semiring_matmul(later, earlier)

    def identity_product(self, ell_pad, device=None):
        return packed_identity(ell_pad, device)

    def join(self, P, I, F):
        return scan_join(packed_semiring_matmul, packed_matvec, packed_matvec_T, P, I, F)

    def start_column(self, P, I, Jb0):
        return I * packed_matvec_T(P[..., 0, :, :], Jb0)

    def build_merge_packed(self, N, chunks, Jf, Jb):
        if self.kernel:
            return _flat(ops.build_merge_packed, N, chunks, Jf, Jb)
        return _flat(packed_build_merge, packed_tables(N), chunks, Jf, Jb)


def next_pow2(n: int) -> int:
    """The least power of two ≥ n (1 for n ≤ 1)."""
    return 1 << max(0, int(n) - 1).bit_length()


class SparseBackend(PackedBackend):
    """Feasible-start sparse products — the twin of the reference's
    ``sparse``, the speculation-width reduction.

    Reach computes each chunk's feasible start states (a depth-``depth``
    backward mat-vec over its leading classes), gathers at most S of them,
    seeds their packed identity rows and folds only those rows through the
    chunk — S rows instead of ℓp.  Products are (S, 1+W) int32: [source
    index | packed target words], ``SPARSE_EMPTY`` marking an unused slot;
    an all-PAD chunk gives the flagged identity.  S is bound once per
    automaton by ``bind_tables`` (or ``bind_shape``).  Entries, the start
    column and build&merge keep the contract's seams; build&merge is the
    packed one.  ``kernel=True`` sends the row fold through kernel K5 and
    build&merge, as the packed backend does, through kernel K2.
    """

    name = "sparse"
    min_lane_pad = 32

    def __init__(self, kernel: bool = False, depth: int = 1, min_width: int = 8):
        super().__init__(kernel=kernel)
        if depth < 1:
            raise ValueError(f"feasible-prefix depth must be ≥ 1, got {depth}")
        self.depth = int(depth)
        self.min_width = int(min_width)
        self._width: Optional[int] = None      # S: product rows
        self._ell_pad: Optional[int] = None

    def bind_tables(self, tables) -> None:
        # per real class (PAD excluded): states with an outgoing transition
        # on it, the bound of every depth-d feasible set led by that class
        widths = (tables.N[:-1] > 0).any(dim=1).sum(dim=1)
        self.bind_shape(tables.N.shape[-1], int(widths.max()) if widths.numel() else 1)

    def bind_shape(self, ell_pad: int, raw_width: int) -> None:
        """Bind S from ℓp and a raw feasible-width bound: the next power of
        two ≥ max(min_width, raw_width), or ℓp once that reaches ℓp."""
        lp = int(ell_pad)
        S = next_pow2(max(self.min_width, int(raw_width), 1))
        self._width = lp if S >= lp else S
        self._ell_pad = lp

    def _require_bound(self, lp: int) -> int:
        if self._width is None:
            raise RuntimeError(
                "sparse backend is unbound — ParserEngine.__init__ calls "
                "bind_tables(tables) before any phase; standalone use must too"
            )
        if lp != self._ell_pad:
            raise ValueError(
                f"sparse backend bound to ℓp={self._ell_pad}, got ℓp={lp}; "
                "one SparseBackend instance serves one automaton"
            )
        return self._width

    def feasible_rows(self, N: torch.Tensor, chunks: torch.Tensor) -> torch.Tensor:
        """(…, k) chunks → (…, S) int32 feasible start states, ascending,
        ``SPARSE_EMPTY`` in unused slots."""
        lp = N.shape[-1]
        S = self._require_bound(lp)
        u = torch.ones(chunks.shape[:-1] + (lp, 1), dtype=N.dtype, device=N.device)
        for j in range(min(self.depth, chunks.shape[-1]) - 1, -1, -1):
            cls = chunks[..., j]
            Nx = class_tables(N, cls.reshape(-1)).reshape(cls.shape + (lp, lp))
            u = semiring_matmul_ref(Nx.transpose(-1, -2), u)
        states = torch.arange(lp, dtype=torch.int32, device=N.device)
        idx = torch.where(u[..., 0] > 0.5, states, SPARSE_EMPTY)
        return torch.sort(idx, dim=-1).values[..., :S]

    def reach(self, N, chunks):
        lp = N.shape[-1]
        S = self._require_bound(lp)
        idx = self.feasible_rows(N, chunks)                      # (…, S)
        R0 = sparse_init_rows(idx, lp)                           # (…, S, W)
        fold = ops.sparse_reach_rows if self.kernel else sparse_reach_rows_ref
        R = _flat(fold, packed_tables(N), chunks, R0)
        body = torch.cat([idx.unsqueeze(-1), R], dim=-1)
        # an all-PAD padding chunk ⇔ its first class is PAD (PAD only pads
        # the tail) ⇒ its product is exactly the identity: the flagged form
        ident = sparse_identity(S, lp // 32, N.device)
        pad = (chunks[..., 0] == N.shape[-3] - 1)[..., None, None]
        return torch.where(pad, ident, body)

    def compose(self, later, earlier):
        return sparse_compose(later, earlier)

    def identity_product(self, ell_pad, device=None):
        return sparse_identity(self._require_bound(ell_pad), ell_pad // 32, device)

    def join(self, P, I, F):
        return scan_join(sparse_compose, sparse_matvec, sparse_matvec_T, P, I, F)

    def start_column(self, P, I, Jb0):
        return I * sparse_matvec_T(P[..., 0, :, :], Jb0)


_BACKENDS: Dict[str, Type[ParserBackend]] = {}


def register_backend(cls: Type[ParserBackend]) -> Type[ParserBackend]:
    _BACKENDS[cls.name] = cls
    return cls


register_backend(TorchBackend)
register_backend(CudaBackend)
register_backend(PackedBackend)
register_backend(SparseBackend)


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
