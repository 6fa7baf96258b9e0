"""Boolean connection matrices of the parser NFA (paper Sect. 2.4).

For each character class ``c`` (App. A alphabet partition) the matrix ``N_c`` has
``N_c[row, col] = 1`` iff the NFA has an arc labeled ``c`` from segment ``col`` to
segment ``row`` — i.e. ``row ∈ FolSeg(col)`` and ``col``'s end-letter reads ``c``.

Layout: ``N`` is a dense ``(n_classes + 1, ℓ, ℓ)`` array.  Index ``n_classes`` is the
synthetic PAD class whose matrix is the identity: padding a text with PAD characters
is a semantic no-op for both the column recurrence and chunk products, which lets the
parallel engine use statically-shaped equal chunks (the TPU replacement for the
paper's load-balancing fragments).

Bit-packing: segments are packed 32-per-lane into uint32 words.  ``N_packed`` has
shape ``(n_classes + 1, ℓ, W)`` with ``W = ceil(ℓ/32)``; row-major packing along the
*target* dimension so the Boolean mat-vec ``out = OR_col v[col] & N[col]`` becomes a
masked OR-reduction — the VPU-friendly form used by the bit-packed kernels.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .segments import SegmentTable


@dataclass
class ParserMatrices:
    table: SegmentTable
    N: np.ndarray          # (A+1, ℓ, ℓ) bool;  N[A] = I (PAD class)
    I: np.ndarray          # (ℓ,) bool — initial segments
    F: np.ndarray          # (ℓ,) bool — final segments
    byte_to_class: np.ndarray  # (256,) int32

    @property
    def n_segments(self) -> int:
        return self.N.shape[1]

    @property
    def n_classes(self) -> int:  # including DEAD, excluding PAD
        return self.N.shape[0] - 1

    @property
    def pad_class(self) -> int:
        return self.N.shape[0] - 1

    def classes_of_text(self, text: bytes | str) -> np.ndarray:
        if isinstance(text, str):
            text = text.encode("utf-8")
        return self.byte_to_class[np.frombuffer(text, dtype=np.uint8)]


def build_matrices(table: SegmentTable) -> ParserMatrices:
    ell = table.n
    A = table.numbered.n_classes
    N = np.zeros((A + 1, ell, ell), dtype=bool)
    for col in range(ell):
        succs = table.folseg[col]
        if not succs:
            continue
        for cls in table.seg_classes[col]:
            for row in succs:
                N[cls, row, col] = True
    N[A] = np.eye(ell, dtype=bool)  # PAD class = identity
    return ParserMatrices(
        table=table,
        N=N,
        I=table.initial.copy(),
        F=table.final.copy(),
        byte_to_class=np.asarray(table.numbered.byte_to_class, dtype=np.int32),
    )


def pad_matrices_bundle(
    m: ParserMatrices, *, ell_pad: int, n_classes: int
) -> tuple:
    """Pad one automaton's (N, I, F) to a shared fleet-bucket table shape.

    Returns float32 ``N (n_classes, ell_pad, ell_pad)``, ``I (ell_pad,)``,
    ``F (ell_pad,)``, so that automata of different sizes stack on a leading
    tenant axis and share one launch of each kernel (``core/fleet.py``):

      * state axes zero-pad ℓ → ell_pad: padded states have no arcs and I/F
        zero there, so they are unreachable and products restricted to the
        first ℓ rows are the unpadded automaton's;
      * the tenant's real classes keep indices 0..A-1 (``byte_to_class`` is
        unchanged); every index from A through n_classes-1 (the relocated
        PAD class, ``n_classes - 1`` across the bucket, and any unused
        padding class below it) is the identity over the padded space.

    The reference's ``repro/core/matrices.py::pad_matrices_bundle``, bit for
    bit.
    """
    ell = m.n_segments
    A1 = m.N.shape[0]                       # tenant classes incl. its PAD
    if ell_pad < ell:
        raise ValueError(f"ell_pad {ell_pad} < automaton segments {ell}")
    if n_classes < A1:
        raise ValueError(f"n_classes {n_classes} < automaton classes {A1}")
    N = np.zeros((n_classes, ell_pad, ell_pad), dtype=np.float32)
    N[: A1 - 1, :ell, :ell] = m.N[:-1].astype(np.float32)
    N[A1 - 1:] = np.eye(ell_pad, dtype=np.float32)  # PAD + unused = identity
    I = np.zeros(ell_pad, dtype=np.float32)
    I[:ell] = m.I
    F = np.zeros(ell_pad, dtype=np.float32)
    F[:ell] = m.F
    return N, I, F


def feasible_width_bound(m: ParserMatrices) -> int:
    """Worst-case single-character feasible-start width of one automaton:
    the most source states with an arc on one real class (PAD and identity
    padding excluded), the depth-1 bound every deeper feasible set
    respects.  The fleet takes its maximum over a sparse bucket's members
    as the bucket's shared width S."""
    N = np.asarray(m.N[:-1]) > 0
    widths = N.any(axis=1).sum(axis=1)
    return int(widths.max()) if widths.size else 1


def pack_bits(mat: np.ndarray, axis: int = -1) -> np.ndarray:
    """Pack a boolean array along ``axis`` into uint32 words (little-endian bits)."""
    mat = np.moveaxis(np.asarray(mat, dtype=bool), axis, -1)
    n = mat.shape[-1]
    W = (n + 31) // 32
    padded = np.zeros(mat.shape[:-1] + (W * 32,), dtype=bool)
    padded[..., :n] = mat
    r = padded.reshape(mat.shape[:-1] + (W, 32))
    weights = (np.uint64(1) << np.arange(32, dtype=np.uint64)).astype(np.uint64)
    packed = (r.astype(np.uint64) * weights).sum(axis=-1).astype(np.uint32)
    return np.moveaxis(packed, -1, axis if axis >= 0 else len(packed.shape) + axis)


_BIT_SHIFTS = np.arange(32, dtype=np.uint32)


def unpack_bits(packed: np.ndarray, n: int, axis: int = -1) -> np.ndarray:
    """Inverse of :func:`pack_bits`."""
    packed = np.asarray(packed, dtype=np.uint32)
    last = axis == -1 or axis == packed.ndim - 1
    if not last:
        packed = np.moveaxis(packed, axis, -1)
    bits = (packed[..., :, None] >> _BIT_SHIFTS) & np.uint32(1)
    flat = bits.reshape(packed.shape[:-1] + (-1,))[..., :n].astype(bool)
    if last:
        return flat
    return np.moveaxis(flat, -1, axis if axis >= 0 else len(flat.shape) + axis)


def pack_transition_table(N: np.ndarray) -> np.ndarray:
    """``(A, ℓ, ℓ)`` bool → ``(A, ℓ, W)`` uint32 packed along the *row* (target) dim.

    ``N_packed[c, col]`` is the packed target set of source segment ``col`` — the
    transposed orientation needed by the OR-AND mat-vec (out = OR of rows of packed
    selected by the source vector's set bits).
    """
    return pack_bits(np.swapaxes(N, -1, -2), axis=-1)


def boolean_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Boolean-semiring product of (…, m, k) @ (…, k, n) boolean arrays."""
    return np.matmul(a.astype(np.uint8), b.astype(np.uint8)) > 0


def boolean_matvec(mat: np.ndarray, vec: np.ndarray) -> np.ndarray:
    return (mat.astype(np.uint8) @ vec.astype(np.uint8)) > 0


# ------------------------------------------------ torch-side bit packing
#
# PyTorch has no shifts or subtraction for ``torch.uint32`` on the CPU, so the
# port holds packed words as ``int32`` tensors carrying the uint32 bit pattern
# (compare them as ``t.numpy().view(np.uint32)``).

_WORD = 32


def pack_bits_torch(bits: torch.Tensor) -> torch.Tensor:
    """(…, ℓp) {0,1} numeric → (…, ℓp/32) int32 words along the last axis.

    Torch twin of :func:`pack_bits` (last axis only, ℓp % 32 == 0), bit for
    bit: bit ``b`` of word ``w`` is element ``32·w + b``.  The distinct bits
    are summed in int64 (no overflow into bit 31) and the sum is then
    reinterpreted as int32.
    """
    n = bits.shape[-1]
    if n % _WORD:
        raise ValueError(f"packed dim {n} must be a multiple of 32")
    r = (bits != 0).reshape(bits.shape[:-1] + (n // _WORD, _WORD)).to(torch.int64)
    weights = torch.ones(_WORD, dtype=torch.int64, device=bits.device) << torch.arange(
        _WORD, dtype=torch.int64, device=bits.device
    )
    words = (r * weights).sum(dim=-1)
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


def _shifts(device) -> torch.Tensor:
    return torch.arange(_WORD, dtype=torch.int32, device=device)


def _bits_of_words(words: torch.Tensor) -> torch.Tensor:
    """(…, W) words → (…, 32·W) int32 {0,1}, bit b of word w at 32·w + b.
    ``(x >> s) & 1`` reads bit ``s`` under the arithmetic shift too, so
    int32 words need no uint32 type."""
    bits = (words.unsqueeze(-1) >> _shifts(words.device)) & 1
    return bits.reshape(words.shape[:-1] + (-1,))


def unpack_bits_torch(packed: torch.Tensor, n: int) -> torch.Tensor:
    """(…, W) int32 words → (…, n) f32 {0,1} along the last axis: the
    inverse of :func:`pack_bits_torch`."""
    return _bits_of_words(packed)[..., :n].to(torch.float32)


def pack_transition_table_torch(N: torch.Tensor) -> torch.Tensor:
    """(…, ℓp, ℓp) {0,1} → (…, ℓp, W) int32 packed along the row (target)
    dim: twin of :func:`pack_transition_table`.  Row ``col`` of each matrix
    is the packed target set of source ``col``."""
    return pack_bits_torch(N.transpose(-1, -2))


# ------------------------------------------------- packed OR-AND semiring
#
# Twins of the reference's word-level semiring (``repro/core/matrices.py``):
# a {0,1} matrix M (ℓp, ℓp) is held as Q (ℓp, W) words, bit b of Q[col, w]
# equal to M[32·w + b, col] — row ``col`` is the target set of source
# ``col``.  Every op broadcasts leading axes: the port's join scan hands
# whole stacks to its combine and act.  The reference's bitwise-OR
# reduction has no torch counterpart, so ``_or_reduce`` folds by halving.


def _or_reduce(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Bitwise OR of ``x`` along ``dim`` (which is dropped), in ⌈log₂ n⌉
    halving steps; an empty axis gives zeros."""
    dim = dim % x.dim()
    while x.shape[dim] > 1:
        n = x.shape[dim]
        h = n // 2
        head = x.narrow(dim, 0, h) | x.narrow(dim, h, h)
        x = torch.cat([head, x.narrow(dim, n - 1, 1)], dim) if n % 2 else head
    if x.shape[dim] == 0:
        return torch.zeros(x.shape[:dim] + x.shape[dim + 1:], dtype=x.dtype, device=x.device)
    return x.squeeze(dim)


def packed_identity(ell_pad: int, device=None) -> torch.Tensor:
    """Packed identity (ℓp, W) int32: bit ``j`` set in row ``j``."""
    if ell_pad % _WORD:
        raise ValueError(f"packed dim {ell_pad} must be a multiple of 32")
    j = torch.arange(ell_pad, dtype=torch.int32, device=device)[:, None]
    w = torch.arange(ell_pad // _WORD, dtype=torch.int32, device=device)[None, :]
    one = torch.ones((), dtype=torch.int32, device=device)
    return torch.where(j // _WORD == w, one << (j % _WORD), torch.zeros_like(one))


def packed_semiring_matmul(later: torch.Tensor, earlier: torch.Tensor) -> torch.Tensor:
    """OR-AND product ``later ⊗ earlier`` of packed matrices.

    Row j of the result is the OR of ``later``'s rows selected by the set
    bits of ``earlier``'s row j: Qc[j] = OR_k bit_k(Qe[j]) · Ql[k].  ``later``
    is (…, ℓp, W); ``earlier`` is (…, R, W) with any row count R (R = ℓp for
    a product, S for gathered sparse rows).  The contraction loops over the
    W word blocks of k, so the live intermediate is (…, R, 32, W) words.
    """
    W = later.shape[-1]
    lead = torch.broadcast_shapes(later.shape[:-2], earlier.shape[:-2])
    acc = torch.zeros(lead + earlier.shape[-2:], dtype=torch.int32, device=earlier.device)
    shifts = _shifts(earlier.device)
    for wk in range(W):
        mask = 0 - ((earlier[..., wk, None] >> shifts) & 1)            # (…, R, 32)
        block = later[..., wk * _WORD:(wk + 1) * _WORD, :]              # (…, 32, W)
        acc = acc | _or_reduce(mask.unsqueeze(-1) & block.unsqueeze(-3), -2)
    return acc


def _select_or(Q: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """OR of ``Q``'s rows (…, ℓp, W) selected by ``bits`` (…, ℓp) {0,1}
    → (…, W)."""
    mask = 0 - bits.to(torch.int32)
    return _or_reduce(mask.unsqueeze(-1) & Q, -2)


def packed_matvec(Q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``M v`` with packed M: {0,1} f32 v (…, ℓp) → {0,1} f32 (…, ℓp)."""
    return unpack_bits_torch(_select_or(Q, v > 0.5), Q.shape[-2])


def packed_matvec_words(Q: torch.Tensor, vp: torch.Tensor) -> torch.Tensor:
    """``M v`` staying packed: words vp (…, W) → words (…, W)."""
    return _select_or(Q, _bits_of_words(vp))


def packed_matvec_T(Q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``Mᵀ v`` with packed M: out[col] = 1 iff v hits any target of col."""
    hits = _or_reduce(Q & pack_bits_torch(v).unsqueeze(-2), -1) != 0
    return hits.to(torch.float32)


def packed_matvec_T_words(Q: torch.Tensor, vp: torch.Tensor) -> torch.Tensor:
    """``Mᵀ v`` staying packed: words vp (…, W) → words (…, W)."""
    return pack_bits_torch(_or_reduce(Q & vp.unsqueeze(-2), -1) != 0)


# --------------------------------------------- sparse feasible-start products
#
# The reference's speculation-reduced product (``repro/core/matrices.py``):
# an (S, 1+W) array of gathered rows, P[j, 0] the source state of row j (or
# SPARSE_EMPTY for an unused slot) and P[j, 1:] its packed target words.
# P[0, 0] == SPARSE_IDENT flags the whole product as the identity.  Both
# sentinels fit in int32.  Indices at or past ℓp are dropped by routing them
# to a spare row that is then cut off: an out-of-range scatter index raises.

SPARSE_EMPTY = 0x7FFFFFFF   # unused slot (zero row)
SPARSE_IDENT = 0x7FFFFFFE   # in slot [0, 0]: product = identity


def sparse_identity(rows: int, W: int, device=None) -> torch.Tensor:
    """The identity product: flag set, no listed rows."""
    P = torch.zeros((rows, 1 + W), dtype=torch.int32, device=device)
    P[:, 0] = SPARSE_EMPTY
    P[0, 0] = SPARSE_IDENT
    return P


def sparse_is_identity(P: torch.Tensor) -> torch.Tensor:
    """Bool (…,): is each sparse product the flagged identity?"""
    return P[..., 0, 0] == SPARSE_IDENT


def sparse_init_rows(idx: torch.Tensor, ell_pad: int) -> torch.Tensor:
    """Packed identity rows e_idx: (…, S) indices → (…, S, W) int32 words;
    sentinel indices (≥ ℓp) give zero rows."""
    w = torch.arange(ell_pad // _WORD, dtype=torch.int32, device=idx.device)
    i = idx.to(torch.int32).unsqueeze(-1)
    one = torch.ones((), dtype=torch.int32, device=idx.device)
    return torch.where(
        (i < ell_pad) & (i // _WORD == w), one << (i % _WORD), torch.zeros_like(one)
    )


def _drop_index(idx: torch.Tensor, ell_pad: int) -> torch.Tensor:
    """Listed indices as int64, every sentinel sent to the spare slot ℓp."""
    idx = idx.to(torch.int64)
    return torch.where((idx >= 0) & (idx < ell_pad), idx, ell_pad)


def sparse_to_packed(P: torch.Tensor, ell_pad: int) -> torch.Tensor:
    """Sparse (…, S, 1+W) → dense packed (…, ℓp, W): listed rows scattered,
    zeros elsewhere; the flagged identity densifies to ``packed_identity``."""
    W = P.shape[-1] - 1
    idx = _drop_index(P[..., 0], ell_pad).unsqueeze(-1).expand(P.shape[:-1] + (W,))
    dense = torch.zeros(P.shape[:-2] + (ell_pad + 1, W), dtype=torch.int32, device=P.device)
    dense = dense.scatter(-2, idx, P[..., 1:])[..., :ell_pad, :]
    ident = packed_identity(ell_pad, P.device)
    return torch.where(sparse_is_identity(P)[..., None, None], ident, dense)


def sparse_compose(later: torch.Tensor, earlier: torch.Tensor) -> torch.Tensor:
    """``later ⊗ earlier`` of sparse products (leading axes broadcast).

    The result keeps ``earlier``'s index column and rewrites each listed row
    through ``later``: out[s] = OR of ``later``'s rows selected by the
    target bits of ``earlier[s]``.  Identity flags short-circuit either side.
    """
    W = later.shape[-1] - 1
    later, earlier = torch.broadcast_tensors(later, earlier)
    D = sparse_to_packed(later, W * _WORD)                          # (…, ℓp, W)
    words = packed_semiring_matmul(D, earlier[..., 1:])              # (…, S, W)
    composed = torch.cat([earlier[..., :1], words], dim=-1)
    out = torch.where(sparse_is_identity(later)[..., None, None], earlier, composed)
    return torch.where(sparse_is_identity(earlier)[..., None, None], later, out)


def sparse_matvec(P: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``M v`` with sparse M: {0,1} f32 v (…, ℓp) → {0,1} f32 (…, ℓp)."""
    W = P.shape[-1] - 1
    ell_pad = W * _WORD
    lead = torch.broadcast_shapes(P.shape[:-2], v.shape[:-1])
    idx = P[..., 0].expand(lead + P.shape[-2:-1]).to(torch.int64)
    listed = idx < ell_pad
    vi = torch.gather(v.expand(lead + v.shape[-1:]), -1, idx.clamp(0, ell_pad - 1))
    mask = 0 - (listed & (vi > 0.5)).to(torch.int32)
    words = _or_reduce(mask.unsqueeze(-1) & P[..., 1:], -2)           # (…, W)
    return torch.where(
        sparse_is_identity(P).unsqueeze(-1), v, unpack_bits_torch(words, ell_pad)
    )


def sparse_matvec_T(P: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``Mᵀ v`` with sparse M: nonzero only at listed source states whose
    target set meets v."""
    W = P.shape[-1] - 1
    ell_pad = W * _WORD
    vp = pack_bits_torch(v)
    hits = (_or_reduce(P[..., 1:] & vp.unsqueeze(-2), -1) != 0).to(torch.float32)
    lead = hits.shape[:-1]
    out = torch.zeros(lead + (ell_pad + 1,), dtype=torch.float32, device=P.device)
    idx = _drop_index(P[..., 0], ell_pad).expand(hits.shape)
    out = out.scatter(-1, idx, hits)[..., :ell_pad]
    return torch.where(sparse_is_identity(P).unsqueeze(-1), v, out)


def feasible_start_widths(N: np.ndarray, chunks: np.ndarray, depth: int = 1) -> np.ndarray:
    """Host-side observed speculation widths: per-chunk feasible-set sizes.

    For each (k,) chunk row of ``chunks``, the number of start states whose
    column of ``N[y_d] ⊗ … ⊗ N[y_1]`` is nonzero — the states a chunk
    processor actually needs to speculate on, vs the paper's ℓp.  Chunks
    starting with the PAD class (all-PAD padding) report -1: their product is
    the identity and they carry no speculation.  Pure numpy (stats path).
    """
    N = np.asarray(N) > 0
    chunks = np.asarray(chunks).reshape(-1, np.asarray(chunks).shape[-1])
    pad = N.shape[0] - 1
    out = np.empty(chunks.shape[0], dtype=np.int64)
    for i, chunk in enumerate(chunks):
        if chunk[0] == pad:
            out[i] = -1
            continue
        u = np.ones(N.shape[-1], dtype=bool)
        for j in range(min(depth, len(chunk)) - 1, -1, -1):
            u = (N[chunk[j]] & u[:, None]).any(axis=0)
        out[i] = int(u.sum())
    return out
