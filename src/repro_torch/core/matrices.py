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
