"""The benchmark's plain reference: the clean parse forest of a text, in plain PyTorch.

The automaton comes from the pattern through this folder's frozen front-end
(``regex``, ``numbering``, ``segments``): the Boolean matrix ``N[c]`` of each
character class has ``N[c][row, col] = 1`` iff segment ``col`` reads ``c`` and
``row`` follows it (the paper's Eq. 4); the PAD class is the identity and a
byte outside the pattern's alphabet falls in a class whose matrix is zero.
The clean forest of ``x`` is the column series ``C_r = Fwd_r ∧ Bwd_r``
(``r = 0 … n``) with

    Fwd_0 = I,  Fwd_r = N[x_r] · Fwd_{r-1};     Bwd_n = F,  Bwd_{r-1} = N[x_r]ᵀ · Bwd_r.

The recurrences are evaluated over the text cut into chunks of ``chunk``
characters: each chunk's transfer matrix (the product of its ``N[x]``), then
the chunk entry vectors one chunk after another on the host, then every
chunk's columns from its entries, all chunks at once.  Products of matrices
and vectors holding only 0 and 1 are exact in float32 and in float16 (with a
clamp to 1 after each product, every sum is at most ℓ ≤ 2048 and every partial
sum an integer that both types hold), whatever the order of the additions;
the host step runs on integers.  So the result is the recurrence's, bit for bit.

``clean=False`` returns the forward columns alone: the recognizer's columns,
which keep every segment reachable from the start whether or not it leads to
the end.  That is the benchmark's control: an answer that breaks the
configuration's guarantee of a clean forest.

Nothing here imports the program under test, and nothing takes a table, a
weight or a column from it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import torch

from .numbering import number_regex
from .segments import compute_segments


@dataclass
class Automaton:
    """The pattern's parser NFA as Boolean matrices (host arrays)."""

    N: np.ndarray               # (A + 1, ℓ, ℓ) bool; N[A] = identity (PAD)
    I: np.ndarray               # (ℓ,) bool
    F: np.ndarray               # (ℓ,) bool
    byte_to_class: np.ndarray   # (256,) int64

    @property
    def ell(self) -> int:
        return self.N.shape[1]

    @property
    def pad_class(self) -> int:
        return self.N.shape[0] - 1

    def classes(self, text: bytes) -> np.ndarray:
        return self.byte_to_class[np.frombuffer(text, dtype=np.uint8)]


def automaton(pattern: str) -> Automaton:
    table = compute_segments(number_regex(pattern))
    ell = table.n
    A = table.numbered.n_classes
    N = np.zeros((A + 1, ell, ell), dtype=bool)
    for col in range(ell):
        for cls in table.seg_classes[col]:
            for row in table.folseg[col]:
                N[cls, row, col] = True
    N[A] = np.eye(ell, dtype=bool)
    return Automaton(N=N, I=table.initial.copy(), F=table.final.copy(),
                     byte_to_class=np.asarray(table.numbered.byte_to_class, dtype=np.int64))


def _dtype(device: torch.device) -> torch.dtype:
    return torch.float16 if device.type == "cuda" else torch.float32


def _chunks(aut: Automaton, classes: np.ndarray, chunk: int, device) -> torch.Tensor:
    """(K, chunk) class ids on ``device``, the tail padded with PAD."""
    n = len(classes)
    K = max(1, -(-n // chunk))
    grid = np.full(K * chunk, aut.pad_class, dtype=np.int64)
    grid[:n] = classes
    return torch.from_numpy(grid.reshape(K, chunk)).to(device)


def transfer_matrices(aut: Automaton, ids: torch.Tensor, block: int = 1 << 14) -> np.ndarray:
    """(K, ℓ, ℓ) bool: each row of ``ids``'s product N[x_last] ⋯ N[x_first],
    computed ``block`` chunks at a time."""
    dev = ids.device
    dt = _dtype(dev)
    Nd = torch.as_tensor(aut.N, device=dev).to(dt)
    eye = torch.eye(aut.ell, device=dev, dtype=dt)
    out = []
    for lo in range(0, ids.shape[0], block):
        part = ids[lo:lo + block]
        P = eye.expand(part.shape[0], -1, -1).contiguous()
        for t in range(part.shape[1]):
            P = torch.bmm(Nd[part[:, t]], P).clamp_(max=1)
        out.append(P.bool().cpu().numpy())
    return np.concatenate(out)


def entries(aut: Automaton, P: np.ndarray):
    """Forward entry of every chunk (the columns before it) and backward
    exit of every chunk (the backward columns after it), from its transfer
    matrices, one chunk after another."""
    K = P.shape[0]
    Pi = P.astype(np.int32)
    fwd = np.zeros((K + 1, aut.ell), dtype=bool)
    fwd[0] = aut.I
    for k in range(K):
        fwd[k + 1] = (Pi[k] @ fwd[k].astype(np.int32)) > 0
    bwd = np.zeros((K, aut.ell), dtype=bool)
    b = aut.F.copy()
    for k in range(K - 1, -1, -1):
        bwd[k] = b
        b = (Pi[k].T @ b.astype(np.int32)) > 0
    return fwd, bwd


def _columns(Nd: torch.Tensor, ids: torch.Tensor, start: torch.Tensor, reverse: bool) -> torch.Tensor:
    """(K, chunk, ℓ) bool: for each character t of each chunk k, the forward
    vector after it (column k·chunk + t + 1), or, walking back from each
    chunk's exit, the backward vector before it (column k·chunk + t)."""
    K, L = ids.shape
    out = torch.empty((K, L, Nd.shape[1]), dtype=torch.bool, device=ids.device)
    rows = torch.arange(K, device=ids.device)
    v = start
    steps = range(L - 1, -1, -1) if reverse else range(L)
    spec = "aji,kj->kai" if reverse else "aij,kj->kai"
    for t in steps:
        v = torch.einsum(spec, Nd, v)[rows, ids[:, t]].clamp_(max=1)
        out[:, t] = v > 0
    return out


def forest(aut: Automaton, text: bytes, device, *, chunk: int = 1024, clean: bool = True) -> torch.Tensor:
    """(n + 1, ℓ) bool columns of ``text`` on ``device``: the clean forest, or
    with ``clean=False`` the forward columns alone (the control)."""
    classes = aut.classes(text)
    n = len(classes)
    chunk = max(1, min(chunk, n))
    ids = _chunks(aut, classes, chunk, device)
    P = transfer_matrices(aut, ids)
    fwd, bwd = entries(aut, P)
    dt = _dtype(ids.device)
    Nd = torch.as_tensor(aut.N, device=ids.device).to(dt)
    K = ids.shape[0]
    F_cols = _columns(Nd, ids, torch.as_tensor(fwd[:K], device=ids.device).to(dt), False)
    cols = torch.empty((K * chunk + 1, aut.ell), dtype=torch.bool, device=ids.device)
    cols[0] = torch.as_tensor(aut.I, device=ids.device)
    cols[1:] = F_cols.reshape(-1, aut.ell)
    del F_cols
    if clean:
        B_cols = _columns(Nd, ids, torch.as_tensor(bwd, device=ids.device).to(dt), True)
        # backward column before character t of chunk k is column k·chunk + t;
        # the one after the whole text is F
        cols[:-1] &= B_cols.reshape(-1, aut.ell)
        cols[-1] &= torch.as_tensor(aut.F, device=ids.device)
    return cols[: n + 1]


def accepted_through(aut: Automaton, transfers: Sequence[np.ndarray]) -> bool:
    """Whether the text whose consecutive parts have the given transfer
    matrices is accepted: I carried through them meets F."""
    v = aut.I.astype(np.int32)
    for P in transfers:
        v = ((P.astype(np.int32) @ v) > 0).astype(np.int32)
    return bool((v.astype(bool) & aut.F).any())


def piece_transfers(aut: Automaton, pieces: List[bytes], device, *, chunk: int = 1024) -> List[np.ndarray]:
    """Each piece's transfer matrix (the product over all its characters):
    every piece cut into chunks (its tail padded with PAD), all chunks'
    products at once, then each piece's chunk products multiplied pairwise,
    later by earlier, on ``device`` (exact as above)."""
    grids, counts = [], []
    for text in pieces:
        classes = aut.classes(text)
        K = max(1, -(-len(classes) // chunk))
        grid = np.full(K * chunk, aut.pad_class, dtype=np.int64)
        grid[:len(classes)] = classes
        grids.append(grid.reshape(K, chunk))
        counts.append(K)
    P = transfer_matrices(aut, torch.from_numpy(np.concatenate(grids)).to(device))
    dt = _dtype(torch.device(device))
    m = 1 << max(0, max(counts) - 1).bit_length()
    stack = torch.eye(aut.ell, dtype=dt, device=device).repeat(len(pieces), m, 1, 1)
    at = 0
    for i, K in enumerate(counts):
        stack[i, :K] = torch.as_tensor(P[at:at + K], device=device).to(dt)
        at += K
    while stack.shape[1] > 1:
        stack = torch.matmul(stack[:, 1::2], stack[:, 0::2]).clamp_(max=1)
    return list(stack[:, 0].bool().cpu().numpy())


def differing_bits(got: np.ndarray, want: torch.Tensor, block_rows: int = 1 << 22) -> int:
    """The number of (column, segment) bits where ``got`` (the program's host
    columns) and ``want`` differ; a shape mismatch counts every bit of both."""
    if tuple(got.shape) != tuple(want.shape):
        return int(np.prod(got.shape)) + int(np.prod(tuple(want.shape)))
    total = 0
    for lo in range(0, got.shape[0], block_rows):
        part = torch.from_numpy(np.ascontiguousarray(got[lo:lo + block_rows])).to(want.device)
        total += int((part != want[lo:lo + block_rows]).sum())
    return total


def accepted(cols: torch.Tensor) -> bool:
    return bool(cols[-1].any())
