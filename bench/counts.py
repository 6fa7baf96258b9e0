"""Frozen operation and byte counts of the parser's kernels, and the H100's peaks.

A copy of the formulas of ``repro_torch/kernels/{reach,build,semiring}.py``
``cost()`` and of the rates of ``repro_torch/kernels/cost.py`` as they stand
when this benchmark was written, kept here so that a change to the program
cannot move the yardstick.  A roofline share is the least time these counts
allow over the device time the trace gives the kernel; a share near or above
100 % says the count is too high, not that the kernel beats the card.

Counts are of real work: ``steps`` is the characters read (a chunk's PAD steps
are not needed), ``ell`` the automaton's ℓ live states of the ℓp the tables are
padded to; bytes count each input read once and each output written once.
The {0, 1} products are exact on the int8 tensor cores, the cheapest exact
type, so operations run at the int8 rate.
"""

from __future__ import annotations

INT8_OPS = 1979e12           # int8 tensor cores, dense, one H100 SXM at 700 W (NVIDIA data sheet)
HBM_BW = 3.35e12             # bytes/s of HBM3, one H100 SXM


def next_pow2(n: int) -> int:
    """The padded batch a launch over ``n`` rows runs (the program pads to a power of two)."""
    return 1 << max(0, int(n) - 1).bit_length()


def seconds(ops: float, nbytes: float) -> float:
    """The least time: the larger of the operations' and the bytes' times."""
    return max(ops / INT8_OPS, nbytes / HBM_BW)


def k1(C: int, k: int, lp: int, n_tables: int, steps: int, ell: int):
    """K1 reach over a (C, k) grid of class ids: one ℓ × ℓ Boolean product a
    step (2·ℓ³); bytes: the int32 ids, the f32 tables (n_tables = A + 1 of
    ℓp × ℓp) and the C f32 products."""
    return 2.0 * steps * ell ** 3, 4.0 * (C * k + n_tables * lp * lp + C * lp * lp)


def k2(C: int, k: int, lp: int, n_tables: int, steps: int, ell: int):
    """K2 build&merge: a forward and a backward ℓ × ℓ mat-vec a step (4·ℓ²);
    bytes: the ids, the tables, both entry stacks and the packed columns."""
    return (4.0 * steps * ell * ell,
            4.0 * (C * k + n_tables * lp * lp + 2 * C * lp + C * k * lp // 32))


def k3(batch: int, m: int, kk: int, n: int, ell: int):
    """K3, one launch of ``batch`` (m × kk) · (kk × n) Boolean products, each
    dimension that is not 1 counted at ℓ live states; bytes: both operands and
    the output at their padded sizes."""
    live = [d if d == 1 else ell for d in (m, kk, n)]
    return 2.0 * batch * live[0] * live[1] * live[2], 4.0 * batch * (m * kk + kk * n + m * n)


def join(c: int, lp: int, ell: int):
    """The least a join over ``c`` chunk products needs: each chunk's entry
    carried once forward and once backward, one ℓ-vector through one product
    each way (two (ℓ × ℓ) · (ℓ × 1) products a chunk, K3's count); bytes:
    the product stack read once, both entry stacks written once."""
    ops, _ = k3(2 * c, lp, lp, 1, ell)
    return ops, 4.0 * c * (lp * lp + 2 * lp)


def parse(n: int, C: int, k: int, lp: int, n_tables: int, ell: int):
    """A whole parse of ``n`` characters on a (C, k) grid: K1, the join and K2's
    operations; bytes: the text in (one a character) and the packed columns
    out ((n + 1) × ℓp/32 words)."""
    ops = k1(C, k, lp, n_tables, n, ell)[0] + join(C, lp, ell)[0] + k2(C, k, lp, n_tables, n, ell)[0]
    return ops, float(n) + 4.0 * (n + 1) * (lp // 32)


def append(piece: int, k: int, lp: int, ell: int):
    """One append of ``piece`` characters: its reach (K1, one chunk of k) and
    the compose that folds it into the stream (K3, one ℓ × ℓ product).  The
    tables are read once a batched launch, not once an append: not counted."""
    r_ops, r_bytes = k1(1, k, lp, 0, piece, ell)
    c_ops, c_bytes = k3(1, lp, lp, lp, ell)
    return r_ops + c_ops, r_bytes + c_bytes


# the kernels' function names in the device trace start so (csrc/reach.cu,
# build_merge.cu, semiring.cu)
KERNEL_PREFIX = {"k1": "reach_", "k2": "build_merge_", "k3": "semiring_"}
