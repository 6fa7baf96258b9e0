"""Serial parsers (paper Sect. 2.4 and Sect. 4.1 — *serial parser*).

Two paper-faithful serial algorithms, both returning the clean SLPF:

* ``parse_serial_matrix`` — the NFA matrix parser of Fig. 10 / Eq. (4):
  ``C_r = N_{x_r} × C_{r-1}`` forwards from ``I``, ``Ĉ_r = N^T_{x_{r+1}} × Ĉ_{r+1}``
  backwards from ``F``, clean column = ``C_r ∩ Ĉ_r``.  Boolean matmuls in numpy.
  This is the baseline the parallel parser is derived from — slow but transparent.

* ``parse_serial_dfa`` — the DFA look-up-table parser outlined in Sect. 4.1:
  one forward DFA run (each DFA state *is* the segment-set column) and one
  backward reverse-DFA run, intersected per column.  Same output, no matmuls.

Also: ``recognize`` — the mere recognizer (forward only, Sect. 4.2).  The
port's copy of ``repro/core/serial.py``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .automata import DFA, ParserNFA, build_dfa, build_nfa
from .matrices import ParserMatrices, boolean_matvec, build_matrices
from .numbering import number_regex
from .segments import SegmentTable, compute_segments
from .slpf import SLPF


def _as_classes(matrices: ParserMatrices, text) -> np.ndarray:
    if isinstance(text, (bytes, str)):
        return matrices.classes_of_text(text)
    return np.asarray(text, dtype=np.int32)


def parse_serial_matrix(matrices: ParserMatrices, text) -> SLPF:
    """Fig. 10: forward + backward Boolean matrix passes, then intersect."""
    classes = _as_classes(matrices, text)
    n = len(classes)
    ell = matrices.n_segments
    N = matrices.N

    C = np.zeros((n + 1, ell), dtype=bool)
    C[0] = matrices.I
    for r in range(1, n + 1):
        C[r] = boolean_matvec(N[classes[r - 1]], C[r - 1])

    # Backward pass with the reverse NFA: transposed matrices, I and F switched
    # (Eq. 5).  Overwrites C in place with the intersection — the paper's memory
    # optimization (Sect. 2.4 note / Fig. 14 applied to the serial case).
    back = matrices.F.copy()
    C[n] &= back
    for r in range(n - 1, -1, -1):
        back = boolean_matvec(N[classes[r]].T, back)
        C[r] &= back

    return SLPF(table=matrices.table, columns=C, classes=classes)


def parse_serial_dfa(
    matrices: ParserMatrices,
    text,
    dfa: Optional[DFA] = None,
    rdfa: Optional[DFA] = None,
    nfa: Optional[ParserNFA] = None,
) -> SLPF:
    """Sect. 4.1 serial DFA parser: look-up-table forward + backward runs."""
    classes = _as_classes(matrices, text)
    table = matrices.table
    if nfa is None:
        nfa = build_nfa(table)
    if dfa is None:
        dfa = build_dfa(nfa)
    if rdfa is None:
        rdfa = build_dfa(nfa.reverse())

    n = len(classes)
    ell = table.n
    pad = matrices.pad_class

    def run(d: DFA, seq) -> list:
        """Forward column series as segment-set vectors; dead state ⇒ empty."""
        cols = [np.zeros(ell, dtype=bool)]
        state: Optional[int] = d.initial[0]
        for q in d.states[state]:
            cols[0][q] = True
        for c in seq:
            c = int(c)
            if state is not None and c != pad:
                state = d.step(state, c)
            col = np.zeros(ell, dtype=bool)
            if state is not None:
                for q in d.states[state]:
                    col[q] = True
            cols.append(col)
        return cols

    fwd = run(dfa, classes)
    bwd = run(rdfa, classes[::-1])[::-1]
    C = np.stack([f & b for f, b in zip(fwd, bwd)])
    return SLPF(table=table, columns=C, classes=classes)


def recognize(matrices: ParserMatrices, text, dfa: Optional[DFA] = None) -> bool:
    """Mere recognizer (Sect. 4.2): forward DFA run, check final."""
    classes = _as_classes(matrices, text)
    if dfa is None:
        dfa = build_dfa(build_nfa(matrices.table))
    state: Optional[int] = dfa.initial[0]
    for c in classes:
        state = dfa.step(state, int(c))
        if state is None:
            return False
    return dfa.final[state]


class SerialParser:
    """Convenience wrapper bundling the generated artifacts for one RE."""

    def __init__(self, pattern: str, *, mask_ops=(), inf_limit: int = 2):
        self.table: SegmentTable = compute_segments(
            number_regex(pattern, mask_ops=mask_ops), inf_limit=inf_limit
        )
        self.matrices = build_matrices(self.table)
        self.nfa = build_nfa(self.table)
        self.dfa = build_dfa(self.nfa)
        self.rdfa = build_dfa(self.nfa.reverse())

    def parse(self, text, *, method: str = "dfa") -> SLPF:
        if method == "matrix":
            return parse_serial_matrix(self.matrices, text)
        return parse_serial_dfa(self.matrices, text, self.dfa, self.rdfa, self.nfa)

    def accepts(self, text) -> bool:
        return recognize(self.matrices, text, self.dfa)
