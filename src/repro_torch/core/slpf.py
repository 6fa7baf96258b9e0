"""Shared Linearized Parse Forest (paper Sect. 2.3.5, App. B, App. C).

The SLPF of a text ``x`` (length ``n``) is a DAG stored as ``n+1`` columns; column
``C_r`` is the set of segments located between characters ``x_r`` and ``x_{r+1}``
(``C_0`` before the first character, ``C_n`` holding the final segments whose
end-letter is ⊣).  A segment ``q ∈ C_r`` for ``1 ≤ r ≤ n`` was reached *reading*
``x_r``: its end-letter matches ``x_r`` and its meta-prefix sits between ``x_{r-1}``
and ``x_r``.  Arcs are implicit — they are the parser-NFA arcs restricted to
consecutive columns (Sect. 2.3.5) — so the storage is exactly the Boolean column
series of Eq. (4), here a dense ``(n+1, ℓ)`` bool array (bit-packable, App. C).

A *clean* SLPF contains only useful segments: every node lies on a path from an
initial segment in ``C_0`` to a final one in ``C_n``; each such path is one LST.

This module provides the forest-level API of the tool (Sect. 4.2):
  * ``count_trees``        — number of LSTs (paths), exact big-int DP;
  * ``iter_trees``         — lazy enumeration of LSTs as segment paths;
  * ``lst_string``         — render a path as the parenthesized LST;
  * ``getMatches``         — spans of a numbered group / operator pair (App. A
                             extra parentheses), per-tree exact or column-scan fast;
  * ``getChildren``        — child spans of a match, from the tree structure;
  * ``pack / unpack``      — App. C bit-packed encoding (uint32 words);
  * ``SLPFCompressor``     — App. C SLPF-DFA compression (columns as interned
                             states + a transition table keyed on (state, class)).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .matrices import ParserMatrices, pack_bits, unpack_bits
from .numbering import CLOSE, OPEN
from .segments import SegmentTable


@dataclass
class SLPF:
    """Clean shared linearized parse forest of one text."""

    table: SegmentTable
    columns: np.ndarray        # (n+1, ℓ) bool
    classes: np.ndarray        # (n,) int32 — char classes of the text

    @property
    def n(self) -> int:
        return self.columns.shape[0] - 1

    @property
    def n_segments(self) -> int:
        return self.columns.shape[1]

    @property
    def accepted(self) -> bool:
        """Non-empty forest ⇔ the text is valid (clean SLPF of a valid text is
        non-empty everywhere; of an invalid text it is empty everywhere)."""
        return bool(self.columns[-1].any())

    # ----------------------------------------------------------------- arcs

    def arcs(self, r: int) -> List[Tuple[int, int]]:
        """NFA arcs from column r-1 to column r (1 ≤ r ≤ n)."""
        t = self.table
        cls = int(self.classes[r - 1])
        out = []
        src_col = np.flatnonzero(self.columns[r - 1])
        dst_col = set(np.flatnonzero(self.columns[r]).tolist())
        for p in src_col:
            for q in t.delta(int(p), cls):
                if q in dst_col:
                    out.append((int(p), int(q)))
        return out

    # ------------------------------------------------------------- counting

    def count_trees(self) -> int:
        """Exact number of LSTs = number of C_0→C_n paths (python big ints)."""
        if not self.accepted:
            return 0
        one = self._one_segment_columns()
        if one is not None:
            return int(one[1])
        t = self.table
        ell = self.n_segments
        f = [1 if self.columns[0][q] else 0 for q in range(ell)]
        for r in range(1, self.n + 1):
            cls = int(self.classes[r - 1])
            g = [0] * ell
            for p in range(ell):
                if f[p]:
                    for q in t.delta(p, cls):
                        if self.columns[r][q]:
                            g[q] += f[p]
            f = g
        fin = self.table.final
        return sum(f[q] for q in range(ell) if self.columns[-1][q] and fin[q])

    # ---------------------------------------------------------- enumeration

    def _one_segment_columns(self) -> Optional[Tuple[np.ndarray, bool]]:
        """Where every column holds exactly one segment (the clean forest of
        a text with one parse): that segment per column and whether the
        column series is an LST (every step an arc of the parser NFA, the
        last segment final); else None.  ``count_trees`` and ``iter_trees``
        take this case in O(n) array work instead of a walk of every
        position in Python, with the same result."""
        cols = self.columns
        if self.n_segments == 0 or not (cols.sum(axis=1) == 1).all():
            return None
        path = cols.argmax(axis=1)
        t = self.table
        used = np.unique(self.classes)
        reads = np.array([[int(c) in t.seg_classes[q] for c in used]
                          for q in range(self.n_segments)], dtype=bool)
        reads = reads.reshape(self.n_segments, used.size)
        follows = np.zeros((self.n_segments, self.n_segments), dtype=bool)
        for q in range(self.n_segments):
            follows[q, list(t.folseg[q])] = True
        steps = np.searchsorted(used, self.classes)
        lst = bool(reads[path[:-1], steps].all() and follows[path[:-1], path[1:]].all()
                   and t.final[int(path[-1])])
        return path, lst

    def iter_trees(self, limit: Optional[int] = None) -> Iterator[Tuple[int, ...]]:
        """Yield LSTs as tuples of segment ids (path through the columns).

        Depth first, a path kept as a chain of (segment, parent) nodes so
        that a step costs O(1) and a yielded tree O(n)."""
        if not self.accepted:
            return
        one = self._one_segment_columns()
        if one is not None:
            if one[1]:
                yield tuple(one[0].tolist())
            return
        t = self.table
        n = self.n
        emitted = 0
        stack: List[Tuple[int, tuple]] = [
            (0, (int(q), None)) for q in np.flatnonzero(self.columns[0])[::-1]
        ]
        while stack:
            r, node = stack.pop()
            if r == n:
                if not t.final[node[0]]:
                    continue  # an LST must end with a ⊣ segment
                path = []
                while node is not None:
                    path.append(node[0])
                    node = node[1]
                yield tuple(reversed(path))
                emitted += 1
                if limit is not None and emitted >= limit:
                    return
                continue
            cls = int(self.classes[r])
            for q in reversed(t.delta(node[0], cls)):
                if self.columns[r + 1][q]:
                    stack.append((r + 1, (q, node)))

    def lst_string(self, path: Sequence[int], with_end: bool = False) -> str:
        """Render a segment path as the parenthesized LST string."""
        s = "".join(self.table.display(q) for q in path)
        return s if with_end else s.replace("⊣", "")

    # ------------------------------------------------------ match extraction

    def _group_positions(self, num: int) -> Tuple[List[int], List[int]]:
        """Columns whose segments' meta-prefixes contain the open/close paren
        numbered ``num``.  A segment in C_r sits between x_r and x_{r+1} and its
        end-letter reads x_{r+1}, so a paren in its meta-prefix lies at 0-based
        char boundary r.  Sound for clean SLPFs: every occurrence is on a tree."""
        syms = self.table.numbered.symbols
        opens_in = np.zeros(self.n_segments, dtype=bool)
        closes_in = np.zeros(self.n_segments, dtype=bool)
        for i, seg in enumerate(self.table.segs):
            for sid in seg[:-1]:
                s = syms[sid]
                if s.num == num and s.kind == OPEN:
                    opens_in[i] = True
                if s.num == num and s.kind == CLOSE:
                    closes_in[i] = True
            # ⊣ segments: parens before ⊣ are also in seg[:-1]; end-letter never a paren
        open_cols = [r for r in range(self.n + 1) if (self.columns[r] & opens_in).any()]
        close_cols = [r for r in range(self.n + 1) if (self.columns[r] & closes_in).any()]
        return open_cols, close_cols

    def get_matches(self, num: int, limit: Optional[int] = 1000) -> List[Tuple[int, int]]:
        """Spans (start, end) of text matched by paren pair ``num`` (App. A).

        Exact per-tree extraction: walks up to ``limit`` trees and pairs the
        open/close parens along each LST.  ``end`` is exclusive.
        """
        syms = self.table.numbered.symbols
        # each segment's parens numbered ``num``, in meta-prefix order
        parens = [[syms[sid].kind for sid in seg[:-1]
                   if syms[sid].num == num and syms[sid].kind in (OPEN, CLOSE)]
                  for seg in self.table.segs]
        has = np.array([bool(k) for k in parens], dtype=bool)
        spans: Dict[Tuple[int, int], None] = {}
        for path in self.iter_trees(limit=limit):
            # path[r] ∈ C_r sits between x_r and x_{r+1}: parens in its metaprefix
            # lie at 0-based char boundary r (group spans are half-open [start, end)).
            at = np.asarray(path, dtype=np.int64)
            starts: List[int] = []
            for r in np.flatnonzero(has[at]).tolist():
                for kind in parens[path[r]]:
                    if kind == OPEN:
                        starts.append(r)
                    else:
                        st = starts.pop() if starts else 0
                        spans[(st, r)] = None
        return sorted(spans.keys())

    def get_children(self, path: Sequence[int]) -> List[Tuple[int, int, int]]:
        """(paren_num, start, end) for every paren pair on one LST path."""
        syms = self.table.numbered.symbols
        out: List[Tuple[int, int, int]] = []
        stack: List[Tuple[int, int]] = []
        for r, q in enumerate(path):
            for sid in self.table.segs[q][:-1]:
                s = syms[sid]
                if s.kind == OPEN:
                    stack.append((s.num, r))
                elif s.kind == CLOSE:
                    num, st = stack.pop()
                    assert num == s.num, "mismatched parens in LST"
                    out.append((num, st, r))
        return sorted(out)

    # ------------------------------------------------------------ App. C

    def pack(self) -> np.ndarray:
        """Bit-packed columns: (n+1, W) uint32, W = ceil(ℓ/32)."""
        return pack_bits(self.columns, axis=-1)

    @classmethod
    def from_packed(
        cls, table: SegmentTable, packed: np.ndarray, classes: np.ndarray
    ) -> "SLPF":
        cols = unpack_bits(packed, table.n, axis=-1)
        return cls(table=table, columns=cols, classes=np.asarray(classes))


@dataclass
class CompressedSLPF:
    """App. C SLPF-DFA compression: columns interned; transitions keyed on
    (column-state, char class).  Reconstruction replays the text.

    Deviation from the paper (documented, DESIGN §8): for a *clean* SLPF the
    successor column is NOT always a function of (column, next char) — cleaning
    intersects with backward context, so the same (column, char) can have
    different successors at different positions (e.g. near the text end).  The
    paper's App. C delta table alone is therefore lossy; we keep it and add a
    sparse ``overrides`` map {position → state} recording the conflicting
    steps, which restores exact reconstruction (empirically a handful of
    entries, near the endpoints)."""

    table: SegmentTable
    initial_state: int
    states: List[np.ndarray]                       # state id → (ℓ,) bool column
    delta: Dict[Tuple[int, int], int]              # (state, class) → state
    overrides: Dict[int, int]                      # position r → state id
    classes: np.ndarray

    def nbytes(self) -> int:
        ell = self.table.n
        words = (ell + 31) // 32
        return (
            len(self.states) * words * 4
            + len(self.delta) * 12
            + len(self.overrides) * 8
            + self.classes.nbytes
        )

    def reconstruct(self) -> SLPF:
        cols = [self.states[self.initial_state]]
        s = self.initial_state
        for r in range(1, len(self.classes) + 1):
            if r in self.overrides:
                s = self.overrides[r]
            else:
                s = self.delta[(s, int(self.classes[r - 1]))]
            cols.append(self.states[s])
        return SLPF(table=self.table, columns=np.stack(cols), classes=self.classes)


def compress(slpf: SLPF) -> CompressedSLPF:
    """Build the SLPF-DFA of one forest (App. C + exactness overrides)."""
    index: Dict[bytes, int] = {}
    states: List[np.ndarray] = []

    def intern(col: np.ndarray) -> int:
        key = np.packbits(col).tobytes()
        if key not in index:
            index[key] = len(states)
            states.append(col.copy())
        return index[key]

    delta: Dict[Tuple[int, int], int] = {}
    overrides: Dict[int, int] = {}
    prev = intern(slpf.columns[0])
    init = prev
    for r in range(1, slpf.n + 1):
        cur = intern(slpf.columns[r])
        key = (prev, int(slpf.classes[r - 1]))
        if key not in delta:
            delta[key] = cur
        elif delta[key] != cur:
            overrides[r] = cur  # clean-SLPF non-determinism (see class docstring)
        prev = cur
    return CompressedSLPF(
        table=slpf.table, initial_state=init, states=states, delta=delta,
        overrides=overrides, classes=slpf.classes,
    )
