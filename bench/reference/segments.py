"""Segment computation (paper Sect. 2.3.2–2.3.3, Fig. 5) and FolSeg (Eq. 3).

A *segment* is a maximal substring ``μ a`` of an LST where ``μ`` (the meta-prefix) is
made of numbered parentheses / numbered epsilons and ``a`` (the end-letter) is a
numbered terminal or the end-mark ⊣.

The paper's Fig. 5 algorithm extends meta-prefixes right-to-left from each end-letter.
We enumerate equivalently *left-to-right*: a segment occurrence always starts right
after an end-letter (or at the very start of the LST), so walking the ``Fol`` relation
forward from every anchor (START ∪ terminals) through metasymbols until the next
end-letter enumerates exactly the maximal factors.  Since the LST language is local
(Sect. 2.3.4), every such walk is realizable in some LST, and every segment is found.

Termination: for non-infinitely-ambiguous REs a meta-prefix cannot repeat a numbered
metasymbol (Prop. 2) — we bound each symbol to one occurrence per meta-prefix.  For
infinitely ambiguous REs we follow App. A: symbols may repeat up to ``inf_limit``
times, yielding a finite representative sample of the LSTs.

Frozen copy of ``repro_torch/core/segments.py`` for the benchmark's reference: the
reference builds its automaton from the pattern with this code, never with the
program's, so that a later change to the program's front-end cannot move the
yardstick.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .numbering import END, EPS, NumberedRE, TERM, number_regex


class SegmentExplosion(RuntimeError):
    pass


@dataclass
class SegmentTable:
    numbered: NumberedRE
    segs: List[Tuple[int, ...]]          # segment id → tuple of sids (meta* + end-letter)
    index: Dict[Tuple[int, ...], int]
    initial: np.ndarray                  # (ℓ,) bool — set I
    final: np.ndarray                    # (ℓ,) bool — set F
    folseg: List[Tuple[int, ...]]        # segment id → follower segment ids (Eq. 3)
    end_letter: List[int]                # segment id → sid of its end-letter
    seg_classes: List[Tuple[int, ...]]   # segment id → char classes its end-letter reads

    @property
    def n(self) -> int:
        return len(self.segs)

    def display(self, i: int) -> str:
        return "".join(self.numbered.display_sym(s) for s in self.segs[i])

    def all_displays(self) -> List[str]:
        return [self.display(i) for i in range(self.n)]

    def delta(self, seg: int, cls: int) -> Tuple[int, ...]:
        """NFA transition: from ``seg`` reading char-class ``cls`` (Sect. 2.3.4)."""
        if cls in self.seg_classes[seg]:
            return self.folseg[seg]
        return ()


def compute_segments(
    numbered: NumberedRE | str,
    *,
    inf_limit: int = 2,
    max_segments: int = 200_000,
) -> SegmentTable:
    if isinstance(numbered, str):
        numbered = number_regex(numbered)
    syms = numbered.symbols
    follow = numbered.follow
    end_sid = numbered.end_sid

    limit = inf_limit if numbered.infinitely_ambiguous else 1

    is_end_letter = [s.kind in (TERM, END) for s in syms]

    segs: Dict[Tuple[int, ...], int] = {}
    seg_list: List[Tuple[int, ...]] = []
    initial_flags: List[bool] = []

    def add(seg: Tuple[int, ...], is_initial: bool) -> None:
        if seg in segs:
            if is_initial:
                initial_flags[segs[seg]] = True
            return
        if len(seg_list) >= max_segments:
            raise SegmentExplosion(
                f"more than {max_segments} segments; RE too ambiguous for this limit"
            )
        segs[seg] = len(seg_list)
        seg_list.append(seg)
        initial_flags.append(is_initial)

    # Walk forward through metasymbols from every anchor successor.
    def walk(start_sym: int, is_initial: bool) -> None:
        # iterative DFS over (path, counts)
        stack: List[Tuple[Tuple[int, ...], Dict[int, int]]] = [((start_sym,), {start_sym: 1})]
        while stack:
            path, counts = stack.pop()
            last = path[-1]
            if is_end_letter[last]:
                add(path, is_initial)
                continue
            for nxt in follow.get(last, ()):  # extend through the metasymbol
                c = counts.get(nxt, 0)
                if c >= limit:
                    continue
                nc = dict(counts)
                nc[nxt] = c + 1
                stack.append((path + (nxt,), nc))

    for s in sorted(numbered.first):
        walk(s, True)
    for sym in syms:
        if sym.kind == TERM:
            for s in sorted(follow.get(sym.sid, ())):
                walk(s, False)

    n = len(seg_list)
    end_letter = [seg[-1] for seg in seg_list]
    final = np.array([el == end_sid for el in end_letter], dtype=bool)
    initial = np.array(initial_flags, dtype=bool)

    # FolSeg (Eq. 3): σ follows ρ iff first-symbol(σ) ∈ Fol(end-letter(ρ)).
    by_first: Dict[int, List[int]] = {}
    for i, seg in enumerate(seg_list):
        by_first.setdefault(seg[0], []).append(i)
    folseg: List[Tuple[int, ...]] = []
    for i in range(n):
        succs: List[int] = []
        for s in follow.get(end_letter[i], ()):
            succs.extend(by_first.get(s, ()))
        folseg.append(tuple(sorted(set(succs))))

    seg_classes = [
        numbered.term_classes.get(end_letter[i], ()) if end_letter[i] != end_sid else ()
        for i in range(n)
    ]

    return SegmentTable(
        numbered=numbered,
        segs=seg_list,
        index=segs,
        initial=initial,
        final=final,
        folseg=folseg,
        end_letter=end_letter,
        seg_classes=seg_classes,
    )
