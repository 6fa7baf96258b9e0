"""Explicit finite automata of the parser (paper Sect. 2.3.4 and 3.1).

These are the paper-faithful machine constructions used by the reference (CPU)
parsers, the Tab. 5 validation benchmarks and the tests:

* ``ParserNFA``    — states = segments; arcs labeled by the char class read by the
                     *source* segment's end-letter.
* ``ParserDFA``    — classic powerset determinization from the initial-segment set
                     (Fig. 11).  *Not minimized* — minimization would merge states and
                     destroy the segment-set ↔ SLPF-column correspondence (Sect. 3.1).
* ``MultiEntryDFA``— powerset from *every singleton* segment (Fig. 12): one entry
                     state per segment, merged on equal segment sets (Gill's ME-DFA).

All are built over the char-class alphabet (App. A) so wildcards / sets stay compact.
The reverse machines are obtained from the reversed NFA (Eq. 5: transposed matrices,
I and F switched).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Tuple

from .segments import SegmentTable


@dataclass
class ParserNFA:
    table: SegmentTable
    n_states: int
    n_classes: int                      # real classes (incl. DEAD), no PAD here
    initial: FrozenSet[int]
    final: FrozenSet[int]
    # delta[state] = {class: (targets...)}
    delta: List[Dict[int, Tuple[int, ...]]]

    def step(self, states: FrozenSet[int], cls: int) -> FrozenSet[int]:
        out: set[int] = set()
        for s in states:
            out.update(self.delta[s].get(cls, ()))
        return frozenset(out)

    def run(self, classes) -> FrozenSet[int]:
        cur = self.initial
        for c in classes:
            cur = self.step(cur, int(c))
        return cur

    def accepts(self, classes) -> bool:
        return bool(self.run(classes) & self.final)

    def reverse(self) -> "ParserNFA":
        rdelta: List[Dict[int, List[int]]] = [dict() for _ in range(self.n_states)]
        for src, by_cls in enumerate(self.delta):
            for cls, targets in by_cls.items():
                for t in targets:
                    rdelta[t].setdefault(cls, []).append(src)
        return ParserNFA(
            table=self.table,
            n_states=self.n_states,
            n_classes=self.n_classes,
            initial=self.final,
            final=self.initial,
            delta=[{c: tuple(sorted(v)) for c, v in d.items()} for d in rdelta],
        )


def build_nfa(table: SegmentTable) -> ParserNFA:
    n = table.n
    delta: List[Dict[int, Tuple[int, ...]]] = []
    for src in range(n):
        d: Dict[int, Tuple[int, ...]] = {}
        succs = table.folseg[src]
        if succs:
            for cls in table.seg_classes[src]:
                d[cls] = succs
        delta.append(d)
    return ParserNFA(
        table=table,
        n_states=n,
        n_classes=table.numbered.n_classes,
        initial=frozenset(i for i in range(n) if table.initial[i]),
        final=frozenset(i for i in range(n) if table.final[i]),
        delta=delta,
    )


@dataclass
class DFA:
    """A deterministic automaton over segment sets (used for both DFA and ME-DFA)."""

    states: List[FrozenSet[int]]                  # state id → segment set
    index: Dict[FrozenSet[int], int]
    initial: List[int]                            # entry state ids (1 for DFA, ℓ for ME-DFA)
    final: List[bool]
    delta: List[Dict[int, int]]                   # state id → {class: state id}

    @property
    def n_states(self) -> int:
        return len(self.states)

    def step(self, state: int, cls: int) -> int | None:
        return self.delta[state].get(cls)

    def run(self, state: int, classes) -> int | None:
        for c in classes:
            state = self.delta[state].get(int(c))
            if state is None:  # dead
                return None
        return state


def _powerset(nfa: ParserNFA, seeds: List[FrozenSet[int]]) -> DFA:
    states: List[FrozenSet[int]] = []
    index: Dict[FrozenSet[int], int] = {}
    delta: List[Dict[int, int]] = []

    def intern(s: FrozenSet[int]) -> int:
        if s not in index:
            index[s] = len(states)
            states.append(s)
            delta.append({})
        return index[s]

    initial = [intern(s) for s in seeds]
    work = list(dict.fromkeys(initial))
    seen = set(work)
    while work:
        sid = work.pop()
        sset = states[sid]
        by_cls: Dict[int, set] = {}
        for q in sset:
            for cls, targets in nfa.delta[q].items():
                by_cls.setdefault(cls, set()).update(targets)
        for cls, targets in by_cls.items():
            tid = intern(frozenset(targets))
            delta[sid][cls] = tid
            if tid not in seen:
                seen.add(tid)
                work.append(tid)
    final = [bool(s & nfa.final) for s in states]
    return DFA(states=states, index=index, initial=initial, final=final, delta=delta)


def build_dfa(nfa: ParserNFA) -> DFA:
    """Classic powerset DFA from the initial-segment set (Fig. 11)."""
    return _powerset(nfa, [nfa.initial])


def build_medfa(nfa: ParserNFA) -> DFA:
    """Multi-entry DFA: one entry per segment singleton (Fig. 12).

    ``initial[j]`` is the entry state for segment ``j``; distinct DFA states reached
    from different entries are merged when they carry the same segment set.
    """
    seeds = [frozenset({j}) for j in range(nfa.n_states)]
    return _powerset(nfa, seeds)
