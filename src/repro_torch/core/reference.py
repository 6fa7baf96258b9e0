"""Paper-faithful parallel parser (Sect. 3.2, Tab. 6, Ex. 6) — the reference oracle.

This module reproduces the published algorithm *exactly* as specified, phase by
phase, over explicit ME-DFA / DFA look-up tables:

  split  — text → c chunks (equal length; the last may be shorter, per Sect. 3.2
           we also support the paper's simplifying equal-length assumption);
  reach  — Eq. (6): per chunk, per ME-DFA entry (one per segment), run the
           ME-DFA to the chunk end → edge-segment sets R[i][j];
  join   — Eq. (7): J_0 = I;  J_i = ∪_{q_j ∈ J_{i-1}} R[i][j];
  build  — Eq. (8): per chunk, DFA run from J_{i-1} emitting every column B;
  merge  — Eq. (9): M = B ∩ B̂ per position;
  compose— C_0 = J_0 ∩ Ĵ_1, then concatenate the M columns.

The backward phases use the reverse ME-DFA / DFA built from the reversed NFA
(Eq. 5).  A fused ``builder&merger`` (Fig. 14) variant is provided too: one pass
forward storing M, one backward pass with a TMP column ANDing in place.

Everything is pure Python over frozensets/numpy — slow, obviously correct, used
as the oracle for the engine and the kernels.  The port's copy of
``repro/core/reference.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from .automata import DFA, ParserNFA, build_dfa, build_medfa, build_nfa
from .matrices import ParserMatrices, build_matrices
from .segments import SegmentTable, compute_segments
from .slpf import SLPF


@dataclass
class ParallelArtifacts:
    """All machines the parallel parser needs, generated once per RE (Sect. 4.1)."""

    table: SegmentTable
    matrices: ParserMatrices
    nfa: ParserNFA
    dfa: DFA
    medfa: DFA
    rnfa: ParserNFA
    rdfa: DFA
    rmedfa: DFA

    @classmethod
    def generate(cls, pattern_or_table, *, inf_limit: int = 2) -> "ParallelArtifacts":
        if isinstance(pattern_or_table, SegmentTable):
            table = pattern_or_table
        else:
            table = compute_segments(pattern_or_table, inf_limit=inf_limit)
        nfa = build_nfa(table)
        rnfa = nfa.reverse()
        return cls(
            table=table,
            matrices=build_matrices(table),
            nfa=nfa,
            dfa=build_dfa(nfa),
            medfa=build_medfa(nfa),
            rnfa=rnfa,
            rdfa=build_dfa(rnfa),
            rmedfa=build_medfa(rnfa),
        )


def split_chunks(classes: np.ndarray, c: int) -> List[np.ndarray]:
    """Split phase: ``c`` chunks, sizes as equal as possible (within ±1)."""
    n = len(classes)
    c = max(1, min(c, n)) if n else 1
    bounds = [round(i * n / c) for i in range(c + 1)]
    return [classes[bounds[i]: bounds[i + 1]] for i in range(c)]


def _medfa_state_of(medfa: DFA, j: int) -> int:
    """Entry state of the ME-DFA for segment j (singleton {j})."""
    return medfa.initial[j]


def reach_phase(medfa: DFA, chunk: Sequence[int], ell: int) -> List[frozenset]:
    """Eq. (6) for one chunk: R[j] = δ*_ME-DFA({j}, chunk) for every segment j."""
    out: List[frozenset] = []
    for j in range(ell):
        state: Optional[int] = _medfa_state_of(medfa, j)
        for ch in chunk:
            state = medfa.step(state, int(ch))
            if state is None:
                break
        out.append(medfa.states[state] if state is not None else frozenset())
    return out


def join_phase(R: List[List[frozenset]], start: frozenset) -> List[frozenset]:
    """Eq. (7): J_0 = start; J_i = ∪_{j ∈ J_{i-1}} R_i[j].  Returns J_0..J_c."""
    J = [frozenset(start)]
    for Ri in R:
        s: set = set()
        for j in J[-1]:
            s |= Ri[j]
        J.append(frozenset(s))
    return J


def _dfa_state_for(dfa: DFA, segset: frozenset, nfa: ParserNFA) -> Optional[int]:
    """The DFA state whose segment set equals ``segset``.

    By construction (Sect. 3.2, join discussion) every join column *is* a DFA
    state; sets never seen during powerset (e.g. ∅ on invalid texts) intern here.
    """
    if segset in dfa.index:
        return dfa.index[segset]
    if not segset:
        return None
    # Intern on demand: extend the DFA lazily (equivalent to powerset from this set).
    dfa.index[segset] = len(dfa.states)
    dfa.states.append(segset)
    dfa.delta.append({})
    dfa.final.append(bool(segset & nfa.final))
    return dfa.index[segset]


def _dfa_step_lazy(dfa: DFA, nfa: ParserNFA, sid: Optional[int], cls: int) -> Optional[int]:
    if sid is None:
        return None
    nxt = dfa.delta[sid].get(cls)
    if nxt is not None:
        return nxt
    targets: set = set()
    for q in dfa.states[sid]:
        targets.update(nfa.delta[q].get(cls, ()))
    if not targets:
        return None
    tid = _dfa_state_for(dfa, frozenset(targets), nfa)
    dfa.delta[sid][cls] = tid
    return tid


def build_phase(
    dfa: DFA, nfa: ParserNFA, entry: frozenset, chunk: Sequence[int], ell: int
) -> np.ndarray:
    """Eq. (8) for one chunk: DFA columns B[t] (t = 1..k) from entry set."""
    k = len(chunk)
    B = np.zeros((k, ell), dtype=bool)
    sid = _dfa_state_for(dfa, entry, nfa)
    for t, ch in enumerate(chunk):
        sid = _dfa_step_lazy(dfa, nfa, sid, int(ch))
        if sid is None:
            break  # remaining columns stay empty
        for q in dfa.states[sid]:
            B[t, q] = True
    return B


def parse_parallel_reference(
    art: ParallelArtifacts, text, c: int = 4, *, fused: bool = False
) -> SLPF:
    """The complete parallel algorithm (Fig. 13) with c chunks."""
    m = art.matrices
    classes = (
        m.classes_of_text(text) if isinstance(text, (bytes, str))
        else np.asarray(text, dtype=np.int32)
    )
    ell = art.table.n
    n = len(classes)
    if n == 0:
        col = (m.I & m.F)[None, :]
        return SLPF(table=art.table, columns=col, classes=classes)

    chunks = split_chunks(classes, c)
    c = len(chunks)

    # ---- reach (FW and BW; Eq. 6) -------------------------------------------
    R = [reach_phase(art.medfa, ch, ell) for ch in chunks]
    Rb = [reach_phase(art.rmedfa, ch[::-1], ell) for ch in chunks]

    # ---- join (FW and BW; Eq. 7) --------------------------------------------
    I_set = frozenset(np.flatnonzero(m.I).tolist())
    F_set = frozenset(np.flatnonzero(m.F).tolist())
    J = join_phase(R, I_set)                      # J[0..c]
    Jb_rev = join_phase(Rb[::-1], F_set)          # Ĵ[c+1], Ĵ[c], .., Ĵ[1]
    Jb = Jb_rev[::-1]                             # Ĵ[i] at index i-1 → reindex below
    # Jb list: index i (0..c) holds Ĵ_{i+1}; Ĵ_{c+1} = F_set at index c.

    if fused:
        M = _fused_build_merge(art, chunks, J, Jb, ell)
    else:
        # ---- build (FW and BW; Eq. 8) ---------------------------------------
        # 0-based chunk i ↔ paper chunk i+1: FW entry J_i = J[i]; BW entry
        # Ĵ_{(i+1)+1} = Ĵ_{i+2} = Jb[i+1]  (Jb[m] holds Ĵ_{m+1}).
        B = [build_phase(art.dfa, art.nfa, J[i], chunks[i], ell) for i in range(c)]
        Bb = [
            build_phase(art.rdfa, art.rnfa, Jb[i + 1], chunks[i][::-1], ell)[::-1]
            for i in range(c)
        ]
        # Bb[i][t] (0-based t) = paper B̂_{i+1,t}; the chunk-end backward column
        # is the entry itself: B̂_{i+1,k} = Ĵ_{i+2} = Jb[i+1].
        M = []
        for i in range(c):
            k = len(chunks[i])
            Mi = np.zeros((k, ell), dtype=bool)
            for t in range(k):
                fwd = B[i][t]
                if t == k - 1:
                    bwd = np.zeros(ell, dtype=bool)
                    for q in Jb[i + 1]:
                        bwd[q] = True
                else:
                    bwd = Bb[i][t + 1]
                Mi[t] = fwd & bwd
            M.append(Mi)

    # ---- compose (C_0 = J_0 ∩ Ĵ_1, then M columns) --------------------------
    C = np.zeros((n + 1, ell), dtype=bool)
    J0 = np.zeros(ell, dtype=bool)
    for q in J[0]:
        J0[q] = True
    Jb1 = np.zeros(ell, dtype=bool)
    for q in (Jb[0] if c >= 1 else F_set):
        Jb1[q] = True
    C[0] = J0 & Jb1
    r = 1
    for Mi in M:
        C[r : r + len(Mi)] = Mi
        r += len(Mi)
    return SLPF(table=art.table, columns=C, classes=classes)


def _fused_build_merge(art, chunks, J, Jb, ell) -> List[np.ndarray]:
    """Fig. 14: fused FW build + BW build&merge with a single M array per chunk."""
    M = []
    for i, chunk in enumerate(chunks):
        k = len(chunk)
        Mi = np.zeros((k, ell), dtype=bool)
        sid = _dfa_state_for(art.dfa, J[i], art.nfa)
        for t, ch in enumerate(chunk):
            sid = _dfa_step_lazy(art.dfa, art.nfa, sid, int(ch))
            if sid is None:
                break
            for q in art.dfa.states[sid]:
                Mi[t, q] = True
        # Backward: TMP = Ĵ_{i+2} (paper Ĵ_{i+1} for its 1-based chunk);
        # M[k] &= TMP; then walk down ANDing.
        tmp = np.zeros(ell, dtype=bool)
        for q in Jb[i + 1]:
            tmp[q] = True
        Mi[k - 1] &= tmp
        rsid = _dfa_state_for(art.rdfa, Jb[i + 1], art.rnfa)
        for t in range(k - 2, -1, -1):
            rsid = _dfa_step_lazy(art.rdfa, art.rnfa, rsid, int(chunk[t + 1]))
            if rsid is None:
                Mi[: t + 1] = False
                break
            tmp[:] = False
            for q in art.rdfa.states[rsid]:
                tmp[q] = True
            Mi[t] &= tmp
        M.append(Mi)
    return M


def recognize_parallel(art: ParallelArtifacts, text, c: int = 4) -> bool:
    """Mere parallel recognizer (Sect. 4.2): FW reach + join only."""
    m = art.matrices
    classes = (
        m.classes_of_text(text) if isinstance(text, (bytes, str))
        else np.asarray(text, dtype=np.int32)
    )
    if len(classes) == 0:
        return bool((m.I & m.F).any())
    chunks = split_chunks(classes, c)
    R = [reach_phase(art.medfa, ch, art.table.n) for ch in chunks]
    I_set = frozenset(np.flatnonzero(m.I).tolist())
    J = join_phase(R, I_set)
    F_set = frozenset(np.flatnonzero(m.F).tolist())
    return bool(J[-1] & F_set)
