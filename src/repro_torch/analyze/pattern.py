"""Static RE/automaton diagnostics: everything knowable before any text.

The port's copy of ``repro/analyze/pattern.py``: host-side numpy over the
transition matrices, no device.  Four legs, one typed ``AnalysisReport``:

  feasible widths   ``feasible_width_bounds``: for each prefix depth d, the
                    most start states a chunk whose first d characters are
                    real can be feasible from (the quantity
                    ``core/matrices.py::feasible_start_widths`` observes per
                    chunk), by a frontier fixpoint over backward set images;
                    ``width_bucket`` replays ``SparseBackend.bind_shape`` on
                    the depth-1 bound: the S the sparse backend carries.
  ambiguity         ``pathological`` (an iterator with a nullable body:
                    unboundedly many trees per text), else the position
                    NFA's self-product decides ``unambiguous`` vs
                    ``finite`` (budgeted; over budget it says ``finite``).
  density           per-class, union and saturated product densities.
  cost model        per-backend, per-character roofline terms from the
                    backends' closed-form op and byte counts against the
                    card's constants (``analyze/roofline.py``);
                    ``recommended_backend`` is the argmin over {sparse
                    (only where its width bucket reduces), packed, torch}.

The report names the dense family ``torch`` (the reference's ``jnp``).
``resolve_backend`` turns a choice into what runs on a device: on the card
dense runs as ``cuda`` and packed / sparse with ``kernel=True`` (their
kernel-free word loop is the slow path there), on the CPU as named.  Every
candidate parses bit-identically, so the choice is performance only.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .roofline import HBM_BW, PEAK_FLOPS

#: Modeled uint32 word-op rate of the word backends (packed / sparse): an
#: OR-AND fold is bitwise integer work on the CUDA cores, which an H100 SXM
#: issues at 64 results a clock on each of its 132 SMs (the CUDA C
#: programming guide's throughput table, compute capability 9.0: 32-bit
#: AND, OR, XOR), at its 1.98 GHz maximum SM clock.
WORD_OPS = 132 * 64 * 1.98e9

#: ``core/backend.py`` lane alignments (``min_lane_pad``), mirrored here so
#: the analyzer imports no torch (held to the backends in
#: tests/test_torch_analyze.py).
_MIN_LANE_PAD = {"torch": 32, "cuda": 32, "packed": 32, "sparse": 32}

#: ``SparseBackend``'s default width-bucket floor (core/backend.py).
_SPARSE_MIN_WIDTH = 8

#: Frontier cap of the per-depth width fixpoint: deeper refinement stops once
#: the set of distinct feasible sets exceeds this (the previous depth's bound
#: is carried — sound by monotonicity).
_WIDTH_FRONTIER_CAP = 512

#: Pair-search budget of the exact ambiguity test (visited product states).
_AMBIG_PAIR_BUDGET = 1 << 16


def _next_pow2(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


def _lane_pad(ell: int, lane: int) -> int:
    return max(lane, ((ell + lane - 1) // lane) * lane)


# ---------------------------------------------------------- feasible widths


def feasible_width_bounds(
    N: np.ndarray, depth: int, cap: int = _WIDTH_FRONTIER_CAP
) -> Tuple[List[int], bool]:
    """Per-depth static feasible-start width bounds of one automaton.

    ``bounds[d-1]`` = max over all length-d REAL-class sequences of the
    feasible start-set size |{s : the sequence is readable from s}| — the
    static ceiling on what ``feasible_start_widths`` observes for any chunk
    whose first d characters are real.  (A chunk with r < d real leading
    characters is bounded by ``bounds[r-1]``: trailing PADs are identity, so
    its feasible set IS a depth-r set.  ``bounds[0]`` bounds every chunk.)

    Computed as a frontier fixpoint: the depth-d feasible sets are exactly
    the backward images ``pre_a(S)`` of the depth-(d-1) sets.  Feasible sets
    shrink with depth (each length-d set is contained in its length-(d-1)
    prefix's set), so the per-depth max is non-increasing — when the
    deduplicated frontier outgrows ``cap``, refinement stops and the previous
    bound carries forward, keeping the result sound.  Returns
    ``(bounds, exact)``; ``exact`` is False once a carry happened.
    """
    N = np.asarray(N) > 0
    real = N[:-1]                       # PAD (last class index) excluded
    A = real.shape[0]
    L = real.shape[-1]
    if A == 0 or depth < 1:
        return [L] * max(depth, 0), True
    frontier = {np.ones(L, dtype=bool).tobytes()}
    bounds: List[int] = []
    exact = True
    for _ in range(depth):
        new: Dict[bytes, int] = {}
        for key in frontier:
            S = np.frombuffer(key, dtype=bool)
            for a in range(A):
                # pre_a(S) = {j : ∃ i ∈ S with N[a][i, j]} — the same
                # backward step feasible_start_widths folds per chunk
                T = real[a][S].any(axis=0)
                new.setdefault(T.tobytes(), int(T.sum()))
        bound = max(new.values()) if new else 0
        if bounds and bound > bounds[-1]:   # numeric safety; monotone by math
            bound = bounds[-1]
        bounds.append(bound)
        if len(new) > cap:
            exact = False
            bounds.extend([bound] * (depth - len(bounds)))
            break
        frontier = set(new)
    return bounds, exact


def sparse_width_bucket(
    raw_width: int, ell_pad: int, min_width: int = _SPARSE_MIN_WIDTH
) -> int:
    """``SparseBackend.bind_shape``'s static product-row count S, replayed
    host-side: pow2 bucket of the depth-1 bound (floor ``min_width``), dense
    fallback S = ℓp once the bucket reaches ℓp."""
    S = _next_pow2(max(min_width, int(raw_width), 1))
    return ell_pad if S >= ell_pad else S


# ---------------------------------------------------------------- ambiguity


def _product_closure(
    delta: List[Dict[int, Tuple[int, ...]]],
    seeds,
    alive: np.ndarray,
    budget: int,
):
    """Reachable pair set of the NFA self-product from ``seeds`` (pairs are
    stored with p <= q; the product is symmetric).  Returns (pairs, complete):
    ``complete`` False when the budget stopped the search."""
    seen = set()
    stack = []
    for p, q in seeds:
        if not (alive[p] and alive[q]):
            continue
        pair = (p, q) if p <= q else (q, p)
        if pair not in seen:
            seen.add(pair)
            stack.append(pair)
    while stack:
        if len(seen) > budget:
            return seen, False
        p, q = stack.pop()
        dp, dq = delta[p], delta[q]
        for cls, ps in dp.items():
            qs = dq.get(cls)
            if qs is None:
                continue
            for np_ in ps:
                if not alive[np_]:
                    continue
                for nq in qs:
                    if not alive[nq]:
                        continue
                    pair = (np_, nq) if np_ <= nq else (nq, np_)
                    if pair not in seen:
                        seen.add(pair)
                        stack.append(pair)
    return seen, True


def nfa_ambiguous(nfa, budget: int = _AMBIG_PAIR_BUDGET) -> Tuple[bool, bool]:
    """(ambiguous, exact) — does some word have two distinct accepting runs?

    Standard self-product criterion on the trimmed automaton: ambiguous iff
    an off-diagonal pair is reachable from the initial pairs AND co-reachable
    to the final pairs.  Budgeted: an overflowing pair search returns
    ``(True, False)`` — conservatively ambiguous, never falsely unambiguous.
    """
    # trim to useful states: forward-reachable ∧ co-reachable
    fwd = np.zeros(nfa.n_states, dtype=bool)
    stack = list(nfa.initial)
    for s in stack:
        fwd[s] = True
    while stack:
        s = stack.pop()
        for targets in nfa.delta[s].values():
            for t in targets:
                if not fwd[t]:
                    fwd[t] = True
                    stack.append(t)
    rev = nfa.reverse()
    bwd = np.zeros(nfa.n_states, dtype=bool)
    stack = list(rev.initial)
    for s in stack:
        bwd[s] = True
    while stack:
        s = stack.pop()
        for targets in rev.delta[s].values():
            for t in targets:
                if not bwd[t]:
                    bwd[t] = True
                    stack.append(t)
    alive = fwd & bwd

    starts = [s for s in nfa.initial if alive[s]]
    finals = [s for s in nfa.final if alive[s]]
    reach, r_ok = _product_closure(
        nfa.delta, ((p, q) for p in starts for q in starts), alive, budget
    )
    coreach, c_ok = _product_closure(
        rev.delta, ((p, q) for p in finals for q in finals), alive, budget
    )
    if not (r_ok and c_ok):
        return True, False
    both = reach & coreach
    return any(p != q for p, q in both), True


# ------------------------------------------------------------------ density


def density_profile(N: np.ndarray, max_iters: int = 8) -> Dict[str, float]:
    """Chunk-product fill model: per-class / union / saturated densities.

    ``saturation`` is the density of the transitive closure of the all-class
    union — the worst-case nnz fraction any chunk product ``N[y_k] ⊗ … ⊗
    N[y_1]`` can reach, however long the chunk (products only combine the
    per-class supports).  Iterated boolean squaring converges in ≤ log₂(ℓ)
    steps; ``max_iters`` caps the host work on degenerate automata.
    """
    N = np.asarray(N) > 0
    real = N[:-1]
    L = real.shape[-1]
    if real.shape[0] == 0 or L == 0:
        return {"class_mean": 0.0, "class_max": 0.0, "union": 0.0,
                "saturation": 0.0}
    per_class = real.reshape(real.shape[0], -1).mean(axis=1)
    union = real.any(axis=0)
    sat = union
    for _ in range(max_iters):
        f = sat.astype(np.float32)
        grown = sat | ((f @ f) > 0)
        if (grown == sat).all():
            break
        sat = grown
    return {
        "class_mean": float(per_class.mean()),
        "class_max": float(per_class.max()),
        "union": float(union.mean()),
        "saturation": float(sat.mean()),
    }


# --------------------------------------------------------------- cost model


def backend_cost_model(ell: int, width_bucket_32: int) -> Dict[str, Dict[str, float]]:
    """Per-character roofline terms of every registered backend, closed form.

    Op/byte counts per reach step (the dominant phase), the reference's:
    dense (``torch``, ``cuda``) 2ℓp³ flops over 3 ℓp² f32 arrays; packed
    ℓp²·W word ops over ~3 ℓp·W words; sparse S·ℓp·W word ops over S·(1+W)
    product words + the ℓp·W table row.  Dense flops rate ``PEAK_FLOPS``;
    word ops ``WORD_OPS``; bytes ``HBM_BW``.  ``t_total`` = max(compute,
    memory), the roofline time the auto-selection minimizes.
    """
    out: Dict[str, Dict[str, float]] = {}
    for name in ("torch", "cuda", "packed", "sparse"):
        lp = _lane_pad(ell, _MIN_LANE_PAD[name])
        W = lp // 32
        if name in ("torch", "cuda"):
            ops = 2.0 * lp**3
            bytes_ = 3.0 * 4.0 * lp**2
            t_compute = ops / PEAK_FLOPS
        elif name == "packed":
            ops = float(lp * lp * W)
            bytes_ = 3.0 * 4.0 * lp * W
            t_compute = ops / WORD_OPS
        else:  # sparse: S product rows instead of ℓp (dense fallback S = ℓp)
            S = sparse_width_bucket(width_bucket_32, lp) if lp == _lane_pad(
                ell, 32
            ) else lp
            S = min(S, lp)
            ops = float(S * lp * W)
            bytes_ = 4.0 * (2.0 * S * (1 + W) + lp * W)
            t_compute = ops / WORD_OPS
        t_memory = bytes_ / HBM_BW
        out[name] = {
            "ops_per_char": ops,
            "bytes_per_char": bytes_,
            "t_compute": t_compute,
            "t_memory": t_memory,
            "t_total": max(t_compute, t_memory),
            "bottleneck": "compute" if t_compute >= t_memory else "memory",
        }
    return out


#: auto-selection candidates, in tie-break order (most reduced first);
#: ``cuda`` is how the dense family runs on the card (``resolve_backend``),
#: never a candidate of its own.
_AUTO_CANDIDATES = ("sparse", "packed", "torch")


def choose_backend(cost: Dict[str, Dict[str, float]], reduced: bool) -> str:
    """Static backend choice: modeled-roofline argmin over the candidates.

    ``sparse`` competes only when ``reduced`` (its width bucket is strictly
    below ℓp — otherwise it IS dense packed with gather overhead).
    """
    candidates = [
        b for b in _AUTO_CANDIDATES if b != "sparse" or reduced
    ]
    return min(
        candidates,
        key=lambda b: (cost[b]["t_total"], _AUTO_CANDIDATES.index(b)),
    )


# ------------------------------------------------------------------- report


@dataclasses.dataclass
class AnalysisReport:
    """Typed static-analysis result: ``Parser.stats()["analysis"]``.

    Every field is computed on the host from the pattern and matrices alone;
    ``to_dict()`` is the JSON-able schema.
    """

    pattern: Optional[str]        # None when only matrices were available
    ell: int                      # true segment count
    ell_pad: int                  # 32-lane padded ℓp (dense/packed/sparse)
    n_classes: int                # real char classes (PAD excluded)
    nullable: bool                # pattern accepts the empty text
    ambiguity: str                # "unambiguous" | "finite" | "pathological"
    ambiguity_exact: bool         # False: budgeted search degraded the verdict
    width_bounds: Tuple[int, ...]  # per-depth feasible-start bounds (d=1..D)
    width_exact: bool             # False: frontier cap carried a bound
    width_bucket: int             # sparse S: pow2 bucket of width_bounds[0]
    density: Dict[str, float]
    cost: Dict[str, Dict[str, float]]
    recommended_backend: str
    verdict: str                  # "ok" | "pathological"

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["width_bounds"] = list(self.width_bounds)
        return d


def analyze_matrices(
    matrices,
    *,
    pattern: Optional[str] = None,
    depth: int = 4,
) -> AnalysisReport:
    """Analyze one automaton (``ParserMatrices``), optionally with its RE.

    ``pattern`` feeds the AST legs (nullability, the pathological-iterator
    check); without it those default to the matrices-only safe answers.
    ``depth`` is how many feasible-width bounds to compute (≥ the configured
    ``feasible_depth`` when driven by the facade).
    """
    from ..core.automata import build_nfa
    from ..core.regex import infinitely_ambiguous, nullable as re_nullable, parse_regex

    N = np.asarray(matrices.N)
    ell = matrices.n_segments
    n_real_classes = N.shape[0] - 1
    ell_pad = _lane_pad(ell, 32)

    ast = None
    if pattern is not None:
        try:
            ast = parse_regex(pattern)
        except Exception:
            ast = None
    is_nullable = re_nullable(ast) if ast is not None else bool(
        float(np.dot(matrices.I, matrices.F)) > 0
    )
    pathological = infinitely_ambiguous(ast) if ast is not None else False

    if pathological:
        ambiguity, exact = "pathological", True
    else:
        ambiguous, exact = nfa_ambiguous(build_nfa(matrices.table))
        ambiguity = "finite" if ambiguous else "unambiguous"

    depth = max(1, int(depth))
    bounds, width_exact = feasible_width_bounds(N, depth)
    bucket = sparse_width_bucket(bounds[0], ell_pad)
    cost = backend_cost_model(ell, bounds[0])
    recommended = choose_backend(cost, reduced=bucket < ell_pad)

    return AnalysisReport(
        pattern=pattern,
        ell=ell,
        ell_pad=ell_pad,
        n_classes=n_real_classes,
        nullable=bool(is_nullable),
        ambiguity=ambiguity,
        ambiguity_exact=exact,
        width_bounds=tuple(int(b) for b in bounds),
        width_exact=width_exact,
        width_bucket=int(bucket),
        density=density_profile(N),
        cost=cost,
        recommended_backend=recommended,
        verdict="pathological" if ambiguity == "pathological" else "ok",
    )


def analyze_pattern(pattern: str, *, depth: int = 4) -> AnalysisReport:
    """Analyze an RE string: build its matrices, then ``analyze_matrices``."""
    from ..core.matrices import build_matrices
    from ..core.segments import compute_segments

    return analyze_matrices(
        build_matrices(compute_segments(pattern)), pattern=pattern, depth=depth
    )


@lru_cache(maxsize=256)
def cached_report(pattern: str, depth: int = 4) -> AnalysisReport:
    """Pattern-keyed memoized report for repeat callers (fleet admission,
    ``backend="auto"`` resolution).  Treat the result as read-only — it is
    shared across callers."""
    return analyze_pattern(pattern, depth=depth)


def resolve_auto_backend(pattern: str, depth: int = 1) -> str:
    """``backend="auto"`` resolution for pattern-keyed callers (the fleet):
    the report's ``recommended_backend``, memoized per (pattern, depth)."""
    return cached_report(pattern, max(4, depth)).recommended_backend


def resolve_backend(choice: str, device_type: str) -> Tuple[str, bool]:
    """(backend, kernel) that runs the analyzer's ``choice`` on a device
    type: on the card dense runs as ``cuda`` and packed / sparse through
    their kernels (their kernel-free word loop is the card's slow path,
    ROADMAP Queue 2 item 2.2); on the CPU each runs as named, kernel-free."""
    if choice not in _AUTO_CANDIDATES:
        raise ValueError(f"not an auto choice: {choice!r}; known: {list(_AUTO_CANDIDATES)}")
    if device_type == "cuda":
        return ("cuda", False) if choice == "torch" else (choice, True)
    return choice, False
