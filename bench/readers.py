"""What the per-layer metric readers (``bench/metrics/<metric>.py``) share.

Each reader takes the ``harness.Run`` of a traced run and returns its number,
or None where the run holds nothing to read (no span of that name, no launch
of that kernel in the trace): the harness then leaves the metric out.
"""

from __future__ import annotations

from typing import Optional

from . import counts


def span_mean_ms(run, name: str) -> Optional[float]:
    """The mean duration of the program's spans of ``name`` in the window."""
    d = [s["duration_s"] for s in run.spans if s["name"] == name]
    return 1e3 * sum(d) / len(d) if d else None


def share(least_s: float, spent_s: float) -> Optional[float]:
    """``least_s`` as a percentage of ``spent_s``; None where either is nothing."""
    if least_s <= 0 or spent_s <= 0:
        return None
    return 100.0 * least_s / spent_s


def kernel_s(run, kernel: str) -> float:
    return run.trace.kernel_seconds(counts.KERNEL_PREFIX[kernel]) if run.trace else 0.0


def scan_least_s(run, kernel: str) -> float:
    """The least time of ``kernel``'s work over every parse of the window."""
    t = run.tables
    total = 0.0
    for _, n, (C, k) in run.parses:
        if kernel == "k1":
            c = counts.k1(C, k, t["lp"], t["n_tables"], n, t["ell"])
        elif kernel == "k2":
            c = counts.k2(C, k, t["lp"], t["n_tables"], n, t["ell"])
        else:
            c = counts.join(C, t["lp"], t["ell"])
        total += counts.seconds(*c)
    return total


def tail_k1_least_s(run) -> float:
    """The least time of the window's batched piece reaches, one launch a step."""
    t = run.tables
    return sum(counts.seconds(*counts.k1(counts.next_pow2(p), t["k"], t["lp"], t["n_tables"], chars, t["ell"]))
               for _, p, chars in run.steps if p)


def idle_pct(run) -> Optional[float]:
    if not run.trace or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
