"""The benchmark's one generator: texts of a configuration's grammar, and arrivals.

Every text and every schedule comes from ``--seed`` through a
``numpy.random.Generator`` (Philox), one stream a purpose, so a seed gives the
same bytes and times in every run.  A configuration's file names its grammar
and that grammar's fields under ``"text"``; the grammar is the module of that
name in ``bench/grammars/`` (``make(n_bytes, rng, spec)``), so a configuration
with a grammar of its own adds a file there.  Every text a grammar makes is a
valid text of its configuration's pattern, and so is any concatenation of
them, which is what a stream's session receives.
"""

from __future__ import annotations

import importlib
from typing import List

import numpy as np


def rng(seed: int, purpose: int) -> np.random.Generator:
    """The generator of one purpose (texts, pool, schedule, sample) of a seed;
    any whole number is a seed."""
    return np.random.Generator(np.random.Philox(np.random.SeedSequence([seed % (1 << 64), purpose])))


def texts(spec: dict, n_bytes: int, count: int, seed: int, purpose: int) -> List[bytes]:
    """``count`` texts of ``n_bytes`` each of the grammar ``spec`` names."""
    make = importlib.import_module(f"bench.grammars.{spec['grammar']}").make
    r = rng(seed, purpose)
    return [make(n_bytes, r, spec) for _ in range(count)]


def poisson_schedule(rate: float, seconds: float, sessions: int, pool: int, seed: int,
                     shape_seed: int):
    """Open-loop arrivals: the due times (s from the window's start), the
    session and the pool piece of each.

    The gaps are the quantiles of the exponential law of ``rate`` at
    (i + ½) / N, N = round(rate · seconds), and every session gets N / sessions
    arrivals (±1); their order comes from ``shape_seed``, the mix's, so every
    ``seed`` offers the same arrivals to sessions that it relabels, and the
    pieces they carry are drawn from ``seed``.  The whole is a Poisson stream
    of ``rate``; what a seed changes is which source sends what, not how much
    work arrives when.
    """
    shape = rng(shape_seed, 3)
    n = max(1, int(round(rate * seconds)))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    due = np.cumsum(shape.permutation(gaps))
    who = shape.permutation(np.resize(np.arange(sessions), n))
    r = rng(seed, 3)
    who = r.permutation(sessions)[who]
    piece = r.integers(0, pool, size=n)
    return due, who, piece


def sessions_checked(seed: int, sessions: int, count: int) -> List[int]:
    """The sessions whose whole forest a tail run compares, drawn from the seed."""
    return sorted(int(s) for s in rng(seed, 4).choice(sessions, size=min(count, sessions), replace=False))
