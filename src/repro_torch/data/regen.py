"""REgen-style random RE and valid-text generation (paper Sect. 5.1, ref. 20):
the port of ``repro.data.regen``, over the port's ``core.regex`` nodes.  The
same draws from the same ``numpy`` generator give the same patterns and the
same strings as the reference, bit for bit.

Used by the REGEN benchmark (segment-count scatter, Fig. 20 analogue; speed-up
sweeps) and by the RegexStructured pipeline.  Two functions:

  * ``random_regex(size, rng)``  — a random RE AST of ~``size`` symbols drawn
    from concatenation / union / star / cross / optional over a small terminal
    alphabet (the distribution mirrors REgen's: leaf-heavy, shallow operators);
  * ``sample_string(ast, rng)``  — a random valid string of the RE (uniform
    local choices; iterators sample geometric repeat counts).
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..core import regex as rx

_ALPHABET = [ord(c) for c in "abcdxyz01"]


def random_regex(size: int, rng: np.random.Generator) -> rx.Node:
    """Random RE AST with roughly ``size`` symbols (terminals + operators)."""

    def gen(budget: int) -> rx.Node:
        if budget <= 1:
            return rx.Lit(int(rng.choice(_ALPHABET)))
        r = rng.random()
        if r < 0.40:  # concatenation
            k = int(rng.integers(2, min(4, budget) + 1))
            parts = _split_budget(budget - 1, k, rng)
            return rx.Cat(tuple(gen(b) for b in parts))
        if r < 0.70:  # union
            k = int(rng.integers(2, min(3, budget) + 1))
            parts = _split_budget(budget - 1, k, rng)
            return rx.Alt(tuple(gen(b) for b in parts))
        if r < 0.80:
            return rx.Star(_non_nullable(gen(budget - 1), rng))
        if r < 0.90:
            return rx.Plus(_non_nullable(gen(budget - 1), rng))
        if r < 0.95:
            return rx.Opt(_non_nullable(gen(budget - 1), rng))
        return rx.Group(gen(budget - 1))

    return gen(max(1, size))


def _non_nullable(node: rx.Node, rng: np.random.Generator) -> rx.Node:
    """Avoid infinitely-ambiguous REs (iterator over nullable body)."""
    if rx.nullable(node):
        return rx.Cat((rx.Lit(int(rng.choice(_ALPHABET))), node))
    return node


def _split_budget(budget: int, k: int, rng: np.random.Generator) -> List[int]:
    cuts = sorted(rng.integers(1, max(budget, 2), size=k - 1).tolist())
    parts = []
    prev = 0
    for c in cuts + [budget]:
        parts.append(max(1, c - prev))
        prev = c
    return parts


def sample_string(node: rx.Node, rng: np.random.Generator, max_rep: int = 4) -> bytes:
    if isinstance(node, rx.Lit):
        return bytes([node.char])
    if isinstance(node, rx.CharClass):
        members = [c for lo, hi in node.ranges for c in range(lo, min(hi, 255) + 1)]
        return bytes([int(rng.choice(members))])
    if isinstance(node, rx.Eps):
        return b""
    if isinstance(node, rx.Cat):
        return b"".join(sample_string(i, rng, max_rep) for i in node.items)
    if isinstance(node, rx.Alt):
        return sample_string(node.items[int(rng.integers(len(node.items)))], rng, max_rep)
    if isinstance(node, rx.Star):
        n = int(rng.integers(0, max_rep + 1))
        return b"".join(sample_string(node.item, rng, max_rep) for _ in range(n))
    if isinstance(node, rx.Plus):
        n = int(rng.integers(1, max_rep + 1))
        return b"".join(sample_string(node.item, rng, max_rep) for _ in range(n))
    if isinstance(node, rx.Opt):
        return sample_string(node.item, rng, max_rep) if rng.random() < 0.5 else b""
    if isinstance(node, rx.Repeat):
        hi = node.hi if node.hi is not None else node.lo + max_rep
        n = int(rng.integers(node.lo, hi + 1))
        return b"".join(sample_string(node.item, rng, max_rep) for _ in range(n))
    if isinstance(node, rx.Group):
        return sample_string(node.item, rng, max_rep)
    raise TypeError(node)
