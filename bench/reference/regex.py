"""Regular-expression abstract syntax and a POSIX-ish string parser.

Supported syntax (paper Sect. 2.1 + App. A):
  - terminals: any byte; ``\\x`` escapes force terminal-hood of metacharacters
  - ``.`` wildcard (any byte except newline)
  - ``[...]`` / ``[^...]`` character sets with ranges (``a-z``)
  - concatenation (juxtaposition), union ``|``
  - iterators ``*`` (star), ``+`` (cross), ``?`` (optional)
  - bounded repetition ``{h}``, ``{h,k}``, ``{h,}``
  - grouping parentheses ``( )`` — *extra parentheses* in the paper's sense: they are
    numbered and appear in the LSTs, enabling group-match extraction (App. A).
  - ``()`` or a bare reference to the empty string via ``\\e`` produce an Eps leaf.

The AST is deliberately tiny; everything downstream (numbering, segments, automata)
consumes it.  ``Alt``/``Cat`` are n-ary, matching the paper's n-ary union/concatenation.

Frozen copy of ``repro_torch/core/regex.py`` for the benchmark's reference: the
reference builds its automaton from the pattern with this code, never with the
program's, so that a later change to the program's front-end cannot move the
yardstick.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple


class RegexSyntaxError(ValueError):
    pass


# --------------------------------------------------------------------------- AST


@dataclass(frozen=True)
class Node:
    pass


@dataclass(frozen=True)
class Lit(Node):
    """A single terminal character (stored as an int byte / code point)."""

    char: int

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Lit({chr(self.char)!r})"


@dataclass(frozen=True)
class CharClass(Node):
    """A set of terminals: sorted tuple of inclusive (lo, hi) ranges.

    ``negated`` is resolved at construction time against the byte alphabet, so the
    stored ranges are always the *positive* member set.
    """

    ranges: Tuple[Tuple[int, int], ...]

    def members(self, alphabet_size: int = 256):
        for lo, hi in self.ranges:
            for c in range(lo, min(hi, alphabet_size - 1) + 1):
                yield c

    def contains(self, c: int) -> bool:
        return any(lo <= c <= hi for lo, hi in self.ranges)


@dataclass(frozen=True)
class Eps(Node):
    """The empty-string leaf (explicit epsilon in the RE, App. A)."""


@dataclass(frozen=True)
class Cat(Node):
    items: Tuple[Node, ...]


@dataclass(frozen=True)
class Alt(Node):
    items: Tuple[Node, ...]


@dataclass(frozen=True)
class Star(Node):
    item: Node


@dataclass(frozen=True)
class Plus(Node):
    item: Node


@dataclass(frozen=True)
class Opt(Node):
    item: Node


@dataclass(frozen=True)
class Repeat(Node):
    """Bounded repetition e{lo,hi}; hi=None means unbounded (e{lo,})."""

    item: Node
    lo: int
    hi: int | None


@dataclass(frozen=True)
class Group(Node):
    """An explicit user parenthesis pair — an *extra parenthesis* (App. A).

    It owns a paren number of its own so matches of the group can be extracted
    from the SLPF (``getMatches``).
    """

    item: Node


WILDCARD_RANGES: Tuple[Tuple[int, int], ...] = ((0, 9), (11, 255))  # '.' = not \n


def char_class(ranges, negated: bool = False, alphabet_size: int = 256) -> CharClass:
    """Normalize ranges (merge overlaps); resolve negation against the byte space."""
    rs = sorted((int(lo), int(hi)) for lo, hi in ranges)
    merged: list[list[int]] = []
    for lo, hi in rs:
        if merged and lo <= merged[-1][1] + 1:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    if negated:
        out, prev = [], 0
        for lo, hi in merged:
            if lo > prev:
                out.append((prev, lo - 1))
            prev = max(prev, hi + 1)
        if prev <= alphabet_size - 1:
            out.append((prev, alphabet_size - 1))
        merged = [list(t) for t in out]
    return CharClass(tuple((lo, hi) for lo, hi in merged))


# ------------------------------------------------------------------ string parser


_SPECIAL = set("()[]{}|*+?.\\")


class _Parser:
    def __init__(self, src: str):
        self.src = src
        self.pos = 0

    def error(self, msg: str) -> RegexSyntaxError:
        return RegexSyntaxError(f"{msg} at position {self.pos} in {self.src!r}")

    def peek(self) -> str | None:
        return self.src[self.pos] if self.pos < len(self.src) else None

    def next(self) -> str:
        c = self.src[self.pos]
        self.pos += 1
        return c

    # alternation := concat ('|' concat)*
    def parse_alt(self) -> Node:
        items = [self.parse_cat()]
        while self.peek() == "|":
            self.next()
            items.append(self.parse_cat())
        if len(items) == 1:
            return items[0]
        return Alt(tuple(items))

    # concat := repeat*
    def parse_cat(self) -> Node:
        items = []
        while True:
            c = self.peek()
            if c is None or c in "|)":
                break
            items.append(self.parse_repeat())
        if not items:
            return Eps()
        if len(items) == 1:
            return items[0]
        return Cat(tuple(items))

    # repeat := atom ('*' | '+' | '?' | '{h}' | '{h,}' | '{h,k}')*
    def parse_repeat(self) -> Node:
        node = self.parse_atom()
        while True:
            c = self.peek()
            if c == "*":
                self.next()
                node = Star(node)
            elif c == "+":
                self.next()
                node = Plus(node)
            elif c == "?":
                self.next()
                node = Opt(node)
            elif c == "{":
                self.next()
                node = self._parse_bound(node)
            else:
                return node

    def _parse_bound(self, node: Node) -> Node:
        start = self.pos
        digits = ""
        while self.peek() is not None and self.peek().isdigit():
            digits += self.next()
        if not digits:
            raise self.error("expected digit in bounded repetition")
        lo = int(digits)
        hi: int | None = lo
        if self.peek() == ",":
            self.next()
            digits = ""
            while self.peek() is not None and self.peek().isdigit():
                digits += self.next()
            hi = int(digits) if digits else None
        if self.peek() != "}":
            self.pos = start
            raise self.error("unterminated bounded repetition")
        self.next()
        if hi is not None and hi < lo:
            raise self.error(f"bad repetition bounds {{{lo},{hi}}}")
        return Repeat(node, lo, hi)

    def parse_atom(self) -> Node:
        c = self.peek()
        if c is None:
            raise self.error("unexpected end of pattern")
        if c == "(":
            self.next()
            inner = self.parse_alt()
            if self.peek() != ")":
                raise self.error("unbalanced parenthesis")
            self.next()
            return Group(inner)
        if c == "[":
            return self._parse_class()
        if c == ".":
            self.next()
            return CharClass(WILDCARD_RANGES)
        if c == "\\":
            self.next()
            e = self.peek()
            if e is None:
                raise self.error("dangling escape")
            self.next()
            table = {"n": 10, "t": 9, "r": 13, "0": 0, "e": None}
            if e == "e":
                return Eps()
            if e in table:
                return Lit(table[e])
            if e == "d":
                return char_class([(48, 57)])
            if e == "w":
                return char_class([(48, 57), (65, 90), (97, 122), (95, 95)])
            if e == "s":
                return char_class([(9, 13), (32, 32)])
            return Lit(ord(e))
        if c in "|)*+?{}":
            raise self.error(f"unexpected metacharacter {c!r}")
        self.next()
        return Lit(ord(c))

    def _parse_class(self) -> Node:
        assert self.next() == "["
        negated = False
        if self.peek() == "^":
            negated = True
            self.next()
        ranges: list[tuple[int, int]] = []
        first = True
        while True:
            c = self.peek()
            if c is None:
                raise self.error("unterminated character class")
            if c == "]" and not first:
                self.next()
                break
            first = False
            lo = self._class_char()
            if self.peek() == "-" and self.pos + 1 < len(self.src) and self.src[self.pos + 1] != "]":
                self.next()
                hi = self._class_char()
                if hi < lo:
                    raise self.error("reversed range in character class")
                ranges.append((lo, hi))
            else:
                ranges.append((lo, lo))
        if not ranges:
            raise self.error("empty character class")
        return char_class(ranges, negated=negated)

    def _class_char(self) -> int:
        c = self.next()
        if c == "\\":
            e = self.next()
            table = {"n": 10, "t": 9, "r": 13, "0": 0}
            return table.get(e, ord(e))
        return ord(c)


def parse_regex(pattern: str) -> Node:
    """Parse an RE string into the AST."""
    p = _Parser(pattern)
    node = p.parse_alt()
    if p.pos != len(pattern):
        raise p.error("trailing input")
    return node


# ------------------------------------------------------------------- utilities


def nullable(node: Node) -> bool:
    """Does the RE generate the empty string?"""
    if isinstance(node, (Eps,)):
        return True
    if isinstance(node, (Lit, CharClass)):
        return False
    if isinstance(node, Cat):
        return all(nullable(i) for i in node.items)
    if isinstance(node, Alt):
        return any(nullable(i) for i in node.items)
    if isinstance(node, (Star, Opt)):
        return True
    if isinstance(node, Plus):
        return nullable(node.item)
    if isinstance(node, Repeat):
        return node.lo == 0 or nullable(node.item)
    if isinstance(node, Group):
        return nullable(node.item)
    raise TypeError(node)


def infinitely_ambiguous(node: Node) -> bool:
    """True iff some iterator (star/cross/unbounded repeat) has a nullable body.

    This is exactly the paper's characterization (footnote 3): infinite ambiguity
    stems from an iterator with a nullable argument.
    """
    if isinstance(node, (Lit, CharClass, Eps)):
        return False
    if isinstance(node, (Cat, Alt)):
        return any(infinitely_ambiguous(i) for i in node.items)
    if isinstance(node, (Star, Plus)):
        return nullable(node.item) or infinitely_ambiguous(node.item)
    if isinstance(node, Repeat):
        if node.hi is None and nullable(node.item):
            return True
        return infinitely_ambiguous(node.item)
    if isinstance(node, (Opt, Group)):
        return infinitely_ambiguous(node.item)
    raise TypeError(node)


def node_size(node: Node) -> int:
    """Paper's ||e||: count of terminals and operators (metasymbols).

    Each leaf counts 1; each operator node counts 1 (n-ary operators count once,
    matching Ex. 5 where a ternary concatenation is a single numbered operator).
    Groups (extra parens) count 1 as they are numbered.  Bounded repetition
    counts its copy-expanded body (Ex. 5: the symbols "repeated k times with
    progressive numbering" each count).
    """
    if isinstance(node, (Lit, CharClass, Eps)):
        return 1
    if isinstance(node, (Cat, Alt)):
        return 1 + sum(node_size(i) for i in node.items)
    if isinstance(node, Repeat):
        copies = node.hi if node.hi is not None else node.lo + 1
        return 1 + max(copies, 1) * node_size(node.item)
    if isinstance(node, (Star, Plus, Opt, Group)):
        return 1 + node_size(node.item)
    raise TypeError(node)
