"""Numbered REs and the *linear LST-RE* transform (paper Sect. 2.2, App. A).

The numbered RE ``e#`` distinctly numbers every terminal / epsilon occurrence and
surrounds every operator's scope with a distinctly-numbered parenthesis pair.  By
Prop. 1 the language generated by ``e# ⊣`` over the numbered alphabet is exactly the
set of linearized syntax trees (LSTs) of ``e``.

We realize ``e#`` as an ordinary *linear* RE (every symbol occurs exactly once) over a
symbol table, then run the classic Glushkov (GMY) construction on it to obtain the
``first`` set and ``Fol`` relation (Eq. 2) used by the segment computation.

Additional features handled here, per App. A:
  * character sets / wildcards → **generalized segments** via a partition of the byte
    alphabet into equivalence classes (Fig. A1);
  * bounded repetition ``{h,k}`` → copy expansion with progressive numbering (Ex. 5);
    optional copies are right-nested to avoid spurious ambiguity;
  * explicit epsilons are numbered symbols that live inside meta-prefixes;
  * **partial syntax modeling**: operator kinds listed in ``mask_ops`` get no paren
    pair (their structure is hidden from the LSTs).

Frozen copy of ``repro_torch/core/numbering.py`` for the benchmark's reference: the
reference builds its automaton from the pattern with this code, never with the
program's, so that a later change to the program's front-end cannot move the
yardstick.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Sequence, Set, Tuple

from . import regex as rx

# Symbol kinds
TERM = "term"
EPS = "eps"
OPEN = "open"
CLOSE = "close"
END = "end"

# Operator tags (for paren symbols and masking)
OP_CAT = "cat"
OP_ALT = "alt"
OP_STAR = "star"
OP_PLUS = "plus"
OP_OPT = "opt"
OP_REP = "rep"
OP_GROUP = "group"


@dataclass
class Symbol:
    sid: int                      # dense unique id (index into the symbol table)
    kind: str                     # term | eps | open | close | end
    num: int                      # paper numbering (terminal number / paren pair number)
    op: str | None = None         # operator tag for parens
    ranges: Tuple[Tuple[int, int], ...] | None = None  # for terms: matched byte ranges
    partner: int | None = None    # for open/close: sid of the matching paren

    def display(self) -> str:
        if self.kind == TERM:
            if self.ranges is not None and len(self.ranges) == 1 and self.ranges[0][0] == self.ranges[0][1]:
                ch = self.ranges[0][0]
                c = chr(ch) if 32 <= ch < 127 else f"\\x{ch:02x}"
                return f"{c}{self.num}"
            return f"Σ{self.num}"
        if self.kind == EPS:
            return f"ε{self.num}"
        if self.kind == OPEN:
            return f"{self.num}("
        if self.kind == CLOSE:
            return f"){self.num}"
        return "⊣"


# Linear-RE nodes (leaves are symbol ids)
@dataclass(frozen=True)
class LSym:
    sid: int


@dataclass(frozen=True)
class LCat:
    items: tuple


@dataclass(frozen=True)
class LAlt:
    items: tuple


@dataclass(frozen=True)
class LStar:
    item: object


@dataclass(frozen=True)
class LPlus:
    item: object


@dataclass(frozen=True)
class LOpt:
    item: object


@dataclass
class NumberedRE:
    """The numbered RE: symbol table, linear LST-RE, Glushkov sets, char classes."""

    ast: rx.Node
    symbols: List[Symbol]
    linear: object                     # linear-RE tree over LSym leaves
    end_sid: int                       # sid of ⊣
    first: FrozenSet[int]              # initial numbered symbols of LSTs
    follow: Dict[int, Set[int]]        # Fol (Eq. 2) over sids, includes ⊣ targets
    byte_to_class: List[int]           # 256 → class id (0 = DEAD: matches no terminal)
    n_classes: int                     # real classes incl. DEAD; PAD class id == n_classes
    term_classes: Dict[int, Tuple[int, ...]]  # term sid → class ids it matches
    infinitely_ambiguous: bool
    size: int                          # paper's ||e||

    @property
    def pad_class(self) -> int:
        """Synthetic identity class used by the engine to pad texts (matrix = I)."""
        return self.n_classes

    def classes_of_byte(self, b: int) -> int:
        return self.byte_to_class[b]

    def display_sym(self, sid: int) -> str:
        return self.symbols[sid].display()


class _Numberer:
    def __init__(self, mask_ops: Set[str]):
        self.symbols: List[Symbol] = []
        self.counter = 1  # paper numbering starts at 1
        self.mask_ops = mask_ops

    def fresh_num(self) -> int:
        n = self.counter
        self.counter += 1
        return n

    def new_symbol(self, kind: str, num: int, **kw) -> Symbol:
        s = Symbol(sid=len(self.symbols), kind=kind, num=num, **kw)
        self.symbols.append(s)
        return s

    def wrap(self, op: str, inner) -> object:
        """Surround ``inner`` with a fresh numbered paren pair (unless masked)."""
        if op in self.mask_ops:
            return inner
        num = self.fresh_num()
        o = self.new_symbol(OPEN, num, op=op)
        c = self.new_symbol(CLOSE, num, op=op)
        o.partner, c.partner = c.sid, o.sid
        return LCat((LSym(o.sid), inner, LSym(c.sid)))

    def transform(self, node: rx.Node) -> object:
        if isinstance(node, rx.Lit):
            s = self.new_symbol(TERM, self.fresh_num(), ranges=((node.char, node.char),))
            return LSym(s.sid)
        if isinstance(node, rx.CharClass):
            s = self.new_symbol(TERM, self.fresh_num(), ranges=node.ranges)
            return LSym(s.sid)
        if isinstance(node, rx.Eps):
            s = self.new_symbol(EPS, self.fresh_num())
            return LSym(s.sid)
        if isinstance(node, rx.Cat):
            # operator numbered before children (preorder, left-to-right)
            if OP_CAT in self.mask_ops:
                return LCat(tuple(self.transform(i) for i in node.items))
            num = self.fresh_num()
            o = self.new_symbol(OPEN, num, op=OP_CAT)
            c = self.new_symbol(CLOSE, num, op=OP_CAT)
            o.partner, c.partner = c.sid, o.sid
            inner = tuple(self.transform(i) for i in node.items)
            return LCat((LSym(o.sid),) + inner + (LSym(c.sid),))
        if isinstance(node, rx.Alt):
            if OP_ALT in self.mask_ops:
                return LAlt(tuple(self.transform(i) for i in node.items))
            num = self.fresh_num()
            o = self.new_symbol(OPEN, num, op=OP_ALT)
            c = self.new_symbol(CLOSE, num, op=OP_ALT)
            o.partner, c.partner = c.sid, o.sid
            inner = LAlt(tuple(self.transform(i) for i in node.items))
            return LCat((LSym(o.sid), inner, LSym(c.sid)))
        if isinstance(node, rx.Star):
            return self._iterator(OP_STAR, node.item, LStar)
        if isinstance(node, rx.Plus):
            return self._iterator(OP_PLUS, node.item, LPlus)
        if isinstance(node, rx.Opt):
            return self._iterator(OP_OPT, node.item, LOpt)
        if isinstance(node, rx.Group):
            num = self.fresh_num()
            o = self.new_symbol(OPEN, num, op=OP_GROUP)
            c = self.new_symbol(CLOSE, num, op=OP_GROUP)
            o.partner, c.partner = c.sid, o.sid
            inner = self.transform(node.item)
            return LCat((LSym(o.sid), inner, LSym(c.sid)))
        if isinstance(node, rx.Repeat):
            return self._repeat(node)
        raise TypeError(node)

    def _iterator(self, op: str, item: rx.Node, ctor) -> object:
        if op in self.mask_ops:
            return ctor(self.transform(item))
        num = self.fresh_num()
        o = self.new_symbol(OPEN, num, op=op)
        c = self.new_symbol(CLOSE, num, op=op)
        o.partner, c.partner = c.sid, o.sid
        return LCat((LSym(o.sid), ctor(self.transform(item)), LSym(c.sid)))

    def _repeat(self, node: rx.Repeat) -> object:
        """Bounded repetition e{h,k} (App. A / Ex. 5).

        One paren pair for the repetition operator; the body is copy-expanded with
        *progressive numbering*.  Optional copies are right-nested so that iteration
        i+1 can only appear if iteration i did (no spurious ambiguity).  ``{h,}``
        appends a bare star over one extra copy.
        """
        lo, hi = node.lo, node.hi
        num = None
        if OP_REP not in self.mask_ops:
            num = self.fresh_num()
            o = self.new_symbol(OPEN, num, op=OP_REP)
            c = self.new_symbol(CLOSE, num, op=OP_REP)
            o.partner, c.partner = c.sid, o.sid
        mandatory = [self.transform(node.item) for _ in range(lo)]
        if hi is None:
            tail: object | None = LStar(self.transform(node.item))
        else:
            tail = None
            for _ in range(hi - lo):
                inner = self.transform(node.item)
                seq = (inner,) if tail is None else (inner, tail)
                tail = LOpt(LCat(seq) if len(seq) > 1 else inner)
        parts = tuple(mandatory) + ((tail,) if tail is not None else ())
        if not parts:  # e{0}: generates only epsilon
            body: object = LCat(())
        elif len(parts) == 1:
            body = parts[0]
        else:
            body = LCat(parts)
        if num is None:
            return body
        return LCat((LSym(o.sid), body, LSym(c.sid)))


def _glushkov(node, follow: Dict[int, Set[int]]):
    """Return (nullable, first, last) and accumulate follow links."""
    if isinstance(node, LSym):
        return False, {node.sid}, {node.sid}
    if isinstance(node, LCat):
        nullable, first, last = True, set(), set()
        for item in node.items:
            n, f, l = _glushkov(item, follow)
            for p in last:
                follow.setdefault(p, set()).update(f)
            if nullable:
                first |= f
            if n:
                last |= l
            else:
                last = set(l)
            nullable = nullable and n
        return nullable, first, last
    if isinstance(node, LAlt):
        nullable, first, last = False, set(), set()
        for item in node.items:
            n, f, l = _glushkov(item, follow)
            nullable = nullable or n
            first |= f
            last |= l
        return nullable, first, last
    if isinstance(node, (LStar, LPlus)):
        n, f, l = _glushkov(node.item, follow)
        for p in l:
            follow.setdefault(p, set()).update(f)
        return (True if isinstance(node, LStar) else n), f, l
    if isinstance(node, LOpt):
        n, f, l = _glushkov(node.item, follow)
        return True, f, l
    raise TypeError(node)


def _char_classes(symbols: Sequence[Symbol], alphabet_size: int = 256):
    """Partition the byte alphabet into equivalence classes (App. A, Fig. A1).

    Two bytes are equivalent iff they are matched by exactly the same set of terminal
    symbols.  Class 0 is reserved for DEAD bytes (matched by no terminal) so that
    invalid input bytes map to the all-zero connection matrix.
    """
    terms = [s for s in symbols if s.kind == TERM]
    sig_to_class: Dict[FrozenSet[int], int] = {}
    byte_to_class = [0] * alphabet_size
    term_classes: Dict[int, Set[int]] = {s.sid: set() for s in terms}
    for b in range(alphabet_size):
        sig = frozenset(s.sid for s in terms if any(lo <= b <= hi for lo, hi in s.ranges))
        if not sig:
            byte_to_class[b] = 0
            continue
        if sig not in sig_to_class:
            sig_to_class[sig] = len(sig_to_class) + 1
        cid = sig_to_class[sig]
        byte_to_class[b] = cid
        for sid in sig:
            term_classes[sid].add(cid)
    n_classes = len(sig_to_class) + 1
    return byte_to_class, n_classes, {k: tuple(sorted(v)) for k, v in term_classes.items()}


def number_regex(
    ast: rx.Node | str,
    *,
    mask_ops: Sequence[str] = (),
    alphabet_size: int = 256,
) -> NumberedRE:
    """Build the numbered RE / linear LST-RE and its Glushkov sets."""
    if isinstance(ast, str):
        ast = rx.parse_regex(ast)
    numberer = _Numberer(set(mask_ops))
    linear = numberer.transform(ast)
    symbols = numberer.symbols
    end = Symbol(sid=len(symbols), kind=END, num=0)
    symbols.append(end)

    follow: Dict[int, Set[int]] = {}
    nullable, first, last = _glushkov(linear, follow)
    for p in last:
        follow.setdefault(p, set()).add(end.sid)
    first = set(first)
    if nullable:
        # Only possible for degenerate REs like ``a{0}`` whose LST-RE is empty;
        # the LST is then just ⊣.
        first.add(end.sid)

    byte_to_class, n_classes, term_classes = _char_classes(symbols, alphabet_size)
    return NumberedRE(
        ast=ast,
        symbols=symbols,
        linear=linear,
        end_sid=end.sid,
        first=frozenset(first),
        follow={k: set(v) for k, v in follow.items()},
        byte_to_class=byte_to_class,
        n_classes=n_classes,
        term_classes=term_classes,
        infinitely_ambiguous=rx.infinitely_ambiguous(ast),
        size=rx.node_size(ast),
    )
