"""Streaming incremental parse: a balanced monoid tree of chunk products.

The batch engine (``core/engine.py``) re-pays the full reach pass over the
whole text for every parse.  But the paper derives *all* cross-chunk
structure from the per-chunk summaries ``P_i`` (Eq. 6) and the log-depth
join (Eq. 7) — and those summaries form a monoid that composes
incrementally (the Simultaneous-Finite-Automata view, PAPERS.md):

    P(prefix · piece) = P(piece) ⊗ P(prefix)

so appending text only requires the *new* piece's reach product plus a
re-join over the cached summaries, and — because ``compose`` is
associative — *any* re-association of the chunk sequence is equally valid.
``StreamingParser`` exploits both:

  segment tree     sealed chunks live as the leaves of a height-balanced
                   binary tree (an AVL-style rope keyed by character
                   position); every internal node can cache the composed
                   product of its subtree in the backend's opaque
                   representation.  Appends touch only the right spine;
                   ``edit(lo, hi, replacement)`` splices a leaf range and
                   re-composes ONE leaf-to-root path — O(log n) device
                   work — instead of re-joining the whole suffix (the
                   Bille & Gørtz query-interface workload, PAPERS.md).
                   Products are opaque per the ``core/backend.py``
                   contract, so cache residency follows the backend
                   (packed words cut bytes 32×; sparse rows shrink to the
                   speculation width) and the ``cache_nbytes`` accounting
                   sees the reduction automatically.
  mutable tail     the unsealed suffix; its running product is *extended*
                   (one ``compose`` per appended piece), never re-folded.
  join cache       forward/backward entries over [leaves…, tail] from
                   ``core/scan.py``'s ``exclusive_entries`` — O(c) product
                   compositions per refresh, c = number of leaves.

Geometric chunk-sealing: the tail seals when it reaches ``next_seal_len``,
which then doubles (capped at ``max_seal_len``) — so an append-only prefix
of length n holds O(log n) leaves, every sealed length is
first_seal_len·2^i, and every device shape lands in a power-of-two bucket;
appending never adds a program shape.  Under a ``max_seal_len`` cap the leaf count is
n/cap, and the tree keeps edits at O(cap + log n): an edit re-reaches only
the spliced leaves and re-composes the internal products along the new
spine, so ``accepted`` after an edit costs one tiny 2-product join over
the refreshed root product — never a full O(#leaves) re-join.

The product stack fed to the join is padded with identity products to the
next power of two **plus at least one identity** — identities are no-ops
for both scan directions, and the guaranteed pad slot makes the forward
state *after* the last real chunk available as ``Jf[c_real]`` (the
streaming acceptance state) without an extra inclusive scan.

``current_slpf()`` materializes the full clean SLPF of the prefix: one
join over the leaf products plus build&merge per group of equal padded
length (see below) — no reach work for sealed chunks.  Output is bit-identical to a cold ``ParserEngine.parse``
of the same prefix (the clean SLPF is unique) — including after any
sequence of edits — validated against ``core/reference.py`` in tests.

``snapshot()``/``restore()`` capture/reinstate the whole stream state in
O(1) device work (products are shared by reference; only class buffers
are copied).  Torch tensors are mutable where the reference's arrays are
not, so sharing rests on a rule: no phase, launcher or method here writes
into a product, an entry or an identity in place — every product is a fresh
tensor from ``reach`` or ``compose``, and a slot is only ever rebound.
``restore`` clamps the snapshot's seal boundary to this parser's
``max_seal_len`` (the cap is a promise, never exceeded — a snapshot from a
larger/uncapped config reseals its oversized tail into cap-sized leaves).
``drop_cache()`` releases the device tensors
(serving-layer eviction) and ``drop_sealed_product(key)`` releases a
single tree node's product — internal nodes are first-class eviction
candidates: they cover the most characters and rebuild with one
``compose``.  Dropping a product also releases the join entries (they are
only reachable through the same budget, so keeping them would let a
session sit over budget with nothing left to evict); classes are retained
host-side and missing products rebuild transparently on the next touch,
counted per re-reached chunk in ``rebuilds``.

``current_slpf()`` groups the chunks by padded length and runs one
build&merge and one device→host copy per group, where the reference runs
one per leaf: each chunk's columns depend only on its classes and its two
entries, so the bits are the same and a capped stream of many leaves pays
a handful of launches, not one per leaf.

The port's copy of ``repro/core/stream.py`` on the port's engine.  Mesh
routing is not ported (ROADMAP Queue 1 item 11): ``mesh=`` raises.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from ..errors import BudgetExceeded
from .backend import ParserBackend, next_pow2
from .engine import _resolve_engine, unpack_columns
from .slpf import SLPF

# ---------------------------------------------------------------------------
# The product segment tree: an AVL-style rope whose leaves are sealed chunks
# (host-side class buffer + cached device product) and whose internal nodes
# lazily cache the composed product of their subtree.  Nodes are immutable
# in *structure* (concat/split share untouched subtrees, so a snapshot's
# leaf view stays valid); the only mutation is the ``product`` slot, which
# is a memo: None ⇔ evicted / not yet composed.
# ---------------------------------------------------------------------------

_uid = itertools.count()


def _nbytes(t: torch.Tensor) -> int:
    """Device bytes of one cached tensor."""
    return int(t.numel()) * t.element_size()


class _Node:
    __slots__ = ("uid", "classes", "left", "right", "product",
                 "n_chars", "n_leaves", "height")


def _leaf(classes: np.ndarray, product) -> _Node:
    nd = _Node()
    nd.uid = next(_uid)
    nd.classes = np.asarray(classes, dtype=np.int32)
    nd.left = nd.right = None
    nd.product = product
    nd.n_chars = int(len(classes))
    nd.n_leaves = 1
    nd.height = 0
    return nd


def _branch(l: _Node, r: _Node) -> _Node:
    nd = _Node()
    nd.uid = next(_uid)
    nd.classes = None
    nd.left, nd.right = l, r
    nd.product = None          # composed lazily (memoized) on first demand
    nd.n_chars = l.n_chars + r.n_chars
    nd.n_leaves = l.n_leaves + r.n_leaves
    nd.height = 1 + max(l.height, r.height)
    return nd


def _balanced(l: _Node, r: _Node) -> _Node:
    """Join two trees whose heights differ by at most 2 (one rotation)."""
    if l.height > r.height + 1:
        if l.left.height >= l.right.height:
            return _branch(l.left, _branch(l.right, r))
        lr = l.right
        return _branch(_branch(l.left, lr.left), _branch(lr.right, r))
    if r.height > l.height + 1:
        if r.right.height >= r.left.height:
            return _branch(_branch(l, r.left), r.right)
        rl = r.left
        return _branch(_branch(l, rl.left), _branch(rl.right, r.right))
    return _branch(l, r)


def _concat(l: Optional[_Node], r: Optional[_Node]) -> Optional[_Node]:
    """Height-balanced concatenation; shares every untouched subtree (and
    its cached product) between the input and output trees."""
    if l is None:
        return r
    if r is None:
        return l
    if l.height > r.height + 1:
        return _balanced(l.left, _concat(l.right, r))
    if r.height > l.height + 1:
        return _balanced(_concat(l, r.left), r.right)
    return _branch(l, r)


def _split_leaves(node: Optional[_Node], k: int):
    """Split ``node`` into (tree of the first ``k`` leaves, tree of the rest)."""
    if node is None or k <= 0:
        return None, node
    if k >= node.n_leaves:
        return node, None
    if k <= node.left.n_leaves:
        a, b = _split_leaves(node.left, k)
        return a, _concat(b, node.right)
    a, b = _split_leaves(node.right, k - node.left.n_leaves)
    return _concat(node.left, a), b


def _build(leaves: List[_Node]) -> Optional[_Node]:
    """Perfectly balanced tree over a leaf list."""
    if not leaves:
        return None

    def rec(lo: int, hi: int) -> _Node:
        if hi - lo == 1:
            return leaves[lo]
        mid = (lo + hi) // 2
        return _branch(rec(lo, mid), rec(mid, hi))

    return rec(0, len(leaves))


def _iter_leaves(node: Optional[_Node]) -> Iterator[_Node]:
    """Leaves left-to-right (the flattened chunk frontier)."""
    if node is None:
        return
    stack = [node]
    while stack:
        nd = stack.pop()
        if nd.classes is not None:
            yield nd
        else:
            stack.append(nd.right)
            stack.append(nd.left)


def _iter_nodes(node: Optional[_Node]) -> Iterator[_Node]:
    """Every node of the tree (order unspecified)."""
    if node is None:
        return
    stack = [node]
    while stack:
        nd = stack.pop()
        yield nd
        if nd.classes is None:
            stack.append(nd.left)
            stack.append(nd.right)


def _locate(node: _Node, pos: int) -> Tuple[int, int, _Node]:
    """(leaf index, leaf start char, leaf) of the leaf containing ``pos``."""
    idx = 0
    start = 0
    while node.classes is None:
        if pos < node.left.n_chars:
            node = node.left
        else:
            pos -= node.left.n_chars
            idx += node.left.n_leaves
            start += node.left.n_chars
            node = node.right
    return idx, start, node


@dataclass(frozen=True)
class StreamSnapshot:
    """Immutable capture of a stream's full state.

    Products are tensors shared by reference (never written in place — see
    the module note); class buffers are copied numpy arrays.  A snapshot of an evicted (cold) parser carries
    ``sealed_products=None`` — restoring it reinstates the cold state and the
    cache rebuilds on the next touch, so ``snapshot`` is O(1) device work in
    every state.  A warm snapshot under *partial* eviction preserves the
    ``None`` holes per chunk.  ``restore`` accepts snapshots across
    ``StreamingParser`` instances that share an engine — including across
    differing seal configs: the boundary clamps to the restoring parser's
    ``max_seal_len``.
    """

    sealed_classes: Tuple[np.ndarray, ...]
    sealed_products: Optional[Tuple[Optional[torch.Tensor], ...]]
    tail_classes: np.ndarray
    tail_product: Optional[torch.Tensor]
    next_seal_len: int


class StreamingParser:
    """Incremental parser over a balanced product segment tree."""

    def __init__(
        self,
        matrices_or_engine,
        *,
        backend: Union[str, ParserBackend, None] = None,
        first_seal_len: int = 8,
        max_seal_len: Optional[int] = None,
        mesh=None,
        mesh_rules=None,
        device=None,
    ):
        self.engine = _resolve_engine(
            matrices_or_engine, backend, mesh, mesh_rules, device=device
        )
        self.first_seal_len = next_pow2(max(1, first_seal_len))
        if max_seal_len is None:
            self.max_seal_len = None
        else:
            # floor to a power of two: the cap is a promise, never exceeded
            floored = 1 << (max(1, max_seal_len).bit_length() - 1)
            self.max_seal_len = max(self.first_seal_len, floored)
        t = self.engine.tables
        # the monoid identity in the engine backend's product representation
        # (f32 eye / packed-word eye / flagged sparse identity) — tail init
        # and join-stack pad slots
        self._eye = self.engine.backend.identity_product(t.ell_pad, device=self.engine.device)
        # host copies of I and F for the acceptance checks
        self._I = t.I.cpu().numpy()
        self._F = t.F.cpu().numpy()

        # prefix cache -----------------------------------------------------
        self._root: Optional[_Node] = None     # sealed chunks, leaf-ordered
        self._tail_pieces: List[np.ndarray] = []
        self._tail_len = 0
        self._tail_product: torch.Tensor = self._eye
        self._next_seal = self.first_seal_len
        self._cold = False            # True ⇔ products evicted, classes kept
        # join cache over [leaves…, tail]: (Jf, Jb, packed col0, c_real)
        self._join: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]] = None
        # uid → node map rebuilt by sealed_cache_entries (eviction keys)
        self._evict_index: Dict[int, _Node] = {}

        # counters ---------------------------------------------------------
        self.appended_bytes = 0
        self.rebuilds = 0             # evicted chunks re-reached (per chunk)
        self.edits = 0
        self._recomposed = 0          # internal-node products composed

    # ------------------------------------------------------------- geometry

    @property
    def n(self) -> int:
        """Current prefix length (characters appended so far)."""
        return (self._root.n_chars if self._root is not None else 0) + self._tail_len

    @property
    def n_sealed_chunks(self) -> int:
        return self._root.n_leaves if self._root is not None else 0

    def tail_room(self) -> int:
        """Characters the tail accepts before the next seal boundary."""
        return self._next_seal - self._tail_len

    @property
    def compile_count(self) -> int:
        return self.engine.compile_count

    @property
    def tree_height(self) -> int:
        """Height of the product segment tree (0 for ≤1 sealed chunk)."""
        return self._root.height if self._root is not None else 0

    # back-compat views of the leaf frontier (tests and tooling peek here)
    @property
    def _sealed_classes(self) -> List[np.ndarray]:
        return [lf.classes for lf in _iter_leaves(self._root)]

    @property
    def _sealed_products(self) -> List[Optional[torch.Tensor]]:
        if self._cold:
            return []
        return [lf.product for lf in _iter_leaves(self._root)]

    @property
    def cache_nbytes(self) -> int:
        """Device bytes held by the prefix cache: every resident node
        product (leaves AND internal memos) + tail product + join entries.

        An empty tail holds the shared identity matrix, not cache — counting
        it would report phantom bytes eviction cannot free.  Every byte
        counted here is releasable through ``drop_sealed_product`` /
        ``drop_cache`` (the join entries ride along with the first product
        drop), so a bytes-budget eviction loop always converges."""
        if self._cold:
            return 0
        total = 0
        for nd in _iter_nodes(self._root):
            if nd.product is not None:
                total += _nbytes(nd.product)
        if self._tail_len:
            total += _nbytes(self._tail_product)
        total += self._join_nbytes()
        return total

    def _join_nbytes(self) -> int:
        if self._join is None:
            return 0
        Jf, Jb, col0p, _ = self._join
        return sum(_nbytes(a) for a in (Jf, Jb, col0p))

    # --------------------------------------------------------------- append

    def append(self, text) -> int:
        """Extend the stream; returns the number of characters appended.

        Incremental cost: one bucketed reach over each appended piece (a
        piece never crosses a seal boundary — large appends split into
        O(log) geometric pieces), one ``compose`` per piece to extend the
        tail product, and one exclusive join over the cached summaries —
        eager on purpose, so ``accepted`` is O(1) after every append (the
        batched service path goes through ``absorb_product`` instead, which
        defers the join to first query).  No sealed product is ever
        recomputed.
        """
        classes = self.engine.classes_of_text(text)
        if len(classes) == 0:
            return 0
        self._ensure_cache()
        i = 0
        while i < len(classes):
            piece = classes[i : i + self.tail_room()]
            i += len(piece)
            self.absorb_product(piece, self._reach_piece(piece))
        self._refresh_join()
        return len(classes)

    def _reach_piece(self, piece: np.ndarray) -> torch.Tensor:
        """Reach product of one piece via the bucketed phase program."""
        k = self._bucket_len(len(piece))
        chunk = self.engine.chunks_tensor(self.engine._pad_to(piece, 1, k))
        return self.engine.phases.reach(self.engine.tables.N, chunk)[0]

    def _bucket_len(self, m: int) -> int:
        return next_pow2(max(self.engine.min_chunk_len, m))

    def absorb_product(self, piece: np.ndarray, product: torch.Tensor) -> None:
        """Fold one already-reached piece into the tail (service fast path).

        ``piece`` must fit inside the current seal boundary (``tail_room``);
        ``product`` is its reach product *in the engine backend's product
        representation* (f32 matrix / packed words — opaque per the
        ``core/backend.py`` contract) — from ``_reach_piece`` or from a
        batched reach the serving layer ran across sessions.
        """
        if len(piece) > self.tail_room():
            raise BudgetExceeded(
                f"piece of {len(piece)} chars crosses the seal boundary "
                f"(tail_room={self.tail_room()}); split it first",
                budget=self.tail_room(),
                requested=len(piece),
            )
        self._ensure_cache()
        self._tail_product = self.engine.phases.compose(product, self._tail_product)
        self._tail_pieces.append(np.asarray(piece, dtype=np.int32))
        self._tail_len += len(piece)
        self.appended_bytes += len(piece)
        self._join = None
        if self._tail_len == self._next_seal:
            self._seal()

    def _seal(self) -> None:
        """Seal the full tail as a new rightmost leaf with its product."""
        leaf = _leaf(np.concatenate(self._tail_pieces), self._tail_product)
        self._root = _concat(self._root, leaf)
        self._tail_pieces = []
        self._tail_len = 0
        self._tail_product = self._eye
        grown = self._next_seal * 2
        if self.max_seal_len is not None:
            grown = min(grown, self.max_seal_len)
        self._next_seal = grown

    # ----------------------------------------------------------------- edit

    def edit(self, lo: int, hi: int, replacement) -> int:
        """Splice: replace characters ``[lo, hi)`` with ``replacement``.

        Returns the new prefix length.  Device cost is O(cap + log n): the
        touched leaves re-reach (each at most ``max_seal_len`` chars, or the
        largest covered leaf when uncapped) and the internal products along
        the new leaf-to-root spine re-compose — the untouched subtrees keep
        their cached products by structural sharing.  The result is
        bit-identical to a cold parse of the edited text: the join is
        associative, so re-associating the spliced chunk sequence changes
        no downstream value (SFA view, PAPERS.md).
        """
        repl = self.engine.classes_of_text(replacement)
        lo, hi = int(lo), int(hi)
        if not (0 <= lo <= hi <= self.n):
            raise ValueError(
                f"edit range [{lo}, {hi}) out of bounds for prefix of {self.n}"
            )
        with self.engine.obs.span(
            "stream.edit", lo=lo, hi=hi, repl_chars=int(len(repl)), n_chars=self.n
        ):
            return self._edit(lo, hi, repl)

    def delete(self, lo: int, hi: int) -> int:
        """Remove characters ``[lo, hi)`` — ``edit`` with empty replacement."""
        return self.edit(lo, hi, np.zeros(0, dtype=np.int32))

    def insert(self, pos: int, text) -> int:
        """Insert ``text`` before position ``pos`` — a zero-width ``edit``."""
        return self.edit(pos, pos, text)

    def _edit(self, lo: int, hi: int, repl: np.ndarray) -> int:
        sealed_chars = self._root.n_chars if self._root is not None else 0
        if self._cold:
            # wake without the eager full rebuild: the edit re-reaches only
            # what it touches; untouched evicted products rebuild lazily on
            # the next query.  The tail product must come back NOW only when
            # the edit keeps the tail (otherwise the splice rebuilds it).
            self._cold = False
            if self._tail_len and hi <= sealed_chars and lo < sealed_chars:
                self._tail_product = self._reach_piece(
                    np.concatenate(self._tail_pieces)
                )
                self._count_rebuild()
            elif not self._tail_len:
                self._tail_product = self._eye
        self._join = None

        if lo >= sealed_chars:
            # tail-only splice (covers insert-at-n and the empty stream)
            tail = (
                np.concatenate(self._tail_pieces)
                if self._tail_len
                else np.zeros(0, dtype=np.int32)
            )
            off = lo - sealed_chars
            cut = hi - sealed_chars
            self._rebuild_tail(np.concatenate([tail[:off], repl, tail[cut:]]))
        else:
            a_idx, a_start, _ = _locate(self._root, lo)
            touch_tail = hi > sealed_chars
            if touch_tail:
                b_idx = self._root.n_leaves - 1
            else:
                b_idx, _, _ = _locate(self._root, max(hi - 1, lo))
            left, rest = _split_leaves(self._root, a_idx)
            middle, right = _split_leaves(rest, b_idx - a_idx + 1)
            mid_classes = [lf.classes for lf in _iter_leaves(middle)]
            if touch_tail:
                mid_classes.extend(self._tail_pieces)
                self._tail_pieces = []
                self._tail_len = 0
                self._tail_product = self._eye
            merged = np.concatenate(mid_classes)
            off = lo - a_start
            cut = hi - a_start
            new_middle = np.concatenate([merged[:off], repl, merged[cut:]])

            # leaf cap for the re-sealed splice: the configured cap, else the
            # pow2 bucket of the largest covered leaf (shapes stay bucketed)
            if self.max_seal_len is not None:
                cap = self.max_seal_len
            else:
                biggest = max((len(c) for c in mid_classes), default=1)
                cap = max(self.first_seal_len, next_pow2(max(1, biggest)))

            new_leaves: List[_Node] = []
            pos = 0
            if touch_tail:
                # full-cap leaves, remainder becomes the new tail
                while len(new_middle) - pos >= cap:
                    piece = new_middle[pos : pos + cap]
                    pos += cap
                    new_leaves.append(_leaf(piece, self._reach_piece(piece)))
                self._root = _concat(left, _build(new_leaves))
                self._next_seal = cap
                self._rebuild_tail(new_middle[pos:])
            else:
                while pos < len(new_middle):
                    piece = new_middle[pos : pos + cap]
                    pos += len(piece)
                    new_leaves.append(_leaf(piece, self._reach_piece(piece)))
                self._root = _concat(_concat(left, _build(new_leaves)), right)

        # refresh the root product now: the spine composes (that IS the
        # O(log n) claim — record its depth) and `accepted` stays O(1)
        depth = 0
        if self._root is not None:
            before = self._recomposed
            self._node_product(self._root)
            depth = self._recomposed - before
        self.edits += 1
        m = self.engine.obs.metrics
        m.counter("stream_edits_total").inc()
        m.histogram("stream_edit_recompose_depth").observe(float(depth))
        return self.n

    def _rebuild_tail(self, classes: np.ndarray) -> None:
        """Re-absorb ``classes`` as the new tail, sealing at boundaries.

        The edit-path twin of the ``append`` loop: same piece splitting,
        same seal geometry — but spliced characters are not *appended*
        traffic, so ``appended_bytes`` stays untouched."""
        self._tail_pieces = []
        self._tail_len = 0
        self._tail_product = self._eye
        classes = np.asarray(classes, dtype=np.int32)
        i = 0
        while i < len(classes):
            piece = classes[i : i + self.tail_room()]
            i += len(piece)
            self._tail_product = self.engine.phases.compose(
                self._reach_piece(piece), self._tail_product
            )
            self._tail_pieces.append(piece)
            self._tail_len += len(piece)
            if self._tail_len == self._next_seal:
                self._seal()

    def _node_product(self, node: _Node) -> torch.Tensor:
        """Memoized subtree product: compose(right, left) bottoms out at
        leaf products, re-reaching evicted leaves (counted per chunk)."""
        if node.product is None:
            if node.classes is not None:
                node.product = self._reach_piece(node.classes)
                self._count_rebuild()
            else:
                lp = self._node_product(node.left)
                rp = self._node_product(node.right)
                node.product = self.engine.phases.compose(rp, lp)
                self._recomposed += 1
        return node.product

    # ----------------------------------------------------------------- join

    def _chunk_classes(self) -> List[np.ndarray]:
        chunks = [lf.classes for lf in _iter_leaves(self._root)]
        if self._tail_len:
            chunks.append(np.concatenate(self._tail_pieces))
        return chunks

    def _stack_products(self) -> Tuple[torch.Tensor, int]:
        """The flattened leaf frontier stacked (c_pad, …) in the backend's
        product representation; pad slots are identity.

        c_pad = next_pow2(c_real + 1): at least one identity pad, so the
        exclusive forward entries extend one slot past the real chunks and
        ``Jf[c_real]`` is the forward state after the whole prefix.
        """
        products = [lf.product for lf in _iter_leaves(self._root)]
        if self._tail_len:
            products.append(self._tail_product)
        c_real = len(products)
        c_pad = next_pow2(c_real + 1)
        products.extend([self._eye] * (c_pad - c_real))
        return torch.stack(products), c_real

    def _refresh_join(self) -> None:
        if self.n == 0:
            self._join = None
            return
        t = self.engine.tables
        P, c_real = self._stack_products()
        Jf, Jb, col0p = self.engine.phases.join(P, t.I, t.F)
        self._join = (Jf, Jb, col0p, c_real)

    def _joined(self):
        self._ensure_cache()
        if self._join is None:
            self._refresh_join()
        return self._join

    def _final_forward(self) -> np.ndarray:
        """Forward state after the whole prefix via the ROOT product: one
        memoized leaf-to-root path plus a single 2-product join — O(log n)
        after an edit, never the full O(#chunks) join."""
        if self._cold:
            self._ensure_cache()
        total = None
        if self._root is not None:
            total = self._node_product(self._root)
        if self._tail_len:
            total = (
                self._tail_product
                if total is None
                else self.engine.phases.compose(self._tail_product, total)
            )
        t = self.engine.tables
        # 2-slot stack [total, eye]: exclusive forward entries give Jf[1] =
        # I carried through `total` (2 is already a pow2, join contract holds)
        Jf, _, _ = self.engine.phases.join(
            torch.stack([total, self._eye]), t.I, t.F
        )
        return Jf[1].cpu().numpy()

    @property
    def accepted(self) -> bool:
        """Is the current prefix a valid text?  O(1) from the join cache
        when present, else one root-product path (O(log n) after edits)."""
        if self.n == 0:
            return bool(np.any(self._I * self._F))
        if self._join is not None:
            Jf, _, _, c_real = self._join
            final_fwd = Jf[c_real].cpu().numpy()
        else:
            final_fwd = self._final_forward()
        return bool(np.any(final_fwd * self._F))

    # ----------------------------------------------------------------- slpf

    def current_slpf(self) -> SLPF:
        """Clean SLPF of the whole current prefix.

        Join over the cached products + one build&merge per chunk (bucketed
        shapes) — zero reach work for sealed chunks.  Bit-identical to a
        cold ``ParserEngine.parse`` of the same prefix.
        """
        with self.engine.obs.span(
            "stream.query", n_chars=self.n, n_sealed=self.n_sealed_chunks
        ):
            return self._current_slpf()

    def _current_slpf(self) -> SLPF:
        eng = self.engine
        t = eng.tables
        chunks = self._chunk_classes()
        classes = (
            np.concatenate(chunks) if chunks else np.zeros(0, dtype=np.int32)
        )
        if len(classes) == 0:
            col = self._I.astype(bool) & self._F.astype(bool)
            return SLPF(table=eng.table, columns=col[None, : t.ell], classes=classes)

        Jf, Jb, col0p, c_real = self._joined()
        assert c_real == len(chunks)
        rows = self._build_merge_grouped(chunks, Jf, Jb)
        packed = np.concatenate([col0p.cpu().numpy()[None]] + rows, axis=0)
        columns = unpack_columns(packed.view(np.uint32), t.ell)
        return SLPF(table=eng.table, columns=columns, classes=classes)

    def _build_merge_grouped(
        self, chunks: List[np.ndarray], Jf: torch.Tensor, Jb: torch.Tensor
    ) -> List[np.ndarray]:
        """Packed columns (len, W) of every chunk, in order: one
        build&merge and one device→host copy per padded chunk length, over
        that group's chunks and their gathered entries."""
        eng = self.engine
        groups: Dict[int, List[int]] = {}
        for i, ch in enumerate(chunks):
            groups.setdefault(self._bucket_len(len(ch)), []).append(i)
        rows: List[Optional[np.ndarray]] = [None] * len(chunks)
        for k, idxs in sorted(groups.items()):
            grid = np.stack([eng._pad_to(chunks[i], 1, k)[0] for i in idxs])
            sel = torch.tensor(idxs, dtype=torch.long, device=Jf.device)
            Mp = eng.phases.build_merge(
                eng.tables.N, eng.chunks_tensor(grid), Jf[sel], Jb[sel]
            ).cpu().numpy()
            for row, i in enumerate(idxs):
                rows[i] = Mp[row, : len(chunks[i])]
        return rows  # type: ignore[return-value]

    def count_trees(self) -> int:
        return self.current_slpf().count_trees()

    # ----------------------------------------------------- snapshot / evict

    def snapshot(self) -> StreamSnapshot:
        """O(1)-device capture of the stream state (products shared by ref).

        A cold (evicted) parser snapshots without rebuilding: the snapshot
        records the cold state and restore defers the rebuild to next touch.
        """
        leaves = list(_iter_leaves(self._root))
        tail = (
            np.concatenate(self._tail_pieces)
            if self._tail_len
            else np.zeros(0, dtype=np.int32)
        )
        return StreamSnapshot(
            sealed_classes=tuple(lf.classes.copy() for lf in leaves),
            sealed_products=(
                None if self._cold else tuple(lf.product for lf in leaves)
            ),
            tail_classes=tail,
            tail_product=None if self._cold else self._tail_product,
            next_seal_len=self._next_seal,
        )

    def restore(self, snap: StreamSnapshot) -> None:
        """Reinstate a snapshot taken on this engine's table set.

        The seal boundary clamps to THIS parser's ``max_seal_len`` — the
        cap is a promise, never exceeded, even for snapshots taken under a
        larger or uncapped config.  A tail longer than the clamped boundary
        reseals into cap-sized leaves (products rebuild lazily)."""
        cold = snap.sealed_products is None
        prods = (
            [None] * len(snap.sealed_classes)
            if cold
            else list(snap.sealed_products)
        )
        self._root = _build(
            [_leaf(c.copy(), p) for c, p in zip(snap.sealed_classes, prods)]
        )
        self._tail_pieces = (
            [snap.tail_classes.copy()] if len(snap.tail_classes) else []
        )
        self._tail_len = int(len(snap.tail_classes))
        self._tail_product = self._eye if cold else snap.tail_product
        self._cold = cold
        self._join = None
        self._evict_index = {}
        next_seal = int(snap.next_seal_len)
        if self.max_seal_len is not None:
            next_seal = min(next_seal, self.max_seal_len)
        self._next_seal = next_seal
        if self._tail_len >= self._next_seal:
            self._reseal_oversized_tail()

    def _reseal_oversized_tail(self) -> None:
        """Carve a restored tail that meets/exceeds the (clamped) seal
        boundary into cap-sized leaves.  The snapshot's tail product covered
        the whole oversized tail, so the carved leaves start product-less
        (the partial-eviction state ``_ensure_cache`` already repairs) and
        a warm remainder re-reaches eagerly."""
        classes = np.concatenate(self._tail_pieces)
        cap = self._next_seal
        pos = 0
        while len(classes) - pos >= cap:
            piece = classes[pos : pos + cap]
            pos += cap
            self._root = _concat(self._root, _leaf(piece, None))
        rest = np.asarray(classes[pos:], dtype=np.int32)
        self._tail_pieces = [rest] if len(rest) else []
        self._tail_len = int(len(rest))
        self._tail_product = self._eye
        if not self._cold and self._tail_len:
            self._tail_product = self._reach_piece(rest)

    def drop_cache(self) -> None:
        """Release all device product arrays (serving-layer eviction).

        Classes stay host-side; the next ``append``/``current_slpf``
        transparently re-reaches the sealed chunks (counted per chunk in
        ``rebuilds``).  Results are unaffected — only the work is.
        """
        for nd in _iter_nodes(self._root):
            nd.product = None
        self._tail_product = self._eye
        self._join = None
        self._cold = True
        self._evict_index = {}

    def sealed_cache_entries(self) -> List[Tuple[int, int, int]]:
        """(key, covered_chars, bytes) of each RESIDENT node product — the
        per-product eviction candidates the serving layer ranks.  Leaves
        cover one chunk; internal nodes cover their whole subtree, so the
        cost-aware largest-first policy drops them first — the cheapest
        rebuild there is ONE compose over the children.  Keys are stable
        node ids, valid until the tree is next edited."""
        if self._cold:
            return []
        self._evict_index = {}
        out: List[Tuple[int, int, int]] = []
        leaves = list(_iter_leaves(self._root))
        internals = [nd for nd in _iter_nodes(self._root) if nd.classes is None]
        for nd in leaves + internals:
            if nd.product is not None:
                self._evict_index[nd.uid] = nd
                out.append((nd.uid, nd.n_chars, _nbytes(nd.product)))
        return out

    def drop_sealed_product(self, key: int) -> int:
        """Release ONE tree node's cached product; returns bytes freed —
        INCLUDING the join entries, which are released alongside the first
        drop so the bytes budget only counts memory eviction can actually
        reclaim (a budget below the join size still converges).

        Finer-grained than ``drop_cache``: other products stay resident and
        only the dropped node rebuilds on the next touch (a re-reach for a
        leaf, one compose for an internal node).  No-op (0 bytes) when
        already cold, dropped, or the key predates an edit.
        """
        if self._cold:
            return 0
        nd = self._evict_index.get(key)
        if nd is None:
            self.sealed_cache_entries()    # tree may have changed; re-index
            nd = self._evict_index.get(key)
        if nd is None or nd.product is None:
            return 0
        freed = _nbytes(nd.product)
        nd.product = None
        freed += self._join_nbytes()
        self._join = None
        return freed

    def _count_rebuild(self) -> None:
        self.rebuilds += 1
        self.engine.obs.metrics.counter("stream_rebuilds_total").inc()

    def _ensure_cache(self) -> None:
        if self._cold:
            self._cold = False
            for lf in _iter_leaves(self._root):
                lf.product = self._reach_piece(lf.classes)
                self._count_rebuild()
            self._tail_product = self._eye
            if self._tail_len:
                self._tail_product = self._reach_piece(
                    np.concatenate(self._tail_pieces)
                )
                self._count_rebuild()
            return
        # partial eviction: re-reach only the dropped leaves (internal
        # memos rebuild lazily — one compose each — via _node_product)
        for lf in _iter_leaves(self._root):
            if lf.product is None:
                lf.product = self._reach_piece(lf.classes)
                self._count_rebuild()
