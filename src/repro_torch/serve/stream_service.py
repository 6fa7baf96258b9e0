"""Session-level streaming parse service: many live streams, one engine.

``serve/parse_service.py`` batches *one-shot* texts; this module serves
*streams* — sessions that grow by appends and may ask for their SLPF at any
prefix.  It is the slot pattern a third time: host-side session state, a
small static set of device-program shapes, work admitted the moment it can
join a batch.

  sessions    each owns a ``core/stream.py`` ``StreamingParser`` (its
              persistent chunk-product prefix cache) over ONE shared
              ``ParserEngine`` — every session reuses the same compiled
              phase programs.
  batching    queued appends are split into seal-bounded pieces; ``step``
              picks the piece bucket of the least-virtual-time active
              session (weighted-fair — ``vtime`` advances by absorbed
              chars / the session's ``weight``, so one hot stream cannot
              starve the rest; equal weights degrade to arrival-order
              FIFO) and runs ONE batched reach for every same-bucket
              session's next piece (chunk axis = session axis; pad rows
              are all-PAD → identity products, discarded).  Each product
              then folds into its session's tail with one ``compose``.
  editing     ``edit(sid, lo, hi, replacement)`` splices one session's
              prefix through the parser's product segment tree — O(log n)
              device work, served out-of-band like queries (the session's
              own pending appends drain first so the offsets are stable).
  eviction    a bytes-cached budget over all sessions' device caches; when
              exceeded, tree-node products are dropped cost-aware —
              the nodes covering the MOST characters first (every product
              frees the same bytes — ℓp²·4 f32, or ℓp²/8 under the packed
              backend, whose itemized sizes the byte accounting reflects
              automatically — so the widest node frees the most cache per
              retained parse state; internal nodes cover whole subtrees
              and rebuild with ONE compose, so they rank ahead of leaves),
              least-recently-touched session as tie-break — falling back
              to whole-cache drops (``StreamingParser.drop_cache``) when
              per-node drops alone cannot meet the budget.  The budget loop
              decrements by the bytes each drop REPORTS freed (the first
              drop releases the session's join entries too), so it
              converges even when the budget is smaller than a join cache.
              Classes stay host-side and missing products rebuild
              transparently on next touch (counted per re-reached chunk in
              ``stats["rebuilds"]``), so eviction trades work, never
              correctness.

``stats`` mirrors ``ParseService.stats``: queue depth + per-bucket
served-count/latency aggregates (bucket key = piece chunk length k).

The port's copy of ``repro/serve/stream_service.py``.  A step's batched
reach is one (B_pad, k) grid on the engine's device: on the card, ONE K1 /
K4 / K5 launch for every same-bucket session it serves.  ``mesh=`` builds a
mesh engine: each session's join runs through ``core/distributed.py``, and
admission reads rank 0's observed p99 (``agreed``).

Tracing (the engine's ``obs``): an append's host work is the live
``stream.append_admit`` span of its ``stream.append`` trace; each step is a
``stream.step`` trace of its own, with ``stream.pack`` and ``stream.absorb``
(live) and ``stream.reach`` (the batched reach; on the card a device
interval from CUDA events, emitted at the service's next step, drain or
query, whichever finds it complete).  No span waits for the device.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple, Union

import numpy as np

from ..core.backend import ParserBackend, next_pow2
from ..core.distributed import agreed
from ..core.engine import _resolve_engine
from ..core.slpf import SLPF
from ..core.stream import StreamingParser
from ..errors import AdmissionError, BudgetExceeded, PathologicalPatternError, SessionNotFound
from .parse_service import BucketStats, bucket_stats_dict


@dataclasses.dataclass
class _PendingAppend:
    classes: np.ndarray
    offset: int = 0                      # chars already absorbed
    enqueued_at: float = 0.0
    # tracing: one trace per append request; the pre-minted root span id
    # parents the admission span and the retroactive queue-wait/compute
    # spans (see obs/trace.py); ``began_at`` is the root's start
    trace_id: Optional[str] = None
    root_span_id: Optional[str] = None
    began_at: Optional[float] = None

    @property
    def remaining(self) -> int:
        return len(self.classes) - self.offset


@dataclasses.dataclass
class StreamSession:
    sid: int
    parser: StreamingParser
    pending: Deque[_PendingAppend] = dataclasses.field(default_factory=deque)
    arrival_seq: int = 0                 # tie-break key while active
    last_touch: int = 0                  # LRU key for eviction
    weight: float = 1.0                  # weighted-fair share
    vtime: float = 0.0                   # absorbed chars / weight

    @property
    def pending_chars(self) -> int:
        return sum(p.remaining for p in self.pending)


class StreamService:
    """Bucket-batched scheduler over many ``StreamingParser`` sessions."""

    def __init__(self, *args, **kwargs):
        warnings.warn(
            "repro_torch: constructing StreamService directly is deprecated — "
            "use repro_torch.Parser.open_stream() (repro_torch/api.py); the "
            "facade owns service construction and admission policy",
            DeprecationWarning,
            stacklevel=2,
        )
        self._init(*args, **kwargs)

    @classmethod
    def _internal(cls, *args, **kwargs) -> "StreamService":
        """Facade-owned construction path (no deprecation warning)."""
        self = object.__new__(cls)
        self._init(*args, **kwargs)
        return self

    def _init(
        self,
        matrices_or_engine,
        *,
        backend: Union[str, ParserBackend, None] = None,
        max_batch: int = 8,
        first_seal_len: int = 8,
        max_seal_len: Optional[int] = None,
        cache_budget_bytes: Optional[int] = None,
        max_pending_chars: Optional[int] = None,
        mesh=None,
        mesh_rules=None,
        device=None,
    ):
        self.engine = _resolve_engine(
            matrices_or_engine, backend, mesh, mesh_rules, device=device
        )
        self.max_batch = max(1, max_batch)
        self.first_seal_len = first_seal_len
        self.max_seal_len = max_seal_len
        self.cache_budget_bytes = cache_budget_bytes
        self.max_pending_chars = max_pending_chars

        self._sessions: Dict[int, StreamSession] = {}
        self._next_sid = 0
        self._seq = 0                    # global arrival / touch clock
        self._vclock = 0.0               # vtime of the last scheduled session
        self.batches_run = 0
        self.evictions = 0
        self._peak_queue_depth = 0
        self._buckets: Dict[int, BucketStats] = {}

    def set_pattern_guard(self, verdict: str, mode: str) -> None:
        """Install the static analyzer's verdict on this service's admission
        path: under ``mode="strict"`` a ``pathological`` verdict rejects
        every append with ``PathologicalPatternError`` before anything is
        queued.  The facade wires this from its construction-time analysis
        (``"ok"`` where it made none); directly-assembled services default
        to no guard."""
        self._pattern_guard = (verdict, mode)

    def _check_pattern_guard(self) -> None:
        verdict, mode = getattr(self, "_pattern_guard", ("ok", "off"))
        if mode == "strict" and verdict == "pathological":
            self.engine.obs.metrics.counter(
                "admission_rejects_total", service="stream", cause="pathological"
            ).inc()
            raise PathologicalPatternError(
                "this service's pattern was diagnosed pathologically "
                'ambiguous; analyze="strict" refuses to serve it',
                ambiguity="pathological",
            )

    # ------------------------------------------------------------- sessions

    def open(self, *, weight: float = 1.0) -> int:
        """Open a streaming session; returns its session id.

        ``weight`` is the session's weighted-fair share: its virtual time
        advances by absorbed-chars/weight, so at equal backlog a weight-2
        session is scheduled twice as often as a weight-1 one.
        """
        if weight <= 0:
            raise ValueError(f"session weight must be > 0, got {weight}")
        sid = self._next_sid
        self._next_sid += 1
        self._sessions[sid] = StreamSession(
            sid=sid,
            parser=StreamingParser(
                self.engine,
                first_seal_len=self.first_seal_len,
                max_seal_len=self.max_seal_len,
            ),
            last_touch=self._tick(),
            weight=weight,
            vtime=self._vclock,          # no credit for pre-open idle time
        )
        self.engine.obs.metrics.gauge("stream_sessions").set(len(self._sessions))
        return sid

    def close(self, sid: int) -> None:
        if sid not in self._sessions:
            raise SessionNotFound(sid)
        del self._sessions[sid]
        self.engine.obs.metrics.gauge("stream_sessions").set(len(self._sessions))

    def _tick(self) -> int:
        self._seq += 1
        return self._seq

    def _session(self, sid: int) -> StreamSession:
        try:
            return self._sessions[sid]
        except KeyError:
            raise SessionNotFound(sid) from None

    # --------------------------------------------------------------- append

    def admission_p99_s(self, bucket: int) -> float:
        """Observed p99 append latency of one piece bucket (0.0 when cold —
        same defined cold-start contract as ``ParseService.admission_p99_s``)."""
        stats = self._buckets.get(bucket)
        return stats.latency_quantile_s(99.0) if stats is not None else 0.0

    def append(self, sid: int, text, *, deadline_s: Optional[float] = None) -> int:
        """Queue text onto a session; returns chars queued.  Work happens in
        ``step``/``drain`` so concurrent sessions batch on the device.

        ``deadline_s`` (remaining latency budget) runs deadline-aware
        admission against the next piece's bucket: observed p99 over budget
        (or a blown budget) raises ``AdmissionError`` before anything is
        queued.  ``max_pending_chars`` bounds the cross-session backlog with
        ``BudgetExceeded``.
        """
        obs = self.engine.obs
        # the append's trace: its id, its root's pre-minted id and start
        trace = (None, None, None)
        if obs.enabled:
            trace = (obs.new_trace_id(), obs.tracer._new_span_id(), time.perf_counter())
        queued = 0
        try:
            with obs.span("stream.append_admit", trace_id=trace[0], parent_id=trace[1]):
                queued = self._append(sid, text, deadline_s, trace)
        finally:
            if trace[2] is not None and not queued:
                # nothing queued (an empty or a refused append): its root
                # closes now
                obs.emit("stream.append", t_start_s=trace[2],
                         duration_s=time.perf_counter() - trace[2],
                         trace_id=trace[0], span_id=trace[1], n_chars=0)
        return queued

    def _append(self, sid: int, text, deadline_s: Optional[float], trace: tuple) -> int:
        s = self._session(sid)
        self._check_pattern_guard()
        classes = self.engine.classes_of_text(text)
        obs = self.engine.obs
        m = obs.metrics
        if len(classes):
            if (
                self.max_pending_chars is not None
                and self.pending_chars + len(classes) > self.max_pending_chars
            ):
                m.counter(
                    "admission_rejects_total", service="stream", cause="budget"
                ).inc()
                raise BudgetExceeded(
                    f"append of {len(classes)} chars would exceed the "
                    f"max_pending_chars budget ({self.max_pending_chars}; "
                    f"{self.pending_chars} queued)",
                    budget=self.max_pending_chars,
                    requested=self.pending_chars + len(classes),
                )
            # the admission-relevant device work is the session's NEXT
            # piece — bucket it exactly like the scheduler will
            piece_len = min(s.parser.tail_room(), len(classes))
            bucket = s.parser._bucket_len(piece_len)
            if deadline_s is not None:
                predicted = agreed(self.engine, self.admission_p99_s(bucket))
                if deadline_s <= 0.0 or predicted > deadline_s:
                    m.counter(
                        "admission_rejects_total", service="stream",
                        cause="deadline",
                    ).inc()
                    raise AdmissionError(
                        f"stream bucket {bucket} p99 {predicted * 1e3:.1f}ms "
                        f"exceeds the remaining deadline {deadline_s * 1e3:.1f}ms",
                        bucket=bucket,
                        deadline_s=deadline_s,
                        predicted_s=predicted,
                    )
            # the bucket is observable (served=0, queue_depth>0) from this
            # moment — deadline or not (same cold-start contract as
            # ParseService.submit_request)
            self._buckets.setdefault(bucket, BucketStats())
            if not s.pending:
                s.arrival_seq = self._tick()
                # WFQ activation floor: a session waking from idle resumes
                # at the scheduler's clock — idle time banks no credit
                s.vtime = max(s.vtime, self._vclock)
            p = _PendingAppend(classes=classes, enqueued_at=time.perf_counter(),
                               trace_id=trace[0], root_span_id=trace[1], began_at=trace[2])
            s.pending.append(p)
            s.last_touch = self._tick()
            m.counter("appends_total", service="stream").inc()
            m.counter("chars_total", service="stream").inc(len(classes))
            m.gauge("queue_depth", service="stream").set(self.pending_appends)
        self._peak_queue_depth = max(self._peak_queue_depth, self.pending_appends)
        m.gauge("peak_queue_depth", service="stream").set(self._peak_queue_depth)
        return len(classes)

    def _next_piece_len(self, s: StreamSession) -> int:
        return min(s.parser.tail_room(), s.pending[0].remaining)

    def _piece_bucket(self, s: StreamSession) -> int:
        # the parser's own bucketing, so the batched reach grid hits exactly
        # the shapes a solo append would compile
        return s.parser._bucket_len(self._next_piece_len(s))

    def _take_piece(
        self, s: StreamSession, m: int
    ) -> Tuple[np.ndarray, Optional[_PendingAppend]]:
        """Consume m chars from the head pending append; returns (classes,
        the append record if this piece completed it)."""
        head = s.pending[0]
        piece = head.classes[head.offset : head.offset + m]
        head.offset += m
        completed = None
        if head.remaining == 0:
            completed = head
            s.pending.popleft()
        return piece, completed

    def _finish_append(
        self,
        p: _PendingAppend,
        bucket: int,
        picked_at: float,
        now: float,
        *,
        batch_size: int,
    ) -> None:
        """Latency bookkeeping + retroactive spans for one completed append.

        ``now`` is the end of the host's work for the append: its
        ``stream.append_compute`` span runs from pickup to there and leaves
        out the device's run of the step's reach, which may still be going.
        """
        stats = self._buckets.setdefault(bucket, BucketStats())
        stats.record(
            now - p.enqueued_at,
            queue_s=picked_at - p.enqueued_at,
            compute_s=now - picked_at,
        )
        obs = self.engine.obs
        obs.metrics.counter("served_total", service="stream").inc()
        if p.trace_id is None:
            return
        obs.emit(
            "stream.append",
            t_start_s=p.began_at,
            duration_s=now - p.began_at,
            trace_id=p.trace_id,
            span_id=p.root_span_id,
            n_chars=len(p.classes),
        )
        obs.emit(
            "stream.append_queue_wait",
            t_start_s=p.enqueued_at,
            duration_s=picked_at - p.enqueued_at,
            trace_id=p.trace_id,
            parent_id=p.root_span_id,
            bucket=bucket,
        )
        obs.emit(
            "stream.append_compute",
            t_start_s=picked_at,
            duration_s=now - picked_at,
            trace_id=p.trace_id,
            parent_id=p.root_span_id,
            bucket=bucket,
            batch_size=batch_size,
        )

    # ---------------------------------------------------------------- serving

    def step(self) -> bool:
        """Absorb one piece-batch; False when idle.

        The batch head is the least-virtual-time active session (weighted
        fair; arrival order breaks ties, so equal weights are plain FIFO);
        the rest of the batch fills with same-bucket sessions in arrival
        order — riders share the head's reach program and each charges its
        own vtime.  One batched reach serves every selected session's next
        piece; the per-session compose/seal bookkeeping is O(1) device work
        each.
        """
        obs = self.engine.obs
        device = self.engine.device
        obs.settle(device)
        active = sorted(
            (s for s in self._sessions.values() if s.pending),
            key=lambda s: s.arrival_seq,
        )
        if not active:
            return False
        head = min(active, key=lambda s: (s.vtime, s.arrival_seq))
        self._vclock = head.vtime
        bucket = self._piece_bucket(head)
        batch: List[StreamSession] = [head]
        for s in active:
            if len(batch) == self.max_batch:
                break
            if s is not head and self._piece_bucket(s) == bucket:
                batch.append(s)

        with obs.span("stream.step", trace_id=obs.new_trace_id(), bucket=bucket,
                      sessions=len(batch)) as sp:
            # One (B_pad, k) reach across sessions: chunk axis = session axis.
            pieces: List[np.ndarray] = []
            finished: List[Optional[_PendingAppend]] = []
            picked_at = time.perf_counter()
            for s in batch:
                piece, done = self._take_piece(s, self._next_piece_len(s))
                pieces.append(piece)
                finished.append(done)
            with obs.span("stream.pack", bucket=bucket):
                B_pad = next_pow2(len(batch))
                grid = np.full((B_pad, bucket), self.engine.tables.pad_class, dtype=np.int32)
                for row, piece in enumerate(pieces):
                    grid[row, : len(piece)] = piece
                chunks = self.engine.chunks_tensor(grid)
            with obs.phase(device, "stream.reach", bucket=bucket):
                products = self.engine.phases.reach(self.engine.tables.N, chunks)

            stats = self._buckets.setdefault(bucket, BucketStats())
            seals = 0
            with obs.span("stream.absorb"):
                for row, s in enumerate(batch):
                    seals += len(pieces[row]) == s.parser.tail_room()
                    s.parser.absorb_product(pieces[row], products[row])
                    s.last_touch = self._tick()
                    s.vtime += len(pieces[row]) / s.weight
                    if s.pending:
                        s.arrival_seq = self._tick()   # requeue behind current arrivals
            timer = obs.device_timer(device)
            if timer is not None:
                timer.record()   # the step's last device work: an anchor waits for it
            if obs.enabled:
                sp.set_attr("pieces", len(pieces))
                sp.set_attr("chars", sum(len(p) for p in pieces))
                sp.set_attr("composes", len(pieces))
                sp.set_attr("seals", seals)
            now = time.perf_counter()
            for done in finished:
                if done is not None:
                    self._finish_append(
                        done, bucket, picked_at, now, batch_size=len(batch)
                    )
            stats.batches += 1
            self.batches_run += 1
            m = obs.metrics
            m.counter("batches_total", service="stream").inc()
            m.gauge("queue_depth", service="stream").set(self.pending_appends)
            self._maybe_evict()
        return True

    def drain(self) -> None:
        """Absorb every queued append across all sessions."""
        while self.step():
            pass

    def _drain_session(self, s: StreamSession) -> None:
        """Absorb ONE session's pending appends (unbatched reach per piece) —
        a query's latency must not scale with other sessions' backlogs."""
        self.engine.obs.settle(self.engine.device)
        while s.pending:
            picked_at = time.perf_counter()
            piece, done = self._take_piece(s, self._next_piece_len(s))
            bucket = s.parser._bucket_len(len(piece))
            s.parser.absorb_product(piece, s.parser._reach_piece(piece))
            s.vtime += len(piece) / s.weight   # out-of-band work still charges
            if done is not None:
                self._finish_append(
                    done, bucket, picked_at, time.perf_counter(), batch_size=1
                )
        self.engine.obs.metrics.gauge("queue_depth", service="stream").set(
            self.pending_appends
        )

    # ----------------------------------------------------------------- query

    def slpf(self, sid: int) -> SLPF:
        """Current SLPF of one session's full prefix (drains ITS pending)."""
        s = self._session(sid)
        self._drain_session(s)
        s.last_touch = self._tick()
        out = s.parser.current_slpf()
        self._maybe_evict()
        return out

    def accepted(self, sid: int) -> bool:
        s = self._session(sid)
        self._drain_session(s)
        s.last_touch = self._tick()
        return s.parser.accepted

    def edit(self, sid: int, lo: int, hi: int, replacement) -> int:
        """Splice one session's prefix: replace chars [lo, hi) with
        ``replacement``; returns the new prefix length.

        Pending appends drain first (the edit addresses the post-append
        prefix), then the parser's segment tree re-composes one leaf-to-root
        path — O(log n) device work, unbatched like the other queries.
        """
        s = self._session(sid)
        self._drain_session(s)
        s.last_touch = self._tick()
        n = s.parser.edit(lo, hi, replacement)
        self._maybe_evict()
        return n

    # -------------------------------------------------------------- eviction

    @property
    def bytes_cached(self) -> int:
        return sum(s.parser.cache_nbytes for s in self._sessions.values())

    def _maybe_evict(self) -> None:
        """Cost-aware eviction until under the bytes budget.

        Every node product costs the same device bytes (the engine
        backend's product size — f32 matrix or packed words), so ranking
        is purely by recompute economics: drop the products covering the
        MOST characters first (internal tree nodes rank ahead of leaves —
        they span whole subtrees and rebuild with ONE compose; among leaves
        the largest chunk is the cheapest per covered byte to re-reach),
        with least-recently-touched session as the tie-break.  The loop
        decrements the running total by what each drop REPORTS freed —
        ``drop_sealed_product`` releases the session's join entries with
        the first drop, so every byte ``cache_nbytes`` counts is actually
        reclaimable and the loop converges instead of spinning over budget.
        When per-node drops alone cannot reach the budget, fall back to
        whole-cache LRU drops (frees tail products too).  The most recently
        touched session is never evicted.
        """
        m = self.engine.obs.metrics
        if self.cache_budget_bytes is None:
            return
        total = self.bytes_cached       # summed once; decremented per evict
        m.gauge("stream_bytes_cached").set(total)
        if total <= self.cache_budget_bytes:
            return
        by_lru = sorted(self._sessions.values(), key=lambda s: s.last_touch)
        victims = by_lru[:-1]            # never evict the most recent session
        candidates = [                   # (-covered_chars, lru_rank, key, ...)
            (-chars, rank, key, s)
            for rank, s in enumerate(victims)
            for key, chars, _ in s.parser.sealed_cache_entries()
        ]
        candidates.sort(key=lambda cand: cand[:3])
        for _, _, key, s in candidates:
            if total <= self.cache_budget_bytes:
                m.gauge("stream_bytes_cached").set(total)
                return
            freed = s.parser.drop_sealed_product(key)
            if freed:
                total -= freed
                self._count_eviction(freed)
        for s in victims:                # fallback: whole-cache LRU drops
            if total <= self.cache_budget_bytes:
                break
            freed = s.parser.cache_nbytes
            if freed == 0:
                continue
            s.parser.drop_cache()
            total -= freed
            self._count_eviction(freed)
        m.gauge("stream_bytes_cached").set(total)

    def _count_eviction(self, freed_bytes: int) -> None:
        self.evictions += 1
        m = self.engine.obs.metrics
        m.counter("stream_evictions_total").inc()
        m.counter("stream_bytes_reclaimed_total").inc(freed_bytes)

    # ------------------------------------------------------------------ stats

    @property
    def pending_chars(self) -> int:
        return sum(s.pending_chars for s in self._sessions.values())

    @property
    def pending_appends(self) -> int:
        """Queued append requests not yet fully absorbed (request units —
        comparable with ``ParseService``'s queue depth)."""
        return sum(len(s.pending) for s in self._sessions.values())

    @property
    def compile_count(self) -> int:
        return self.engine.compile_count

    @property
    def stats(self) -> Dict:
        """Same shape and units as ``ParseService.stats`` — ``pending`` and
        ``peak_queue_depth`` count append *requests* (bucket key = piece
        length k) — plus cache/eviction observables for the bytes budget
        (``pending_chars`` carries the char-level backlog)."""
        depth: Dict[int, int] = {}
        for s in self._sessions.values():
            if s.pending:
                b = self._piece_bucket(s)
                depth[b] = depth.get(b, 0) + len(s.pending)
        return {
            "backend": self.engine.backend.name,
            "sessions": len(self._sessions),
            "pending": self.pending_appends,
            "pending_chars": self.pending_chars,
            "peak_queue_depth": self._peak_queue_depth,
            "batches_run": self.batches_run,
            "compile_count": self.compile_count,
            "bytes_cached": self.bytes_cached,
            "evictions": self.evictions,
            "rebuilds": sum(s.parser.rebuilds for s in self._sessions.values()),
            "edits": sum(s.parser.edits for s in self._sessions.values()),
            "buckets": bucket_stats_dict(self._buckets, depth),
        }
