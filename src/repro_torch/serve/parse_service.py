"""Request-level batched parsing service over the shape-bucketed engine.

The LM side of this repo serves generation through ``serve/scheduler.py``'s
slot pattern: a fixed set of device-program shapes, host-side request state,
admission the moment capacity frees.  This module is the same pattern for the
*parser*: callers submit texts of arbitrary length; the service groups queued
requests by their static (c, k) chunk bucket, packs up to ``max_batch`` of
them into one batched device program (extra batch slots ride along as all-PAD
rows), and drains bucket by bucket.  Because every program shape comes from
the engine's small bucket set, steady-state serving never recompiles —
``compile_count`` makes that observable.

Scheduling policy — weighted-fair across tenants, FIFO within one: every
request belongs to a *tenant* (a traffic class with a ``weight``; the
implicit ``"default"`` tenant makes the single-tenant service exactly the
old FIFO).  Each ``step`` picks the active tenant with the least virtual
time (``vtime``, advanced by served-chars/weight — classic WFQ), takes that
tenant's oldest request as the batch head, and fills the rest of the batch
with same-bucket requests in global FIFO order from ANY tenant (riders are
free: they share the head's device program, and each charges its own
tenant).  A hot tenant's vtime races ahead, so a light tenant's next request
is picked as soon as it arrives — no starvation — while newly-active tenants
are floored to the scheduler's clock so idle time banks no credit.

Instrumentation (``ParseService.stats``): queue depth (current and peak),
per-bucket served-count / queue-depth / latency aggregates including p50/p99
over a sliding sample window, and per-tenant aggregates (weight, vtime,
pending, served, latency percentiles, cancels, rejects) under ``"tenants"``.
A bucket appears in ``stats`` from the moment a request maps to it at submit
— before the first serve — with ``served=0`` and its live ``queue_depth``,
so the deadline-admission policy below has a defined cold-start observable.
``serve/stream_service.py`` exposes the same stats shape for streaming
sessions.

Admission (the ROADMAP SLO item): ``submit(text, deadline=...)`` rejects a
request with ``repro_torch.errors.AdmissionError`` when its bucket's observed p99
latency already exceeds the remaining deadline (a cold bucket predicts 0.0
and admits); ``max_pending`` bounds the whole queue and a tenant's own
``max_pending`` bounds its share, both with ``repro_torch.errors.BudgetExceeded``.
Policy knobs (per-bucket latency targets, default deadlines, tenant weights)
live in ``repro_torch/api.py``'s ``ParserConfig`` — the facade is the
supported construction path; building ``ParseService`` directly is
deprecated.

Cancellation: ``cancel(rid)`` marks the request (O(1)) and the scheduler
purges marked rows *before packing a batch* — a cancelled request never
occupies a batch slot and never records a latency sample, even when the
cancel lands after the scheduler has already chosen its bucket.

Backends: ``ParseService(..., backend=..., device=...)`` plumbs straight
to the engine (``cuda`` on the card by default); ``stats["backend"]``
reports which one is live.

The port's copy of ``repro/serve/parse_service.py``.  ``mesh=`` builds a
mesh engine (``core/distributed.py``); every rank then queues and serves
alike, and admission reads rank 0's observed p99 (``agreed``), so that all
ranks admit or reject together.  ``FleetParseService`` is the same scheduler over
a multi-automaton ``core/fleet.py`` ``FleetEngine``, through the
``_classes_and_bucket`` / ``_execute`` / ``_bucket_of`` / ``_auto_tenants``
seams.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from collections import deque
from typing import Deque, Dict, Hashable, List, Optional, Tuple, Union

import numpy as np

from ..core.backend import ParserBackend
from ..core.distributed import agreed
from ..core.engine import _resolve_engine
from ..core.slpf import SLPF
from ..errors import AdmissionError, BudgetExceeded, PathologicalPatternError

# Per-bucket latency sample window for the p50/p99 estimates: percentiles are
# exact over the most recent LATENCY_WINDOW served requests (a sorted-window
# estimator — O(window) memory per bucket, robust to traffic drift, unlike a
# lossy fixed-size reservoir over all time).
LATENCY_WINDOW = 512


def _window_quantile(window: Deque[float], q: float) -> float:
    if not window:
        return 0.0
    # nearest-rank (no interpolation): an SLO predictor must report a latency
    # that was actually observed — interpolating between the two top samples
    # under-reports p99 on small windows (a 2-sample window's p99 would fall
    # just below its own slowest sample)
    return float(
        np.percentile(np.fromiter(window, dtype=float), q, method="higher")
    )


@dataclasses.dataclass
class BucketStats:
    """Served-count / latency aggregates for one device-program bucket.

    Three separate sliding windows: end-to-end latency (the admission
    predictor), queue wait (submit → batch pickup) and batch compute (the
    device program) — previously one window conflated wait with compute, so
    a deep queue read as a slow device.  Each window wraps independently at
    ``LATENCY_WINDOW`` samples and reports its own p50/p99.
    """

    served: int = 0
    batches: int = 0
    total_latency_s: float = 0.0
    max_latency_s: float = 0.0
    window: Deque[float] = dataclasses.field(
        default_factory=lambda: deque(maxlen=LATENCY_WINDOW)
    )
    queue_window: Deque[float] = dataclasses.field(
        default_factory=lambda: deque(maxlen=LATENCY_WINDOW)
    )
    compute_window: Deque[float] = dataclasses.field(
        default_factory=lambda: deque(maxlen=LATENCY_WINDOW)
    )

    def record(
        self,
        latency_s: float,
        queue_s: Optional[float] = None,
        compute_s: Optional[float] = None,
    ) -> None:
        self.served += 1
        self.total_latency_s += latency_s
        self.max_latency_s = max(self.max_latency_s, latency_s)
        self.window.append(latency_s)
        if queue_s is not None:
            self.queue_window.append(queue_s)
        if compute_s is not None:
            self.compute_window.append(compute_s)

    @property
    def mean_latency_s(self) -> float:
        return self.total_latency_s / self.served if self.served else 0.0

    def latency_quantile_s(self, q: float) -> float:
        """Latency quantile (q in [0,100]) over the recent sample window."""
        return _window_quantile(self.window, q)

    def as_dict(self) -> Dict[str, float]:
        return {
            "served": self.served,
            "batches": self.batches,
            "mean_latency_s": self.mean_latency_s,
            "p50_latency_s": self.latency_quantile_s(50.0),
            "p99_latency_s": self.latency_quantile_s(99.0),
            "max_latency_s": self.max_latency_s,
            "p50_queue_s": _window_quantile(self.queue_window, 50.0),
            "p99_queue_s": _window_quantile(self.queue_window, 99.0),
            "p50_compute_s": _window_quantile(self.compute_window, 50.0),
            "p99_compute_s": _window_quantile(self.compute_window, 99.0),
        }


def bucket_stats_dict(
    buckets: Dict[Hashable, BucketStats],
    queue_depth: Optional[Dict[Hashable, int]] = None,
) -> Dict[Hashable, Dict[str, float]]:
    """Per-bucket stat dicts, each carrying its live ``queue_depth``.

    Buckets with no queued work report ``queue_depth`` 0 (they are NOT
    omitted): a bucket enters the map at submit time, so admission and SLO
    policy always see a defined entry — including before the first serve.
    """
    depth = queue_depth or {}
    out = {}
    for b, s in sorted(buckets.items()):
        d = s.as_dict()
        d["queue_depth"] = depth.get(b, 0)
        out[b] = d
    return out


@dataclasses.dataclass
class TenantState:
    """Host-side scheduling + SLO state of one traffic class.

    ``vtime`` is the tenant's weighted-fair virtual time: it advances by
    served-characters / ``weight`` whenever one of the tenant's requests is
    served, so at equal demand a weight-2 tenant is scheduled twice as often
    as a weight-1 one.  ``stats`` reuses ``BucketStats`` — the same latency
    windows that drive per-bucket admission give per-tenant SLO grades.
    """

    name: str
    weight: float = 1.0
    max_pending: Optional[int] = None
    vtime: float = 0.0
    pending: int = 0
    cancelled: int = 0
    rejects: int = 0
    stats: BucketStats = dataclasses.field(default_factory=BucketStats)

    def as_dict(self) -> Dict[str, float]:
        d = self.stats.as_dict()
        d.update(
            weight=self.weight,
            vtime=self.vtime,
            pending=self.pending,
            cancelled=self.cancelled,
            rejects=self.rejects,
        )
        return d


@dataclasses.dataclass
class ParseRequest:
    rid: int
    text: Union[bytes, str]
    tenant: str = "default"
    # cached at submit so scheduling never re-tokenizes or re-buckets queued
    # texts (bucket_shape is pure in (len, n_chunks) — computing it per step
    # was O(queue) redundant work per batch):
    classes: Optional[np.ndarray] = None
    bucket: Optional[Hashable] = None
    submitted_at: float = dataclasses.field(default_factory=time.perf_counter)
    # cancellation is a flag, not a queue removal: the scheduler purges
    # flagged rows before packing, so a cancel landing after batch selection
    # still never burns a batch slot nor records a latency sample
    cancelled: bool = False
    # tracing: minted at submit when the engine's tracer is enabled; the
    # root span id lets retroactive queue-wait/compute spans parent to the
    # ``parse.request`` root the ticket emits at collection.  ``began_at``
    # is that root's start (before planning); None where the caller holds
    # the root open as a live span (``Parser.parse``) and the ticket emits
    # none
    trace_id: Optional[str] = None
    root_span_id: Optional[str] = None
    began_at: Optional[float] = None
    # filled by the service:
    slpf: Optional[SLPF] = None
    latency_s: Optional[float] = None
    queue_s: Optional[float] = None
    compute_s: Optional[float] = None

    @property
    def done(self) -> bool:
        return self.slpf is not None


class ParseService:
    """Bucket-batched, weighted-fair request scheduler over
    ``ParserEngine.parse_batch``."""

    # the single-engine service auto-registers a tenant on first use so
    # plain ``submit(text)`` keeps working; a fleet service turns this off —
    # an unknown tenant has no automaton to parse with
    _auto_tenants = True

    def __init__(self, *args, **kwargs):
        warnings.warn(
            "repro_torch: constructing ParseService directly is deprecated — "
            "use repro_torch.Parser (repro_torch/api.py): parser.submit()/"
            "parse_batch() own service construction and admission policy",
            DeprecationWarning,
            stacklevel=2,
        )
        self._init(*args, **kwargs)

    @classmethod
    def _internal(cls, *args, **kwargs) -> "ParseService":
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
        n_chunks: int = 8,
        max_pending: Optional[int] = None,
        mesh=None,
        mesh_rules=None,
        device=None,
    ):
        self.engine = _resolve_engine(
            matrices_or_engine, backend, mesh, mesh_rules, device=device
        )
        self.max_batch = max(1, max_batch)
        self.n_chunks = n_chunks
        self.max_pending = max_pending
        self._init_queue_state()

    def set_pattern_guard(self, verdict: str, mode: str) -> None:
        """Install the static analyzer's verdict on this service's admission
        path: under ``mode="strict"`` a ``pathological`` verdict rejects
        every request with ``PathologicalPatternError`` before any queueing.
        The facade wires this from its construction-time analysis (``"ok"``
        where it made none); directly-assembled services default to no
        guard."""
        self._pattern_guard = (verdict, mode)

    def _check_pattern_guard(self) -> None:
        verdict, mode = getattr(self, "_pattern_guard", ("ok", "off"))
        if mode == "strict" and verdict == "pathological":
            self.engine.obs.metrics.counter(
                "admission_rejects_total", service="parse", cause="pathological"
            ).inc()
            raise PathologicalPatternError(
                "this service's pattern was diagnosed pathologically "
                'ambiguous; analyze="strict" refuses to serve it',
                ambiguity="pathological",
            )

    def _init_queue_state(self) -> None:
        self._queue: Deque[ParseRequest] = deque()
        self._by_rid: Dict[int, ParseRequest] = {}
        self._n_pending = 0
        self._done: List[ParseRequest] = []
        self._next_rid = 0
        self.batches_run = 0
        self._peak_queue_depth = 0
        self._buckets: Dict[Hashable, BucketStats] = {}
        self._tenants: Dict[str, TenantState] = {}
        self._vclock = 0.0  # vtime of the most recently scheduled tenant
        # hot-path metric handles: registry get-or-create hashes the label
        # set on every call, which shows up at fleet request rates
        m = self.engine.obs.metrics
        self._m_requests_total = m.counter("requests_total", service="parse")
        self._m_chars_total = m.counter("chars_total", service="parse")
        self._m_served_total = m.counter("served_total", service="parse")
        self._m_batches_total = m.counter("batches_total", service="parse")
        self._m_queue_depth = m.gauge("queue_depth", service="parse")
        self._m_peak_queue_depth = m.gauge(
            "peak_queue_depth", service="parse"
        )

    # -------------------------------------------------------------- tenants

    def register_tenant(
        self,
        name: str,
        *,
        weight: float = 1.0,
        max_pending: Optional[int] = None,
    ) -> TenantState:
        """Declare a traffic class.  ``weight`` sets its fair share of
        scheduling (chars served per unit of virtual time); ``max_pending``
        caps ITS queue residency independently of the service-wide cap."""
        if weight <= 0:
            raise ValueError(f"tenant weight must be > 0, got {weight}")
        ts = self._tenants.get(name)
        if ts is None:
            ts = TenantState(name=name, weight=weight, max_pending=max_pending)
            # late arrivals start at the scheduler's clock, not at 0: an
            # idle past must not bank scheduling credit
            ts.vtime = self._vclock
            self._tenants[name] = ts
        else:
            ts.weight = weight
            ts.max_pending = max_pending
        return ts

    def _tenant(self, name: str) -> TenantState:
        ts = self._tenants.get(name)
        if ts is None:
            if not self._auto_tenants:
                raise KeyError(f"unknown tenant {name!r}")
            ts = self.register_tenant(name)
        return ts

    # ------------------------------------------------------------- admission

    def admission_p99_s(self, bucket: Hashable) -> float:
        """Observed p99 latency of one bucket — the admission predictor.

        Defined for EVERY bucket, including one no request has mapped to
        yet: a cold bucket has an empty sample window and predicts 0.0
        (optimistic — the first request is always admitted and its latency
        seeds the window).
        """
        stats = self._buckets.get(bucket)
        return stats.latency_quantile_s(99.0) if stats is not None else 0.0

    def _admit(
        self,
        bucket: Hashable,
        deadline_s: Optional[float],
        tenant: Optional[TenantState] = None,
    ) -> None:
        """Deadline-aware admission: reject work predicted to miss its deadline.

        ``deadline_s`` is the request's REMAINING latency budget in seconds.
        The predictor is the bucket's observed p99 over the sliding window —
        if p99 already exceeds the budget (or the budget is already blown),
        serving the request would almost surely miss, so it is rejected
        up-front with ``AdmissionError`` instead of wasting a batch slot.
        A tenant's own ``max_pending`` budget is enforced first: one tenant
        flooding the queue bounces off its own cap, not the shared one.
        """
        self._check_pattern_guard()
        m = self.engine.obs.metrics
        if self.max_pending is not None and self._n_pending >= self.max_pending:
            m.counter(
                "admission_rejects_total", service="parse", cause="budget"
            ).inc()
            if tenant is not None:
                tenant.rejects += 1
            raise BudgetExceeded(
                f"parse queue is at its max_pending budget ({self.max_pending})",
                budget=self.max_pending,
                requested=self._n_pending + 1,
            )
        if (
            tenant is not None
            and tenant.max_pending is not None
            and tenant.pending >= tenant.max_pending
        ):
            m.counter(
                "admission_rejects_total", service="parse", cause="tenant_budget"
            ).inc()
            tenant.rejects += 1
            raise BudgetExceeded(
                f"tenant {tenant.name!r} is at its max_pending budget "
                f"({tenant.max_pending})",
                budget=tenant.max_pending,
                requested=tenant.pending + 1,
            )
        if deadline_s is None:
            return
        predicted = agreed(self.engine, self.admission_p99_s(bucket))
        if deadline_s <= 0.0 or predicted > deadline_s:
            m.counter(
                "admission_rejects_total", service="parse", cause="deadline"
            ).inc()
            if tenant is not None:
                tenant.rejects += 1
            raise AdmissionError(
                f"bucket {bucket} p99 {predicted * 1e3:.1f}ms exceeds the "
                f"remaining deadline {deadline_s * 1e3:.1f}ms",
                bucket=bucket,
                deadline_s=deadline_s,
                predicted_s=predicted,
            )

    # -------------------------------------------------------------- planning

    def _classes_and_bucket(
        self, text: Union[bytes, str], tenant: str
    ) -> Tuple[np.ndarray, Hashable]:
        """Submit-time planning seam: (class array, batching bucket).

        The base service has one automaton, so the tenant only matters for
        scheduling; a fleet service would route through the tenant's own
        tables and automaton bucket here.
        """
        classes = self.engine.classes_of_text(text)
        return classes, self.engine.bucket_shape(len(classes), self.n_chunks)

    def submit_request(
        self,
        text: Union[bytes, str],
        *,
        deadline_s: Optional[float] = None,
        tenant: str = "default",
        root=None,
    ) -> ParseRequest:
        """Enqueue a text; returns its (live) request record.

        With ``deadline_s`` the request passes deadline-aware admission
        first and may raise ``AdmissionError``/``BudgetExceeded``; the
        returned object's ``slpf``/``latency_s`` fields fill in place when a
        ``step`` serves its bucket.  With tracing on, planning and
        admission are the ``parse.plan`` / ``parse.admit`` spans of the
        request's trace; ``root`` is a live ``parse.request`` span the
        caller holds open (``Parser.parse``), else the ticket emits the
        root at collection (a refused request's root is emitted here).
        """
        ts = self._tenant(tenant)
        obs = self.engine.obs
        trace_id = root_id = began_at = None
        if obs.enabled:
            if root is None:
                trace_id, root_id = obs.new_trace_id(), obs.tracer._new_span_id()
                began_at = time.perf_counter()
            else:
                trace_id, root_id = root.trace_id, root.span_id
        try:
            with obs.span("parse.plan", trace_id=trace_id, parent_id=root_id) as sp:
                classes, bucket = self._classes_and_bucket(text, tenant)
                sp.set_attr("n_chars", len(classes))
            with obs.span("parse.admit", trace_id=trace_id, parent_id=root_id,
                          bucket=list(bucket)):
                self._admit(bucket, deadline_s, tenant=ts)
        except Exception as e:
            if began_at is not None:
                obs.emit("parse.request", t_start_s=began_at,
                         duration_s=time.perf_counter() - began_at, trace_id=trace_id,
                         span_id=root_id, refused=type(e).__name__)
            raise
        # the bucket is observable (served=0, queue_depth>0) from this moment
        self._buckets.setdefault(bucket, BucketStats())
        req = ParseRequest(
            rid=self._next_rid,
            text=text,
            tenant=tenant,
            classes=classes,
            bucket=bucket,
            submitted_at=time.perf_counter(),
            trace_id=trace_id,
            root_span_id=root_id,
            began_at=began_at,
        )
        self._next_rid += 1
        if ts.pending == 0:
            # WFQ activation floor: a tenant waking from idle resumes at the
            # scheduler's clock (idle time banks no credit), but keeps its
            # own vtime if it is already ahead
            ts.vtime = max(ts.vtime, self._vclock)
        ts.pending += 1
        self._queue.append(req)
        self._by_rid[req.rid] = req
        self._n_pending += 1
        self._peak_queue_depth = max(self._peak_queue_depth, self._n_pending)
        self._m_requests_total.inc()
        self._m_chars_total.inc(len(classes))
        self._m_queue_depth.set(self._n_pending)
        self._m_peak_queue_depth.set(self._peak_queue_depth)
        return req

    def submit(
        self,
        text: Union[bytes, str],
        *,
        deadline_s: Optional[float] = None,
        tenant: str = "default",
    ) -> int:
        """Enqueue a text; returns its request id (see ``submit_request``)."""
        return self.submit_request(text, deadline_s=deadline_s, tenant=tenant).rid

    def cancel(self, rid: int) -> bool:
        """Cancel a not-yet-served request; False if already served (or
        unknown — a served rid may have been reaped).

        O(1): the request is flagged, not searched out of the queue; the
        scheduler skips flagged rows before packing any batch, so the
        request is guaranteed to never occupy a batch slot nor record a
        latency sample — even when this call lands after the scheduler has
        already selected the request's bucket for the next batch.
        """
        req = self._by_rid.pop(rid, None)
        if req is None or req.done:
            return False
        req.cancelled = True
        ts = self._tenants.get(req.tenant)
        if ts is not None:
            ts.pending -= 1
            ts.cancelled += 1
        self._n_pending -= 1
        m = self.engine.obs.metrics
        m.counter("cancelled_total", service="parse").inc()
        m.gauge("queue_depth", service="parse").set(self._n_pending)
        return True

    def _bucket_of(self, req: ParseRequest) -> Hashable:
        if req.bucket is None:  # externally-constructed request
            req.bucket = self.engine.bucket_shape(len(req.classes), self.n_chunks)
        return req.bucket

    # ---------------------------------------------------------------- serving

    def _execute(self, bucket: Hashable, batch: List[ParseRequest]) -> List[SLPF]:
        """Device-dispatch seam: parse one same-bucket batch.

        A fleet service would run the bucket's tenant-batched program here.
        """
        return self.engine.parse_batch(
            [req.classes for req in batch], n_chunks=self.n_chunks
        )

    def _pick_tenant(self) -> TenantState:
        """Weighted-fair pick: the active tenant with the least virtual time
        (name-ordered tie-break keeps the choice deterministic)."""
        return min(
            (ts for ts in self._tenants.values() if ts.pending > 0),
            key=lambda ts: (ts.vtime, ts.name),
        )

    def step(self) -> bool:
        """Serve one batch; False when idle.

        The batch head is the oldest request of the least-vtime active
        tenant (weighted-fair); the rest of the batch fills with same-bucket
        requests in global FIFO order from any tenant — riders share the
        head's device program and each charges its own tenant's vtime.
        Cancelled rows are purged here, before packing: they never reach a
        batch slot.
        """
        if self._n_pending == 0:
            # any residue is cancelled rows awaiting lazy purge
            self._queue.clear()
            return False
        picked = self._pick_tenant()
        self._vclock = picked.vtime
        # the picked tenant's oldest live request anchors the batch: its
        # bucket decides which device program runs
        head = next(
            req
            for req in self._queue
            if not req.cancelled and req.tenant == picked.name
        )
        head_bucket = self._bucket_of(head)
        batch: List[ParseRequest] = []
        keep: Deque[ParseRequest] = deque()
        head_seen = False
        # one FIFO pass: drop cancelled rows, pack the head plus same-bucket
        # riders from ANY queue position — riders queued ahead of the head
        # ride too (one slot stays reserved so they cannot crowd it out)
        for req in self._queue:
            if req.cancelled:
                continue
            if req is head:
                batch.append(req)
                head_seen = True
            elif (
                len(batch) + (0 if head_seen else 1) < self.max_batch
                and self._bucket_of(req) == head_bucket
            ):
                batch.append(req)
            else:
                keep.append(req)
        self._queue = keep

        picked_at = time.perf_counter()
        obs = self.engine.obs
        # the batch's device program runs in its head request's trace
        with obs.span("parse.batch_compute", trace_id=head.trace_id,
                      parent_id=head.root_span_id, bucket=list(head_bucket),
                      batch_size=len(batch), tenant=head.tenant):
            slpfs = self._execute(head_bucket, batch)
        now = time.perf_counter()
        compute_s = now - picked_at
        stats = self._buckets.setdefault(head_bucket, BucketStats())
        for req, slpf in zip(batch, slpfs):
            req.slpf = slpf
            req.latency_s = now - req.submitted_at
            req.queue_s = picked_at - req.submitted_at
            req.compute_s = compute_s
            stats.record(req.latency_s, queue_s=req.queue_s, compute_s=compute_s)
            ts = self._tenants.get(req.tenant)
            if ts is not None:
                ts.pending -= 1
                ts.vtime += len(req.classes) / ts.weight
                ts.stats.record(
                    req.latency_s, queue_s=req.queue_s, compute_s=compute_s
                )
            self._by_rid.pop(req.rid, None)
            self._n_pending -= 1
            if req.trace_id is not None:
                # queue residency is only known at pickup: retroactive spans
                obs.emit(
                    "parse.queue_wait",
                    t_start_s=req.submitted_at,
                    duration_s=req.queue_s,
                    trace_id=req.trace_id,
                    parent_id=req.root_span_id,
                    bucket=list(head_bucket),
                    tenant=req.tenant,
                )
                if req is not head:
                    # a rider's share of the head's live span
                    obs.emit(
                        "parse.batch_compute",
                        t_start_s=picked_at,
                        duration_s=compute_s,
                        trace_id=req.trace_id,
                        parent_id=req.root_span_id,
                        bucket=list(head_bucket),
                        batch_size=len(batch),
                        tenant=req.tenant,
                        batch_trace_id=head.trace_id,
                    )
            self._done.append(req)
        stats.batches += 1
        self.batches_run += 1
        self._m_served_total.inc(len(batch))
        self._m_batches_total.inc()
        self._m_queue_depth.set(self._n_pending)
        return True

    def run(self) -> List[ParseRequest]:
        """Drain the queue; returns finished requests in completion order."""
        while self.step():
            pass
        out, self._done = self._done, []
        return out

    def reap(self, req: ParseRequest) -> None:
        """Drop one finished request from the completion buffer (the ticket
        path collects results one by one; without this, a long-lived facade
        would accumulate every served request until the next ``run``)."""
        try:
            self._done.remove(req)
        except ValueError:
            pass

    # ------------------------------------------------------------------ stats

    @property
    def compile_count(self) -> int:
        """Distinct device programs compiled by the underlying engine."""
        return self.engine.compile_count

    @property
    def pending(self) -> int:
        return self._n_pending

    @property
    def stats(self) -> Dict:
        """Queue-depth + per-bucket and per-tenant aggregates (SLO inputs).

        Every bucket any request has ever mapped to is present — a bucket
        queued but not yet served reports ``served=0`` with its live
        ``queue_depth``, and an idle bucket reports ``queue_depth=0`` —
        so admission always reads a defined entry (no cold-start KeyError).
        """
        depth: Dict[Hashable, int] = {}
        for req in self._queue:
            if req.cancelled:
                continue
            b = self._bucket_of(req)
            depth[b] = depth.get(b, 0) + 1
        return {
            "backend": self.engine.backend.name,
            "pending": self._n_pending,
            "peak_queue_depth": self._peak_queue_depth,
            "batches_run": self.batches_run,
            "compile_count": self.compile_count,
            "buckets": bucket_stats_dict(self._buckets, depth),
            "tenants": {
                name: ts.as_dict() for name, ts in sorted(self._tenants.items())
            },
        }


class FleetParseService(ParseService):
    """The weighted-fair scheduler over a multi-automaton ``FleetEngine``.

    The same queueing, admission, cancellation and stats; only the seams
    differ: planning routes a text through its tenant's own tables and
    automaton bucket (``FleetEngine.request_plan``), and execution runs the
    bucket's tenant-batched dispatch (``FleetEngine.run_bucket``).  Tenants
    must be registered (they carry the automata), so auto-registration is
    off and ``submit`` requires a known tenant name.
    """

    _auto_tenants = False

    def _init(self, fleet_engine, *, max_batch: int = 8, max_pending: Optional[int] = None):
        from ..core.fleet import FleetEngine

        if not isinstance(fleet_engine, FleetEngine):
            raise TypeError(
                "FleetParseService requires a core.fleet.FleetEngine; "
                f"got {type(fleet_engine).__name__}"
            )
        self.engine = fleet_engine
        self.max_batch = max(1, max_batch)
        self.n_chunks = None  # per tenant: each spec carries its own
        self.max_pending = max_pending
        self._init_queue_state()

    def add_tenant(self, tid: str, spec, matrices=None) -> TenantState:
        """Register one tenant end to end: its automaton into its fleet
        bucket, its traffic class into the weighted-fair scheduler."""
        self.engine.add_tenant(tid, spec, matrices=matrices)
        return self.register_tenant(tid, weight=spec.weight, max_pending=spec.max_pending)

    def _classes_and_bucket(self, text, tenant):
        return self.engine.request_plan(tenant, text)

    def _execute(self, bucket, batch):
        return self.engine.run_bucket(bucket, [(req.tenant, req.classes) for req in batch])

    def _bucket_of(self, req: ParseRequest):
        if req.bucket is None:  # externally-constructed request
            _, req.bucket = self.engine.request_plan(req.tenant, req.classes)
        return req.bucket
