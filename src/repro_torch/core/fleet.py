"""Multi-tenant fleet engine: one launch of each kernel serves many automata.

The port of ``repro/core/fleet.py``.  Production RE traffic is thousands of
distinct patterns, and nothing in reach / join / build&merge depends on which
automaton's tables are bound: every phase takes (N, I, F) as operands
(``core/backend.py``), so a tenant axis runs through the phases as the batch
axis does.  Three pieces make that servable:

  automaton bucketing   ``pad_matrices_bundle`` (``core/matrices.py``) pads
                        each tenant's tables to a shared pow2 bucket shape:
                        ℓp to the next power of two (at least the backend's
                        ``min_lane_pad``) and the class axis likewise, with
                        PAD at the bucket's last index.  Tenants bucket by
                        (backend variant, class bucket, ℓp bucket); padding
                        is semantics-free, so each tenant's SLPF is its solo
                        ``Parser``'s, bit for bit.

  tenant-batched phases ``_BucketRunner`` keeps the members' tables stacked
                        on the device, (Tp, Ab, Lb, Lb), and serves a bucket
                        dispatch, every (tenant, text, chunk) row of one
                        (c, k) grid, with ONE call of each phase: one launch
                        of K1 (or K4, K5) and one of K2 over the whole
                        stack, each chunk reading its own tenant's table,
                        and the join's K3 launches folding every leading
                        axis.  The gathered operands of a row set are kept,
                        so a warm dispatch gathers nothing, and the kernels'
                        per-table derivatives (K1's group tables, the packed
                        tables) are kept with them (``kernels/checks.py``
                        ``derived``), so it builds nothing either.  So is
                        each gathered stack's live window (``kernels/
                        window.py``), from the members' tables tested on the
                        host when the stack is built: a bucket whose ℓp
                        pads past its live states (e125, ℓ = 257 at ℓp
                        512) runs K1 and K2 over the live states alone.
                        Sparse buckets bind the member-max feasible width
                        (``SparseBackend.bind_shape``): a width ≥ any
                        member's own bound stays exact, so a dense-fallback
                        tenant can share a bucket with a reduced one.

  table compile cache   the process-wide ``_TABLE_CACHE`` memoizes a
                        tenant's padded tables on (normalized regex, backend
                        variant, ℓp bucket); ``normalize_regex`` is the
                        parsed AST's canonical form.  ``table_cache_hits_total``
                        / ``table_cache_misses_total`` count per fleet.

PyTorch runs eagerly, so ``compile_count`` counts what the reference
compiles: one program per distinct (bucket, Tp, B, c, k) shape (and again
after a sparse bucket's width grows).  ``repro_torch.ParserFleet``
(``api.py``) is the facade; ``serve/parse_service.py``'s
``FleetParseService`` adds the weighted-fair queue.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import window
from ..kernels.checks import check_class_ids
from ..obs import ObsHandle
from .backend import PackedBackend, ParserBackend, SparseBackend, get_backend, next_pow2
from .engine import join_with_col0, resolve_device, unpack_columns
from .matrices import (
    ParserMatrices,
    build_matrices,
    feasible_width_bound,
    pad_matrices_bundle,
)
from .slpf import SLPF


# ---------------------------------------------------------------- tenant spec


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """Core-level description of one fleet tenant (the subset of
    ``ParserConfig`` the engine needs; the facade converts)."""

    regex: str
    backend: str = "cuda"
    kernel: bool = False
    feasible_depth: int = 1
    n_chunks: int = 8
    min_chunk_len: int = 8
    weight: float = 1.0
    max_pending: Optional[int] = None

    def backend_key(self) -> str:
        """Bucket-key component: backends with different static behavior
        (kernel toggle, feasible depth) must not share a bucket."""
        key = self.backend
        if self.kernel:
            key += "+kernel"
        if self.backend == "sparse" and self.feasible_depth != 1:
            key += f"+d{self.feasible_depth}"
        return key

    def make_backend(self) -> ParserBackend:
        if self.backend == "sparse":
            return SparseBackend(kernel=self.kernel, depth=self.feasible_depth)
        if self.backend == "packed" and self.kernel:
            return PackedBackend(kernel=True)
        return get_backend(self.backend)


# ----------------------------------------------------------- compile cache


def normalize_regex(pattern: str) -> str:
    """Canonical structural form of a pattern, the cache-key normalizer: the
    parsed AST's (deterministic, frozen-dataclass) repr, so syntactic
    variants that parse identically share one entry, while distinct
    patterns (explicit groups included, which own paren numbers) never
    collide."""
    from .regex import parse_regex

    return repr(parse_regex(pattern))


@dataclasses.dataclass
class CompiledTenantTables:
    """One automaton compiled and padded to its fleet bucket shape (host)."""

    matrices: ParserMatrices
    N: np.ndarray            # (Ab, Lb, Lb) f32: PAD = index Ab-1 = identity
    I: np.ndarray            # (Lb,) f32
    F: np.ndarray            # (Lb,) f32
    ell: int                 # true segment count
    ell_pad: int             # Lb: pow2 ℓp bucket
    n_classes: int           # Ab: pow2 class bucket (incl. PAD)
    pad_class: int           # Ab - 1
    width_bound: int         # depth-1 feasible width (sparse bucket input)


def _compile_tables(matrices: ParserMatrices, min_lane_pad: int) -> CompiledTenantTables:
    ell = matrices.n_segments
    lb = next_pow2(max(min_lane_pad, ell))
    ab = next_pow2(matrices.N.shape[0])
    N, I, F = pad_matrices_bundle(matrices, ell_pad=lb, n_classes=ab)
    return CompiledTenantTables(
        matrices=matrices,
        N=N,
        I=I,
        F=F,
        ell=ell,
        ell_pad=lb,
        n_classes=ab,
        pad_class=ab - 1,
        width_bound=feasible_width_bound(matrices),
    )


# (normalized regex, backend variant, ℓp bucket) → CompiledTenantTables,
# shared by every fleet in the process; (normalized regex, backend variant)
# → ℓp bucket resolves the full key before a build.
_TABLE_CACHE: Dict[Tuple[str, str, int], CompiledTenantTables] = {}
_TABLE_CACHE_LP: Dict[Tuple[str, str], int] = {}
_TABLE_CACHE_LOCK = threading.Lock()


def compiled_tenant_tables(
    regex: str,
    backend_key: str,
    min_lane_pad: int,
    metrics=None,
) -> CompiledTenantTables:
    """Cache front: padded tenant tables, built at most once per key.  Hits
    and misses count on the calling fleet's registry."""
    norm = normalize_regex(regex)
    with _TABLE_CACHE_LOCK:
        lp = _TABLE_CACHE_LP.get((norm, backend_key))
        entry = _TABLE_CACHE.get((norm, backend_key, lp)) if lp is not None else None
    if entry is not None:
        if metrics is not None:
            metrics.counter("table_cache_hits_total").inc()
        return entry
    if metrics is not None:
        metrics.counter("table_cache_misses_total").inc()
    from .segments import compute_segments

    ct = _compile_tables(build_matrices(compute_segments(regex)), min_lane_pad)
    with _TABLE_CACHE_LOCK:
        _TABLE_CACHE_LP[(norm, backend_key)] = ct.ell_pad
        _TABLE_CACHE[(norm, backend_key, ct.ell_pad)] = ct
    return ct


def table_cache_stats() -> Dict[str, Any]:
    with _TABLE_CACHE_LOCK:
        return {
            "entries": len(_TABLE_CACHE),
            "keys": sorted((k[1], k[2]) for k in _TABLE_CACHE),
        }


def clear_table_cache() -> None:
    """Forget every compiled table (the counters are per registry)."""
    with _TABLE_CACHE_LOCK:
        _TABLE_CACHE.clear()
        _TABLE_CACHE_LP.clear()


# ---------------------------------------------------------------- tenants


@dataclasses.dataclass
class TenantState:
    tid: str
    spec: TenantSpec
    tables: CompiledTenantTables
    bucket_key: Tuple[str, int, int]   # (backend variant, Ab, Lb)
    row: int                           # row in the bucket's table stack

    def classes_of_text(self, text) -> np.ndarray:
        if isinstance(text, (bytes, str)):
            return self.tables.matrices.classes_of_text(text)
        return np.asarray(text, dtype=np.int32)

    def text_bucket(self, n: int) -> Tuple[int, int]:
        c = max(1, self.spec.n_chunks)
        k = next_pow2(max(self.spec.min_chunk_len, -(-n // c)))
        return c, k


def make_fleet_core(backend: ParserBackend):
    """``core(N, I, F, chunks) -> (packed C₀ (T, B, W), packed cols (T, B,
    c, k, W))`` over a tenant stack: N (T, Ab, Lb, Lb), I / F (T, Lb),
    chunks (T, B, c, k).  One call of each phase for the whole stack; I and
    F broadcast over the batch axis."""

    def core(N, I, F, chunks):
        P = backend.reach(N, chunks)
        Jf, Jb, col0p = join_with_col0(backend, P, I[:, None, :], F[:, None, :])
        return col0p, backend.build_merge_packed(N, chunks, Jf, Jb)

    return core


class _BucketRunner:
    """One automaton bucket: the members' tables stacked on the device and
    the fleet core over them.

    The stack holds Tp = pow2(members) rows (pad rows replicate row 0), so
    adding a tenant reshapes nothing but the stack.  Each dispatch gathers
    the active tenants' rows, a pow2 count of them, and keeps the gathered
    operands by row set (``_gather_cache``), reset with the stack.
    """

    def __init__(self, key: Tuple[str, int, int], backend: ParserBackend, obs, on_compile,
                 device: torch.device):
        self.key = key
        self.backend = backend
        self.obs = obs
        self.device = device
        self._on_compile = on_compile
        _, self.n_classes, self.ell_pad = key
        self.pad_class = self.n_classes - 1
        self.tenant_rows: Dict[str, int] = {}
        self._host: List[CompiledTenantTables] = []
        self._stack: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None
        self._extents: Optional[Tuple[torch.Tensor, torch.Tensor]] = None   # per (row, class)
        self._core = make_fleet_core(backend)
        self._seen_shapes: set = set()
        self._gather_cache: Dict[Tuple[int, ...], Tuple[torch.Tensor, ...]] = {}

    # --------------------------------------------------------- membership

    def add(self, tid: str, ct: CompiledTenantTables) -> int:
        row = len(self._host)
        self.tenant_rows[tid] = row
        self._host.append(ct)
        self._stack = None                       # restack lazily (pow2 rows)
        self._gather_cache.clear()
        if isinstance(self.backend, SparseBackend):
            # the bucket runs every member at the shared width S = pow2 of
            # the member maximum (S = Lb once it reaches Lb); a grown S
            # changes the products' shapes: a new program set
            old = self.backend._width
            self.backend.bind_shape(self.ell_pad, max(t.width_bound for t in self._host))
            if self.backend._width != old:
                self._seen_shapes.clear()
        return row

    @property
    def n_tenants(self) -> int:
        return len(self._host)

    # ------------------------------------------------------------ program

    def _ensure_stack(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        if self._stack is None:
            T = len(self._host)
            Tp = next_pow2(T)
            ab, lb = self.n_classes, self.ell_pad
            N = np.empty((Tp, ab, lb, lb), dtype=np.float32)
            I = np.empty((Tp, lb), dtype=np.float32)
            F = np.empty((Tp, lb), dtype=np.float32)
            for r, ct in enumerate(self._host):
                N[r], I[r], F[r] = ct.N, ct.I, ct.F
            # pad rows replicate row 0: a valid automaton for every backend
            # (their chunks are all-PAD and their outputs dropped)
            N[T:], I[T:], F[T:] = N[0], I[0], F[0]
            # the live window's test, on the host copy: nothing is read back
            self._extents = window.class_extents(torch.from_numpy(N))
            self._stack = tuple(torch.from_numpy(a).to(self.device) for a in (N, I, F))
        return self._stack

    def operands(self, rows: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(N, I, F) of the tenant rows ``rows``, gathered from the resident
        stack once per row set, the gathered N with the rows' live window
        attached (``kernels/window.py``)."""
        key = tuple(rows.tolist())
        ops = self._gather_cache.get(key)
        if ops is None:
            idx = torch.from_numpy(rows.astype(np.int64)).to(self.device)
            ops = tuple(x.index_select(0, idx).contiguous() for x in self._ensure_stack())
            at = torch.from_numpy(rows.astype(np.int64))
            extent, ident = (x.index_select(0, at) for x in self._extents)
            win = window.window_of(extent, ident, self.ell_pad)
            window.attach(ops[0], win._replace(ident=win.ident.to(self.device)))
            self._gather_cache[key] = ops
        return ops

    def host_batch(
        self, c: int, k: int, per_tenant: Dict[str, List[np.ndarray]]
    ) -> Tuple[np.ndarray, np.ndarray]:
        """The dispatch's host side: (tenant rows (Tp,), chunk grid (Tp, B,
        c, k)) for ``per_tenant``'s texts, pad tenants and pad texts all
        PAD; Tp and B the pow2 of the tenant and text counts."""
        Tp = next_pow2(len(per_tenant))
        B = next_pow2(max(len(v) for v in per_tenant.values()))
        rows = np.zeros(Tp, dtype=np.int32)      # pad rows gather row 0
        chunks = np.full((Tp, B, c, k), self.pad_class, dtype=np.int32)
        flat = chunks.reshape(Tp, B, c * k)
        for t, tid in enumerate(per_tenant):
            rows[t] = self.tenant_rows[tid]
            for b, classes in enumerate(per_tenant[tid]):
                flat[t, b, : len(classes)] = classes
        check_class_ids(chunks, self.n_classes)
        return rows, chunks

    def run(
        self,
        c: int,
        k: int,
        per_tenant: Dict[str, List[np.ndarray]],
    ) -> Dict[str, List[Tuple[np.ndarray, np.ndarray]]]:
        """One dispatch for every (tenant, text) of one (c, k) grid.

        ``per_tenant`` maps tid → class arrays; returns tid → [(col0, cols)]
        aligned with the input lists (packed words as uint32).
        """
        tids = list(per_tenant)
        rows, chunks = self.host_batch(c, k, per_tenant)
        m = self.obs.metrics
        shape = chunks.shape
        if shape in self._seen_shapes:
            m.counter("bucket_cache_hits_total").inc()
        else:
            self._seen_shapes.add(shape)
            m.counter("bucket_cache_misses_total").inc()
            self._on_compile()
        N, I, F = self.operands(rows)
        col0s, colss = self._core(N, I, F, torch.from_numpy(chunks).to(self.device))
        col0s = col0s.cpu().numpy().view(np.uint32)
        colss = colss.cpu().numpy().view(np.uint32)
        return {
            tid: [(col0s[t, b], colss[t, b]) for b in range(len(per_tenant[tid]))]
            for t, tid in enumerate(tids)
        }


# ------------------------------------------------------------------ engine


class _FleetBackendInfo:
    """Engine duck-typing: services report ``engine.backend.name``."""

    name = "fleet"


class FleetEngine:
    """Many automata, one device: per-bucket tenant-batched dispatches.

    Quacks like ``ParserEngine`` where the service layer needs it (``obs``,
    ``compile_count``, ``backend.name``); parsing goes through
    ``parse_batch([(tenant_id, text), ...])`` or the per-bucket
    ``run_bucket`` the fleet service drives.  ``device=None`` means the
    card, as everywhere in the port.
    """

    def __init__(self, obs: Optional[ObsHandle] = None, device=None):
        self.obs = obs if obs is not None else ObsHandle()
        self.device = resolve_device(device)
        self.backend = _FleetBackendInfo()
        self._tenants: Dict[str, TenantState] = {}
        self._buckets: Dict[Tuple[str, int, int], _BucketRunner] = {}
        self._compile_count = 0

    def _bump_compiles(self) -> None:
        self._compile_count += 1
        self.obs.metrics.counter("compiled_programs_total").inc()

    @property
    def compile_count(self) -> int:
        """Distinct (bucket, Tp, B, c, k) shapes run, the reference's traced
        programs: grows with buckets × pow2 shapes, not with tenants."""
        return self._compile_count

    @property
    def tenants(self) -> Dict[str, TenantState]:
        return dict(self._tenants)

    @property
    def n_buckets(self) -> int:
        return len(self._buckets)

    def bucket_sizes(self) -> Dict[Tuple[str, int, int], int]:
        return {k: r.n_tenants for k, r in self._buckets.items()}

    # ---------------------------------------------------------- membership

    def add_tenant(
        self,
        tid: str,
        spec: TenantSpec,
        matrices: Optional[ParserMatrices] = None,
    ) -> TenantState:
        """Register one tenant: compile-or-cache its tables and place it in
        its automaton bucket (creating the bucket on first membership).
        ``backend="auto"`` resolves through the static analyzer first, on
        this engine's device (``analyze.pattern.resolve_backend``)."""
        if tid in self._tenants:
            raise ValueError(f"fleet tenant {tid!r} already registered")
        if spec.backend == "auto":
            from ..analyze.pattern import analyze_matrices, resolve_auto_backend, resolve_backend

            if matrices is not None:
                choice = analyze_matrices(matrices).recommended_backend
            else:
                choice = resolve_auto_backend(spec.regex, spec.feasible_depth)
            backend, kernel = resolve_backend(choice, self.device.type)
            spec = dataclasses.replace(spec, backend=backend, kernel=kernel)
            self.obs.metrics.counter("auto_backend_selected_total", backend=backend).inc()
        probe = spec.make_backend()
        if probe.needs_cuda and self.device.type != "cuda":
            raise ValueError(
                f"fleet tenant {tid!r}: backend {spec.backend_key()!r} runs only on the "
                f"card, the fleet is on {str(self.device)!r}"
            )
        backend_key = spec.backend_key()
        if matrices is not None:
            ct = _compile_tables(matrices, probe.min_lane_pad)   # prebuilt: no cache
        else:
            ct = compiled_tenant_tables(
                spec.regex, backend_key, probe.min_lane_pad, metrics=self.obs.metrics
            )
        key = (backend_key, ct.n_classes, ct.ell_pad)
        runner = self._buckets.get(key)
        if runner is None:
            if isinstance(probe, SparseBackend):
                probe.bind_shape(ct.ell_pad, ct.width_bound)
            runner = _BucketRunner(key, probe, self.obs, self._bump_compiles, self.device)
            self._buckets[key] = runner
        row = runner.add(tid, ct)
        ts = TenantState(tid=tid, spec=spec, tables=ct, bucket_key=key, row=row)
        self._tenants[tid] = ts
        m = self.obs.metrics
        m.gauge("fleet_tenants").set(len(self._tenants))
        m.gauge("fleet_buckets").set(len(self._buckets))
        return ts

    def tenant(self, tid: str) -> TenantState:
        ts = self._tenants.get(tid)
        if ts is None:
            raise KeyError(f"unknown fleet tenant {tid!r}")
        return ts

    def runner(self, bucket_key: Tuple[str, int, int]) -> _BucketRunner:
        return self._buckets[bucket_key]

    # ------------------------------------------------------------- parsing

    def request_plan(self, tid: str, text) -> Tuple[np.ndarray, Tuple]:
        """(classes, bucket) of one request, the service's submit-time hook:
        requests batch together exactly when they share an automaton bucket
        and a (c, k) text bucket."""
        ts = self.tenant(tid)
        classes = ts.classes_of_text(text)
        return classes, (ts.bucket_key, ts.text_bucket(len(classes)))

    def run_bucket(
        self, bucket: Tuple, items: Sequence[Tuple[str, np.ndarray]]
    ) -> List[SLPF]:
        """Serve one same-bucket group in a single tenant-batched dispatch."""
        bkey, (c, k) = bucket
        runner = self._buckets[bkey]
        per_tenant: Dict[str, List[np.ndarray]] = {}
        slots: List[Tuple[str, int]] = []
        for tid, classes in items:
            lst = per_tenant.setdefault(tid, [])
            slots.append((tid, len(lst)))
            lst.append(classes)
        out = runner.run(c, k, per_tenant)
        return [
            self._assemble(self.tenant(tid), *out[tid][b], classes)
            for (tid, b), (_, classes) in zip(slots, items)
        ]

    def parse_batch(self, items: Sequence[Tuple[str, Any]]) -> List[SLPF]:
        """Parse [(tenant_id, text), ...]: grouped by (automaton bucket,
        (c, k)), one dispatch a group, results in input order, each equal
        to its tenant's solo parse."""
        plans = []
        groups: Dict[Tuple, List[int]] = {}
        for i, (tid, text) in enumerate(items):
            classes, bucket = self.request_plan(tid, text)
            plans.append((tid, classes))
            groups.setdefault(bucket, []).append(i)
        results: List[Optional[SLPF]] = [None] * len(items)
        for bucket, idxs in sorted(groups.items()):
            for i, slpf in zip(idxs, self.run_bucket(bucket, [plans[i] for i in idxs])):
                results[i] = slpf
        return results  # type: ignore[return-value]

    def parse(self, tid: str, text) -> SLPF:
        return self.parse_batch([(tid, text)])[0]

    def _assemble(self, ts: TenantState, col0: np.ndarray, cols: np.ndarray, classes) -> SLPF:
        n = len(classes)
        W = cols.shape[-1]
        packed = np.concatenate([col0[None], cols.reshape(-1, W)[:n]], axis=0)
        return SLPF(
            table=ts.tables.matrices.table,
            columns=unpack_columns(packed, ts.tables.ell),
            classes=np.asarray(classes, dtype=np.int32),
        )
