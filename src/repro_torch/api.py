"""The public parse API of the port: one facade, one config, one result type.

It mirrors ``repro/api.py``:

  ``ParserConfig``   the reference's fields, validation and dict round trip;
                     backend names map as ``jnp`` ↔ ``torch``, ``pallas`` ↔
                     ``cuda`` (``packed``, ``sparse`` and ``auto`` keep their
                     names), and the port's default is ``cuda``.
  ``Parser``         owns the engine, a lazy ``ParseService`` (batched
                     one-shot requests with deadline-aware admission) and a
                     lazy ``StreamService`` (streaming sessions), both over
                     the same engine: ``parse`` / ``parse_batch`` /
                     ``submit`` → ``ParseTicket`` / ``open_stream`` →
                     ``ParserStream``, and ``stats()`` over both services,
                     the metrics registry, the SLO targets and the static
                     analysis.
  ``ParserFleet``    many patterns on one device: each tenant's tables in a
                     shared automaton bucket (``core/fleet.py``), one
                     dispatch a bucket, over the weighted-fair
                     ``FleetParseService``.
  ``ParseResult``    the forest with ``ok``, ``matches``, ``children``,
                     ``trees`` and timing / backend / bucket / trace metadata.

``Parser.parse`` is ``submit(...).result()``, traced or not; with tracing on
(``ParserConfig(obs=ObsConfig(enabled=True))``) it holds its ``parse.request``
root open as a live span, and the route below records a span at each layer
boundary (``obs/trace.py``'s taxonomy).

``kernel=True`` selects the kernel path of ``packed`` (K4, and K2 for
build&merge) and ``sparse`` (K5 and K2); ``cuda`` is always kernels, as
``pallas`` is in the reference.  A kernel path runs only on the card.

Static analysis (``repro_torch.analyze``) runs at construction, as the
reference's does: ``analyze="warn"`` (the default) warns on a pathologically
ambiguous pattern, ``"strict"`` refuses it with ``PathologicalPatternError``
(at ``Parser`` construction, at ``ParserFleet.add``, and on the services'
admission), ``"off"`` skips it (``stats()["analysis"]`` then computes it
lazily).  ``backend="auto"`` takes the analyzer's choice and runs it as the
device runs it best (``analyze.pattern.resolve_backend``): on the card the
dense family as ``cuda`` and ``packed`` / ``sparse`` with ``kernel=True``.
``ParserConfig(mesh="host")`` builds a ``('pod', 'data')`` mesh over the
ranks of the initialized ``torch.distributed`` group (``launch/mesh.py``; a
single process with no group is the 1-rank mesh): run one process a rank,
each building the same ``Parser`` and making the same calls.  ``parse`` then
shards one text's chunks over every rank, ``parse_batch`` batch slots over
'data' and chunks over 'pod' (``core/distributed.py``).  Fleet tenants run
on one device and refuse ``mesh``.  ``stats()["hlo"]`` is the per-bucket
static modeled cost of the phase programs (``ParserEngine.phase_static_cost``,
traced by ``launch/op_stats.py``) where the reference attaches it: tracing
on, ``ObsConfig.hlo`` on, and no mesh.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

from .core.backend import PackedBackend, ParserBackend, SparseBackend, get_backend
from .core.engine import ParserEngine, resolve_device
from .core.matrices import ParserMatrices, build_matrices, feasible_start_widths
from .core.numbering import CLOSE, OP_GROUP, OPEN
from .core.segments import SegmentTable, compute_segments
from .core.slpf import SLPF
from .errors import ParseError, PathologicalPatternError
from .obs import ObsConfig, ObsHandle
from .serve.parse_service import BucketStats, FleetParseService, ParseRequest, ParseService
from .serve.stream_service import StreamService

_HOST_MESH_AXES = ("pod", "data")
# every backend name a config may carry: the registered ones
# (core/backend.py) and "auto", which the static analyzer resolves
_CONFIG_BACKENDS = ("auto", "cuda", "packed", "sparse", "torch")


def _is_pow2(x: int) -> bool:
    return x >= 1 and (x & (x - 1)) == 0


# ------------------------------------------------------------------ config


@dataclasses.dataclass(frozen=True)
class SLOTargets:
    """Latency objectives applied per device-program bucket.

    ``p50_s``/``p99_s`` are the per-bucket targets ``Parser.stats()`` grades
    observed latency against; ``default_deadline_s`` is the admission
    deadline ``submit``/``append`` use when the caller passes none (None ⇒
    no implicit deadline — everything admits).
    """

    p50_s: Optional[float] = None
    p99_s: Optional[float] = None
    default_deadline_s: Optional[float] = None

    def __post_init__(self):
        for name in ("p50_s", "p99_s", "default_deadline_s"):
            v = getattr(self, name)
            if v is not None and v <= 0.0:
                raise ValueError(f"SLOTargets.{name} must be positive, got {v!r}")
        if self.p50_s is not None and self.p99_s is not None and self.p50_s > self.p99_s:
            raise ValueError(
                f"SLOTargets.p50_s ({self.p50_s}) must not exceed p99_s ({self.p99_s})"
            )


@dataclasses.dataclass(frozen=True)
class ParserConfig:
    """Declarative, validated, dict-round-trippable parser description.

    The reference's fields and rules; see ``repro/api.py`` for each one.
    Invalid values raise ``ValueError`` at construction.
    """

    regex: str
    backend: str = "cuda"
    kernel: bool = False
    analyze: str = "warn"
    feasible_depth: int = 1
    n_chunks: int = 8
    min_chunk_len: int = 8
    max_batch: int = 8
    max_pending: Optional[int] = None
    weight: float = 1.0
    first_seal_len: int = 8
    max_seal_len: Optional[int] = None
    cache_budget_bytes: Optional[int] = None
    max_pending_chars: Optional[int] = None
    mesh: Optional[str] = None
    mesh_rules: Optional[Tuple[Tuple[str, Tuple[str, ...]], ...]] = None
    slo: Optional[SLOTargets] = None
    obs: Optional[ObsConfig] = None

    def __post_init__(self):
        if not isinstance(self.regex, str) or not self.regex:
            raise ValueError("ParserConfig.regex must be a non-empty pattern string")
        if self.backend not in _CONFIG_BACKENDS:
            raise ValueError(
                f"unknown parse backend {self.backend!r}; known: {list(_CONFIG_BACKENDS)}"
            )
        if self.analyze not in ("off", "warn", "strict"):
            raise ValueError(
                f"analyze must be 'off', 'warn', or 'strict', got {self.analyze!r}"
            )
        if self.kernel and self.backend == "torch":
            raise ValueError(
                "kernel=True selects a kernel path; the 'torch' backend has "
                "none (use backend='cuda' or backend='packed')"
            )
        if self.kernel and self.backend == "auto":
            raise ValueError(
                "kernel=True is a per-backend toggle; backend='auto' lets the "
                "analyzer choose — pick an explicit backend to force its kernel path"
            )
        if self.feasible_depth < 1:
            raise ValueError(f"feasible_depth must be >= 1, got {self.feasible_depth}")
        if self.feasible_depth != 1 and self.backend not in ("sparse", "auto"):
            raise ValueError(
                "feasible_depth tunes the sparse backend's start-state pruning; "
                f"backend {self.backend!r} has no speculation to prune "
                "(use backend='sparse')"
            )
        if self.n_chunks < 1:
            raise ValueError(f"n_chunks must be >= 1, got {self.n_chunks}")
        for name in ("min_chunk_len", "first_seal_len"):
            v = getattr(self, name)
            if not _is_pow2(v):
                raise ValueError(
                    f"{name} must be a power of two (the bucket policy runs one "
                    f"shape per pow2 chunk length), got {v}"
                )
        if self.max_seal_len is not None and not _is_pow2(self.max_seal_len):
            raise ValueError(f"max_seal_len must be a power of two, got {self.max_seal_len}")
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.weight <= 0:
            raise ValueError(f"weight must be > 0, got {self.weight}")
        for name in ("max_pending", "cache_budget_bytes", "max_pending_chars"):
            v = getattr(self, name)
            if v is not None and v < 1:
                raise ValueError(f"{name} must be positive or None, got {v}")
        if self.mesh not in (None, "host"):
            raise ValueError(
                f"mesh must be None (single device) or 'host' (a "
                f"{_HOST_MESH_AXES} mesh over every device), got {self.mesh!r}"
            )
        if self.mesh_rules is not None:
            if self.mesh is None:
                raise ValueError("mesh_rules requires mesh to be set")
            items = (
                self.mesh_rules.items()
                if isinstance(self.mesh_rules, Mapping)
                else self.mesh_rules
            )
            norm = []
            for name, axes in items:
                if axes is None:
                    axes_t: Tuple[str, ...] = ()
                elif isinstance(axes, str):
                    axes_t = (axes,)
                else:
                    axes_t = tuple(axes)
                for a in axes_t:
                    if a not in _HOST_MESH_AXES:
                        raise ValueError(
                            f"mesh_rules[{name!r}] names mesh axis {a!r} which does "
                            f"not resolve on the declared mesh (axes: {_HOST_MESH_AXES})"
                        )
                norm.append((str(name), axes_t))
            object.__setattr__(self, "mesh_rules", tuple(sorted(norm)))
        if self.slo is not None and isinstance(self.slo, Mapping):
            object.__setattr__(self, "slo", SLOTargets(**dict(self.slo)))
        if self.obs is not None and isinstance(self.obs, Mapping):
            object.__setattr__(self, "obs", ObsConfig(**dict(self.obs)))

    def to_dict(self) -> Dict[str, Any]:
        """Plain JSON-able dict; ``from_dict`` round-trips it exactly."""
        d = dataclasses.asdict(self)
        if self.mesh_rules is not None:
            d["mesh_rules"] = {name: list(axes) for name, axes in self.mesh_rules}
        return d

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ParserConfig":
        d = dict(d)
        unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise ValueError(f"unknown ParserConfig keys: {sorted(unknown)}")
        return cls(**d)

    def replace(self, **kw) -> "ParserConfig":
        return dataclasses.replace(self, **kw)

    def build_backend(
        self, resolved: Optional[str] = None, kernel: Optional[bool] = None
    ) -> ParserBackend:
        """Instantiate the phase backend, kernel toggle applied (``cuda`` is
        always kernels).  ``resolved`` / ``kernel`` override the configured
        name and toggle: the facade passes what ``backend="auto"`` resolved
        to; "auto" itself is not a backend."""
        name = resolved if resolved is not None else self.backend
        kernel = self.kernel if kernel is None else kernel
        if name == "auto":
            raise ValueError(
                'backend="auto" resolves through the static analyzer; '
                "build_backend needs the resolved name (use repro_torch.analyze."
                "resolve_auto_backend or construct a Parser)"
            )
        if name == "sparse":
            return SparseBackend(kernel=kernel, depth=self.feasible_depth)
        if name == "packed" and kernel:
            return PackedBackend(kernel=True)
        return get_backend(name)

    def build_mesh(self):
        """The declared mesh (``launch/mesh.py`` ``make_parse_mesh``, over
        every rank of the default process group), or None on a
        single-device config.  Building it is collective across ranks."""
        if self.mesh is None:
            return None
        from .launch.mesh import make_parse_mesh

        return make_parse_mesh()

    def build_mesh_rules(self):
        """``MeshRules`` with this config's overrides, or None for defaults."""
        if self.mesh_rules is None:
            return None
        from .parallel.sharding import MeshRules

        overrides = {
            name: (axes if len(axes) != 1 else axes[0]) or None
            for name, axes in self.mesh_rules
        }
        return MeshRules().with_overrides(**overrides)


# ------------------------------------------------------------------ results


@dataclasses.dataclass
class ParseResult:
    """The forest plus accessors and metadata (``repro.ParseResult``)."""

    forest: SLPF
    backend: str
    bucket: Optional[Tuple[int, int]] = None
    latency_s: Optional[float] = None
    n_chunks: Optional[int] = None
    # sparse backend only: the observed speculation width of this parse —
    # feasible start states per real chunk (mean/max) against the carried
    # product rows S and the paper's ℓp
    speculation: Optional[Dict[str, Any]] = None
    # the request's trace ID when the parser's tracer is enabled — the key
    # into the span log (obs/export.py validate_span_tree); else None
    trace_id: Optional[str] = None

    @property
    def ok(self) -> bool:
        """Did the text match the RE (non-empty clean forest)?"""
        return self.forest.accepted

    @property
    def slpf(self) -> SLPF:
        """Alias of ``forest`` (the shared linearized parse forest)."""
        return self.forest

    def count_trees(self) -> int:
        return self.forest.count_trees()

    def matches(self, group: int, limit: Optional[int] = 1000) -> List[Tuple[int, int]]:
        """(start, end) spans of a numbered group / operator pair (App. A)."""
        return self.forest.get_matches(group, limit=limit)

    def children(
        self, span: Tuple[int, int], limit: Optional[int] = 1000
    ) -> List[Tuple[int, int, int]]:
        """(group, start, end) spans directly nested under ``span``, over up
        to ``limit`` trees (the paper's ``getChildren``)."""
        span = (int(span[0]), int(span[1]))
        syms = self.forest.table.numbered.symbols
        out: Dict[Tuple[int, int, int], None] = {}
        for path in self.forest.iter_trees(limit=limit):
            stack: List[List[Any]] = []   # [group num, start boundary, children]
            for r, q in enumerate(path):
                for sid in self.forest.table.segs[q][:-1]:
                    s = syms[sid]
                    if s.kind == OPEN:
                        stack.append([s.num, r, []])
                    elif s.kind == CLOSE:
                        num, st, kids = stack.pop()
                        if stack:
                            stack[-1][2].append((num, st, r))
                        if (st, r) == span:
                            for kid in kids:
                                out[kid] = None
        return sorted(out)

    def trees(self, limit: Optional[int] = None, *, paths: bool = False) -> List:
        """Up to ``limit`` LSTs — rendered strings, or segment-id paths."""
        if paths:
            return list(self.forest.iter_trees(limit=limit))
        return [self.forest.lst_string(p) for p in self.forest.iter_trees(limit=limit)]


# ------------------------------------------------------------------ tickets


class ParseTicket:
    """Asynchronous handle for one submitted parse (``Parser.submit``).

    The request is already past deadline-aware admission; ``done()`` is a
    free check, ``result()`` drives the service until THIS request is
    served (batching with whatever else is queued) and returns the
    ``ParseResult``, ``cancel()`` drops it if no batch has picked it up.
    """

    def __init__(
        self,
        parser: Union["Parser", "ParserFleet"],
        service: ParseService,
        request: ParseRequest,
        deadline_s: Optional[float] = None,
    ):
        self._parser = parser
        self._service = service
        self._request = request
        self._result: Optional[ParseResult] = None
        self._cancelled = False
        self.deadline_s = deadline_s   # the admitted remaining budget

    @property
    def rid(self) -> int:
        return self._request.rid

    def done(self) -> bool:
        return self._request.done

    def cancel(self) -> bool:
        """Drop the request if it has not been served; True on success."""
        if self._request.done:
            return False
        self._cancelled = self._service.cancel(self._request.rid)
        return self._cancelled

    def result(self) -> ParseResult:
        """Serve (if needed) and return the result; raises on a cancelled
        ticket."""
        if self._result is not None:
            return self._result
        if self._cancelled:
            raise ParseError(f"parse request {self._request.rid} was cancelled")
        while not self._request.done:
            if not self._service.step():
                raise ParseError(
                    f"parse request {self._request.rid} is no longer queued"
                )
        self._service.reap(self._request)
        req = self._request
        if req.began_at is not None:
            # the root span closes here — collection ends the request's
            # lifetime; its children were recorded against the pre-minted
            # root id
            self._parser.engine.obs.emit(
                "parse.request",
                t_start_s=req.began_at,
                duration_s=time.perf_counter() - req.began_at,
                trace_id=req.trace_id,
                span_id=req.root_span_id,
                bucket=list(req.bucket) if req.bucket else None,
                n_chars=len(req.classes) if req.classes is not None else 0,
            )
        self._result = self._parser._wrap(
            req.slpf,
            bucket=req.bucket,
            latency_s=req.latency_s,
            trace_id=req.trace_id,
            tenant=req.tenant,
        )
        return self._result


# ------------------------------------------------------------------ streams


class ParserStream:
    """One streaming session of ``Parser.open_stream`` (context manager).

    Appends go through the shared ``StreamService`` — concurrent sessions
    batch their tail pieces into one reach launch — with the same
    deadline-aware admission as ``submit``.  ``result()`` materializes the
    current prefix's ``ParseResult``; ``accepted`` is the streaming
    acceptance state.
    """

    def __init__(self, parser: "Parser", service: StreamService, sid: int):
        self._parser = parser
        self._service = service
        self._sid = sid
        self._closed = False

    @property
    def sid(self) -> int:
        return self._sid

    @property
    def n(self) -> int:
        """Characters absorbed into the prefix so far (queued appends not
        yet drained are excluded)."""
        return self._service._session(self._sid).parser.n

    @property
    def n_sealed_chunks(self) -> int:
        """Sealed chunk products resident in this stream's prefix cache."""
        return self._service._session(self._sid).parser.n_sealed_chunks

    def append(self, text, *, deadline_s: Optional[float] = None) -> int:
        """Queue text onto this stream; returns chars queued (admission may
        raise ``AdmissionError``/``BudgetExceeded``)."""
        if deadline_s is None:
            deadline_s = self._parser._default_deadline_s()
        return self._service.append(self._sid, text, deadline_s=deadline_s)

    @property
    def accepted(self) -> bool:
        """Is the current prefix a valid text (drains this session only)?"""
        return self._service.accepted(self._sid)

    def edit(self, lo: int, hi: int, replacement) -> int:
        """Splice the prefix: replace characters ``[lo, hi)`` with
        ``replacement``; returns the new prefix length.  Re-reaches only the
        spliced chunks and re-composes one leaf-to-root path; the result is
        bit-identical to a cold parse of the edited text.  Drains this
        session's queued appends first."""
        return self._service.edit(self._sid, lo, hi, replacement)

    def delete(self, lo: int, hi: int) -> int:
        """Remove characters ``[lo, hi)`` — ``edit`` with an empty
        replacement."""
        return self._service.edit(self._sid, lo, hi, "")

    def insert(self, pos: int, text) -> int:
        """Insert ``text`` before position ``pos`` — a zero-width ``edit``."""
        return self._service.edit(self._sid, pos, pos, text)

    def result(self) -> ParseResult:
        """ParseResult of the full current prefix (drains this session)."""
        t0 = time.perf_counter()
        slpf = self._service.slpf(self._sid)
        return self._parser._wrap(slpf, latency_s=time.perf_counter() - t0)

    def close(self) -> None:
        if not self._closed:
            self._service.close(self._sid)
            self._closed = True

    def __enter__(self) -> "ParserStream":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ------------------------------------------------------------------- facade


class Parser:
    """The port's parser: a ``ParserConfig`` (or pattern) on one device.

        p = repro_torch.Parser("(a|b|ab)+")                    # the card
        p = repro_torch.Parser(cfg, device="cpu")              # backend="torch"

    ``device=None`` means the card, and raises when there is none.  Owns
    the engine, a lazy ``ParseService`` and a lazy ``StreamService``, all
    recording into one ``ObsHandle`` (``self.obs``).
    """

    def __init__(
        self,
        config: Union[ParserConfig, str, Mapping[str, Any]],
        *,
        matrices: Optional[ParserMatrices] = None,
        device=None,
    ):
        if isinstance(config, str):
            config = ParserConfig(regex=config)
        elif isinstance(config, Mapping):
            config = ParserConfig.from_dict(config)
        if not isinstance(config, ParserConfig):
            raise TypeError(
                f"Parser takes a ParserConfig, a pattern string, or a config "
                f"dict; got {type(config).__name__}"
            )
        self.config = config
        if matrices is None:
            matrices = build_matrices(compute_segments(config.regex))
        self.matrices = matrices
        device = resolve_device(device)
        # one ObsHandle for the whole parser: the engine carries it, and
        # every layer over the engine (services, streams) records into it
        self.obs = ObsHandle.from_config(config.obs)
        # static analysis at construction when the config wants a verdict
        # (analyze != "off") or needs one (backend == "auto"); otherwise
        # stats()["analysis"] computes it lazily
        self._analysis = None
        resolved, kernel = config.backend, config.kernel
        if config.backend == "auto" or config.analyze != "off":
            report = self._analyze()
            m = self.obs.metrics
            m.counter("analyzer_verdicts_total", verdict=report.verdict).inc()
            if report.verdict == "pathological":
                if config.analyze == "strict":
                    m.counter(
                        "admission_rejects_total", service="analyze", cause="pathological"
                    ).inc()
                    raise PathologicalPatternError(
                        f"pattern {config.regex!r} is pathologically ambiguous (an "
                        "iterator with a nullable body admits unboundedly many parse "
                        'trees per text); analyze="strict" rejects it at construction',
                        pattern=config.regex,
                        ambiguity=report.ambiguity,
                    )
                if config.analyze == "warn":
                    warnings.warn(
                        f"repro_torch: pattern {config.regex!r} is pathologically "
                        "ambiguous — forest size is unbounded per text "
                        '(analyze="strict" rejects such patterns)',
                        UserWarning,
                        stacklevel=2,
                    )
            if config.backend == "auto":
                from .analyze.pattern import resolve_backend

                resolved, kernel = resolve_backend(report.recommended_backend, device.type)
                m.counter("auto_backend_selected_total", backend=resolved).inc()
        self.engine = ParserEngine(
            matrices,
            backend=config.build_backend(resolved, kernel),
            min_chunk_len=config.min_chunk_len,
            device=device,
            mesh=config.build_mesh(),
            mesh_rules=config.build_mesh_rules(),
            obs=self.obs,
        )
        self._parse_service: Optional[ParseService] = None
        self._stream_service: Optional[StreamService] = None
        self._artifacts = None
        # per-bucket observed speculation widths (sparse backend only)
        self._spec_buckets: Dict[Tuple[int, int], Dict[str, Any]] = {}

    @classmethod
    def from_matrices(
        cls,
        matrices_or_table: Union[ParserMatrices, SegmentTable],
        config: Union[ParserConfig, str, Mapping[str, Any], None] = None,
        *,
        device=None,
    ) -> "Parser":
        """A Parser over pre-generated matrices or a segment table;
        ``config.regex`` is then informational."""
        if isinstance(matrices_or_table, SegmentTable):
            matrices_or_table = build_matrices(matrices_or_table)
        if config is None:
            config = ParserConfig(regex="<prebuilt>")
        return cls(config, matrices=matrices_or_table, device=device)

    @property
    def backend_name(self) -> str:
        return self.engine.backend.name

    @property
    def compile_count(self) -> int:
        return self.engine.compile_count

    def _analyze(self):
        if self._analysis is None:
            from .analyze import analyze_matrices

            # from_matrices parsers carry a placeholder pattern: analyze the
            # automaton alone (the AST legs fall back to matrix facts)
            pattern = self.config.regex
            if pattern == "<prebuilt>":
                pattern = None
            self._analysis = analyze_matrices(
                self.matrices, pattern=pattern, depth=max(4, self.config.feasible_depth)
            )
        return self._analysis

    @property
    def analysis(self):
        """The static ``AnalysisReport`` (``repro_torch.analyze``), memoized:
        feasible-start width bounds, ambiguity verdict, product density, the
        per-backend cost model and the recommended backend."""
        return self._analyze()

    @property
    def table(self) -> SegmentTable:
        return self.engine.table

    @property
    def artifacts(self):
        """Full ``ParallelArtifacts`` (NFA/DFA/ME-DFA…) for introspection,
        built lazily (``core/reference.py``) — parsing never needs the
        exponential DFA, only the matrices."""
        if self._artifacts is None:
            from .core.reference import ParallelArtifacts

            self._artifacts = ParallelArtifacts.generate(self.matrices.table)
        return self._artifacts

    @property
    def groups(self) -> List[int]:
        """Numbered group ids extractable via ``ParseResult.matches``."""
        return sorted(
            {s.num for s in self.table.numbered.symbols if s.kind == OPEN and s.op == OP_GROUP}
        )

    def _default_deadline_s(self) -> Optional[float]:
        slo = self.config.slo
        return slo.default_deadline_s if slo is not None else None

    def _speculation(
        self, slpf: SLPF, bucket: Optional[Tuple[int, int]]
    ) -> Optional[Dict[str, Any]]:
        """Observed speculation width of one parse (sparse backend only):
        the feasible-start-set size of each chunk of this text's bucket,
        recomputed on the host; all-PAD padding chunks are left out.  Also
        folded into the per-bucket aggregates of ``stats()`` and the
        ``speculation_width`` histogram."""
        if self.backend_name != "sparse":
            return None
        eng = self.engine
        c, k = bucket if bucket is not None else eng.bucket_shape(
            len(slpf.classes), self.config.n_chunks
        )
        chunks = eng._pad_to(slpf.classes, c, k)
        widths = feasible_start_widths(
            eng.tables.N.cpu().numpy(), chunks, depth=self.config.feasible_depth
        )
        real = widths[widths >= 0]
        spec = {
            "width_mean": float(real.mean()) if real.size else 0.0,
            "width_max": int(real.max()) if real.size else 0,
            "n_chunks_real": int(real.size),
            "product_rows": int(eng.backend._width),
            "ell_pad": int(eng.tables.ell_pad),
            "depth": self.config.feasible_depth,
        }
        agg = self._spec_buckets.setdefault(
            (c, k), {"parses": 0, "width_mean": 0.0, "width_max": 0}
        )
        agg["parses"] += 1
        agg["width_mean"] += (spec["width_mean"] - agg["width_mean"]) / agg["parses"]
        agg["width_max"] = max(agg["width_max"], spec["width_max"])
        self.obs.metrics.histogram("speculation_width").observe(spec["width_max"])
        return spec

    def _wrap(
        self,
        slpf: SLPF,
        *,
        bucket: Optional[Tuple[int, int]] = None,
        latency_s: Optional[float] = None,
        trace_id: Optional[str] = None,
        tenant: Optional[str] = None,  # ticket plumbing: one automaton here
    ) -> ParseResult:
        return ParseResult(
            forest=slpf,
            backend=self.backend_name,
            bucket=bucket,
            latency_s=latency_s,
            n_chunks=self.config.n_chunks,
            speculation=self._speculation(slpf, bucket),
            trace_id=trace_id,
        )

    def _verdict(self) -> str:
        """The verdict the services' pattern guard holds: the analysis made
        at construction, or "ok" where none was (``analyze="off"``)."""
        return self._analysis.verdict if self._analysis is not None else "ok"

    @property
    def parse_service(self) -> ParseService:
        """The batched request service (built lazily, facade-owned)."""
        if self._parse_service is None:
            c = self.config
            self._parse_service = ParseService._internal(
                self.engine,
                max_batch=c.max_batch,
                n_chunks=c.n_chunks,
                max_pending=c.max_pending,
            )
            # the facade's traffic is one tenant; its weight only matters
            # when sharing a queue (tests / embedders may add more)
            self._parse_service.register_tenant("default", weight=c.weight)
            self._parse_service.set_pattern_guard(self._verdict(), c.analyze)
        return self._parse_service

    @property
    def stream_service(self) -> StreamService:
        """The streaming session service (built lazily, facade-owned)."""
        if self._stream_service is None:
            c = self.config
            self._stream_service = StreamService._internal(
                self.engine,
                max_batch=c.max_batch,
                first_seal_len=c.first_seal_len,
                max_seal_len=c.max_seal_len,
                cache_budget_bytes=c.cache_budget_bytes,
                max_pending_chars=c.max_pending_chars,
            )
            self._stream_service.set_pattern_guard(self._verdict(), c.analyze)
        return self._stream_service

    # ---------------------------------------------------------------- parse

    def submit(self, text, *, deadline_s: Optional[float] = None) -> ParseTicket:
        """Deadline-aware asynchronous submission; returns a ``ParseTicket``.

        Admission runs now: a bucket whose observed p99 exceeds the
        remaining ``deadline_s`` raises ``AdmissionError`` before any
        queueing; ``max_pending`` overflow raises ``BudgetExceeded``.  No
        deadline (and no config default) admits unconditionally.
        """
        return self._submit(text, deadline_s)

    def _submit(self, text, deadline_s: Optional[float], root=None) -> ParseTicket:
        if deadline_s is None:
            deadline_s = self._default_deadline_s()
        svc = self.parse_service
        req = svc.submit_request(text, deadline_s=deadline_s, root=root)
        return ParseTicket(self, svc, req, deadline_s=deadline_s)

    def parse(self, text, *, deadline_s: Optional[float] = None) -> ParseResult:
        """Parse one text synchronously: ``submit(...).result()``, so the
        same admission, batching, stats and SLO grades as ``submit``.

        With tracing on it runs that same route inside a live
        ``parse.request`` span, the root of the request's trace.

        On a mesh config this is the long-text route, queue-free: the
        engine's single-text distributed program shards the chunk dim over
        every chunk mesh axis ('pod' × 'data'); ``parse_batch`` keeps batch
        slots over 'data' and chunks over 'pod'.
        """
        if self.engine.mesh is not None:
            return self._parse_on_mesh(text, deadline_s)
        obs = self.obs
        with obs.span("parse.request", trace_id=obs.new_trace_id(),
                      backend=self.backend_name) as root:
            ticket = self._submit(text, deadline_s, root=root)
            root.set_attr("bucket", list(ticket._request.bucket))
            root.set_attr("n_chars", len(ticket._request.classes))
            return ticket.result()

    def _parse_on_mesh(self, text, deadline_s: Optional[float]) -> ParseResult:
        """The mesh's queue-free long-text route, with the service's
        admission and stats; traced, one ``phase.device_parse`` span."""
        if deadline_s is None:
            deadline_s = self._default_deadline_s()
        svc = self.parse_service
        classes = self.engine.classes_of_text(text)
        bucket = self.engine.bucket_shape(len(classes), self.config.n_chunks)
        svc._admit(bucket, deadline_s)
        stats = svc._buckets.setdefault(bucket, BucketStats())
        obs = self.obs
        trace_id = obs.new_trace_id()
        t0 = time.perf_counter()
        # its phases are separated by collectives, not host seams: one span
        # for the distributed program, ended when the forest is on the host
        with obs.span("parse.request", trace_id=trace_id, bucket=list(bucket),
                      backend=self.backend_name, n_chars=len(classes)):
            with obs.span("phase.device_parse", n_chars=len(classes)):
                slpf = self.engine.parse(classes, n_chunks=self.config.n_chunks)
        latency = time.perf_counter() - t0
        # admission and the SLO grades learn this route too; it never
        # queues, so the whole latency is compute
        stats.record(latency, queue_s=0.0, compute_s=latency)
        m = obs.metrics
        m.counter("requests_total", service="parse").inc()
        m.counter("served_total", service="parse").inc()
        m.counter("chars_total", service="parse").inc(len(classes))
        return self._wrap(slpf, bucket=bucket, latency_s=latency, trace_id=trace_id)

    def parse_batch(
        self, texts: Sequence, *, deadline_s: Optional[float] = None
    ) -> List[ParseResult]:
        """Parse many texts through the bucket-batched service; results in
        input order.  Admission is all-or-nothing: if any text is rejected,
        the already-queued ones are cancelled before the error propagates."""
        tickets: List[ParseTicket] = []
        try:
            for t in texts:
                tickets.append(self.submit(t, deadline_s=deadline_s))
        except Exception:
            for ticket in tickets:
                ticket.cancel()
            raise
        return [t.result() for t in tickets]

    def open_stream(self, *, weight: Optional[float] = None) -> ParserStream:
        """Open a streaming session over the shared prefix-cache service;
        close it with ``.close()`` / ``with``.  ``weight`` sets its
        weighted-fair share of the batched absorption (default: the
        config's ``weight``)."""
        w = self.config.weight if weight is None else weight
        return ParserStream(self, self.stream_service, self.stream_service.open(weight=w))

    def count_accepting(self, text) -> int:
        return self.parse(text).count_trees()

    # ---------------------------------------------------------------- stats

    def _slo_grade(self, buckets: Mapping) -> Dict[Any, Dict[str, Any]]:
        slo = self.config.slo
        out: Dict[Any, Dict[str, Any]] = {}
        for bucket, b in buckets.items():
            grade: Dict[str, Any] = {
                "p50_s": b["p50_latency_s"],
                "p99_s": b["p99_latency_s"],
                "queue_depth": b["queue_depth"],
            }
            if slo is not None and slo.p50_s is not None:
                grade["p50_ok"] = b["p50_latency_s"] <= slo.p50_s
            if slo is not None and slo.p99_s is not None:
                grade["p99_ok"] = b["p99_latency_s"] <= slo.p99_s
            out[bucket] = grade
        return out

    def _hlo_static_cost(self, ps: Optional[Dict]) -> Optional[Dict[str, Any]]:
        """Per-bucket static modeled cost of the phase programs
        (``ParserEngine.phase_static_cost``: one trace of each phase a
        bucket, memoized on the engine), keyed ``"<c>x<k>"`` — attached
        only when tracing is on and the ObsConfig keeps ``hlo`` enabled.
        Mesh engines skip it, as the reference's do: their phases run
        between collectives in one device program, with no per-phase
        program to attribute."""
        cfg = self.obs.config
        if not (self.obs.enabled and cfg.hlo) or self.engine.mesh is not None:
            return None
        buckets = ps["buckets"] if ps else {}
        return {f"{c}x{k}": self.engine.phase_static_cost(c, k) for c, k in buckets}

    def stats(self) -> Dict[str, Any]:
        """One view over both services, the metrics registry and the SLO
        targets, with the reference's keys.

        ``parse``/``stream`` are the raw service stats (None until the
        service is first used); ``metrics`` is the registry snapshot;
        ``slo`` grades every observed bucket against the config targets
        (``p50_ok``/``p99_ok`` appear only when targets are set);
        ``speculation`` (sparse backend only, else None) reports the carried
        product rows S against ℓp and the per-bucket observed widths.
        ``analysis`` is the static analyzer's report (``analysis`` as a
        dict), computed lazily and memoized; ``hlo`` is the static cost of
        every observed bucket (``_hlo_static_cost``), or None.
        """
        slo = self.config.slo
        ps = self._parse_service.stats if self._parse_service is not None else None
        ss = self._stream_service.stats if self._stream_service is not None else None
        if self.backend_name == "sparse":
            speculation: Optional[Dict[str, Any]] = {
                "product_rows": int(self.engine.backend._width),
                "ell_pad": int(self.engine.tables.ell_pad),
                "depth": self.config.feasible_depth,
                "buckets": {b: dict(v) for b, v in self._spec_buckets.items()},
            }
        else:
            speculation = None
        return {
            "backend": self.backend_name,
            "compile_count": self.compile_count,
            "pending": (ps["pending"] if ps else 0) + (ss["pending"] if ss else 0),
            "parse": ps,
            "stream": ss,
            "metrics": self.obs.metrics.snapshot(),
            "hlo": self._hlo_static_cost(ps),
            "analysis": self._analyze().to_dict(),
            "speculation": speculation,
            "slo": {
                "targets": dataclasses.asdict(slo) if slo is not None else None,
                "parse_buckets": self._slo_grade(ps["buckets"] if ps else {}),
                "stream_buckets": self._slo_grade(ss["buckets"] if ss else {}),
            },
        }

    def close(self) -> None:
        """Flush observability sinks (the JSONL span log, if configured)."""
        self.obs.close()

    def __enter__(self) -> "Parser":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# -------------------------------------------------------------------- fleet


class ParserFleet:
    """Many regexes, one device: the multi-tenant facade.

        fleet = repro_torch.ParserFleet({
            "errors":  "ERROR: .*",
            "api":     ParserConfig(regex="GET /[a-z]+", weight=2.0),
        })
        fleet.parse("errors", line).ok
        fleet.parse_batch([("errors", l1), ("api", l2), ...])

    Each tenant is a ``ParserConfig`` (or pattern string / config dict), but
    instead of one engine per config, every tenant's tables are padded into
    a shared pow2 automaton bucket (``core/fleet.py``) and a bucket's
    requests are served by ONE dispatch: one launch of each parse kernel
    for every tenant in it, each result equal to that tenant's solo
    ``Parser``'s.  Table builds go through a process-wide compile cache
    keyed on (normalized regex, backend, ℓp bucket).

    Serving is the weighted-fair scheduler (``FleetParseService``): each
    tenant's ``weight`` is its fair share, ``max_pending`` its own queue
    budget, ``slo`` its own grading targets in ``stats()``.  ``device=None``
    means the card.  Tenants share one device's engine pool, so a tenant
    config with ``mesh`` is refused (``ValueError``), as in the reference.
    """

    def __init__(
        self,
        tenants: Optional[Mapping[str, Union[ParserConfig, str, Mapping[str, Any]]]] = None,
        *,
        max_batch: int = 32,
        max_pending: Optional[int] = None,
        obs: Union[ObsConfig, Mapping[str, Any], None] = None,
        device=None,
    ):
        from .core.fleet import FleetEngine

        if obs is not None and isinstance(obs, Mapping):
            obs = ObsConfig(**dict(obs))
        self.obs = ObsHandle.from_config(obs)
        self.engine = FleetEngine(obs=self.obs, device=device)
        self._service = FleetParseService._internal(
            self.engine, max_batch=max_batch, max_pending=max_pending
        )
        self._configs: Dict[str, ParserConfig] = {}
        # tenant -> backend actually served (backend="auto" resolved)
        self._backends: Dict[str, str] = {}
        for name, cfg in (tenants or {}).items():
            self.add(name, cfg)

    # ---------------------------------------------------------------- tenants

    def add(
        self,
        name: str,
        config: Union[ParserConfig, str, Mapping[str, Any]],
        *,
        matrices: Optional[ParserMatrices] = None,
    ) -> "ParserFleet":
        """Register a tenant (chainable).  ``matrices`` bypasses the regex
        compile path for prebuilt tables (``Parser.from_matrices``' analog)."""
        from .core.fleet import TenantSpec

        if isinstance(config, str):
            config = ParserConfig(regex=config)
        elif isinstance(config, Mapping):
            config = ParserConfig.from_dict(config)
        if not isinstance(config, ParserConfig):
            raise TypeError(
                f"fleet tenant config must be a ParserConfig, pattern string, "
                f"or config dict; got {type(config).__name__}"
            )
        if config.mesh is not None:
            raise ValueError(
                "fleet tenants run on the shared single-device engine pool; "
                "mesh configs are not supported (use a dedicated Parser)"
            )
        # static analysis at admission: Parser construction's policy, but a
        # reject is an admission event, and the fleet keeps serving the rest
        if config.analyze != "off" and matrices is None:
            from .analyze.pattern import cached_report

            report = cached_report(config.regex, max(4, config.feasible_depth))
            m = self.obs.metrics
            m.counter("analyzer_verdicts_total", verdict=report.verdict).inc()
            if report.verdict == "pathological":
                if config.analyze == "strict":
                    m.counter(
                        "admission_rejects_total", service="fleet", cause="pathological"
                    ).inc()
                    raise PathologicalPatternError(
                        f"fleet tenant {name!r}: pattern {config.regex!r} is "
                        "pathologically ambiguous (an iterator with a nullable body "
                        "admits unboundedly many parse trees per text); "
                        'analyze="strict" rejects it at admission',
                        pattern=config.regex,
                        ambiguity=report.ambiguity,
                    )
                warnings.warn(
                    f"repro_torch: fleet tenant {name!r} pattern {config.regex!r} is "
                    "pathologically ambiguous — forest size is unbounded per text "
                    '(analyze="strict" rejects such tenants)',
                    UserWarning,
                    stacklevel=2,
                )
        spec = TenantSpec(
            regex=config.regex,
            backend=config.backend,
            kernel=config.kernel,
            feasible_depth=config.feasible_depth,
            n_chunks=config.n_chunks,
            min_chunk_len=config.min_chunk_len,
            weight=config.weight,
            max_pending=config.max_pending,
        )
        self._service.add_tenant(name, spec, matrices=matrices)
        self._configs[name] = config
        # the engine resolves backend="auto": record what the tenant runs on
        self._backends[name] = self.engine.tenant(name).spec.backend
        return self

    @property
    def tenants(self) -> Dict[str, ParserConfig]:
        return dict(self._configs)

    def config_of(self, tenant: str) -> ParserConfig:
        try:
            return self._configs[tenant]
        except KeyError:
            raise KeyError(f"unknown fleet tenant {tenant!r}") from None

    def groups_of(self, tenant: str) -> List[int]:
        """Numbered group ids of one tenant's pattern (``Parser.groups``'
        analog), usable with ``ParseResult.matches``."""
        table = self.engine.tenant(tenant).tables.matrices.table
        return sorted(
            {s.num for s in table.numbered.symbols if s.kind == OPEN and s.op == OP_GROUP}
        )

    # ------------------------------------------------------------------ parse

    def _default_deadline_s(self, tenant: str) -> Optional[float]:
        slo = self.config_of(tenant).slo
        return slo.default_deadline_s if slo is not None else None

    def submit(self, tenant: str, text, *, deadline_s: Optional[float] = None) -> ParseTicket:
        """Deadline-aware asynchronous submission for one tenant: the
        admission contract of ``Parser.submit`` plus the tenant's own
        ``max_pending`` budget (``BudgetExceeded``)."""
        if deadline_s is None:
            deadline_s = self._default_deadline_s(tenant)
        req = self._service.submit_request(text, deadline_s=deadline_s, tenant=tenant)
        return ParseTicket(self, self._service, req, deadline_s=deadline_s)

    def parse(self, tenant: str, text, *, deadline_s: Optional[float] = None) -> ParseResult:
        """Parse one text under one tenant's automaton (sync)."""
        return self.submit(tenant, text, deadline_s=deadline_s).result()

    def parse_batch(
        self,
        items: Sequence[Tuple[str, Any]],
        *,
        deadline_s: Optional[float] = None,
    ) -> List[ParseResult]:
        """Parse ``[(tenant, text), ...]``; results in input order.

        Same-bucket requests, across tenants, share one dispatch a step
        (up to ``max_batch`` of them).  Admission is all-or-nothing, as in
        ``Parser.parse_batch``.
        """
        tickets: List[ParseTicket] = []
        try:
            for tenant, text in items:
                tickets.append(self.submit(tenant, text, deadline_s=deadline_s))
        except Exception:
            for ticket in tickets:
                ticket.cancel()
            raise
        return [t.result() for t in tickets]

    def _wrap(
        self,
        slpf: SLPF,
        *,
        bucket=None,
        latency_s: Optional[float] = None,
        trace_id: Optional[str] = None,
        tenant: Optional[str] = None,
    ) -> ParseResult:
        cfg = self._configs.get(tenant) if tenant is not None else None
        backend = self._backends.get(tenant) if tenant is not None else None
        return ParseResult(
            forest=slpf,
            backend=backend if backend is not None else "fleet",
            bucket=bucket,
            latency_s=latency_s,
            n_chunks=cfg.n_chunks if cfg is not None else None,
            speculation=None,
            trace_id=trace_id,
        )

    # ------------------------------------------------------------------ stats

    @property
    def compile_count(self) -> int:
        """Distinct dispatch shapes fleet-wide: O(#buckets × shapes),
        independent of the tenant count."""
        return self.engine.compile_count

    def stats(self) -> Dict[str, Any]:
        """The fleet-wide serving view: each tenant's weighted-fair and
        latency state with an SLO grade against ITS config targets, and the
        bucket economy (tenants a bucket, compile count, the process-wide
        table cache), the number that should stay flat as tenants
        multiply."""
        from .core.fleet import table_cache_stats

        s = self._service.stats
        tenants: Dict[str, Any] = {}
        for name, d in s["tenants"].items():
            cfg = self._configs.get(name)
            grade: Dict[str, Any] = {
                "p50_s": d["p50_latency_s"],
                "p99_s": d["p99_latency_s"],
            }
            slo = cfg.slo if cfg is not None else None
            if slo is not None and slo.p50_s is not None:
                grade["p50_ok"] = d["p50_latency_s"] <= slo.p50_s
            if slo is not None and slo.p99_s is not None:
                grade["p99_ok"] = d["p99_latency_s"] <= slo.p99_s
            tenants[name] = {**d, "backend": self._backends.get(name), "slo": grade}
        return {
            "backend": "fleet",
            "pending": s["pending"],
            "peak_queue_depth": s["peak_queue_depth"],
            "batches_run": s["batches_run"],
            "compile_count": self.compile_count,
            "buckets": s["buckets"],
            "tenants": tenants,
            "fleet": {
                "n_tenants": len(self._configs),
                "n_buckets": self.engine.n_buckets,
                "bucket_sizes": {
                    "|".join(map(str, k)): v
                    for k, v in sorted(self.engine.bucket_sizes().items())
                },
                "table_cache": table_cache_stats(),
            },
            "metrics": self.obs.metrics.snapshot(),
        }

    def close(self) -> None:
        """Flush observability sinks (the JSONL span log, if configured)."""
        self.obs.close()

    def __enter__(self) -> "ParserFleet":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
