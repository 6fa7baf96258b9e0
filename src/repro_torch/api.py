"""The public parse API of the port: ``ParserConfig``, ``Parser``, ``ParseResult``.

It mirrors ``repro/api.py`` on the direct engine route: ``Parser.parse`` and
``parse_batch`` run the engine synchronously.  ``ParserConfig`` has the
reference's fields, validation and dict round trip; backend names map as
``jnp`` ↔ ``torch``, ``pallas`` ↔ ``cuda`` (``packed``, ``sparse`` and
``auto`` keep their names), and the port's default is ``cuda``.

``kernel=True`` selects the kernel path of ``packed`` (K4, and K2 for
build&merge) and ``sparse`` (K5 and K2); ``cuda`` is always kernels, as
``pallas`` is in the reference.  A
kernel path runs only on the card.  Settings whose subsystem is not ported
yet are accepted by ``ParserConfig`` (so configs round-trip between the
packages) and refused by ``Parser`` with ``NotImplementedError`` naming the
ROADMAP item.  ``analyze="warn"`` is accepted but does not analyze the
pattern yet.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

from .core.backend import PackedBackend, ParserBackend, SparseBackend, get_backend
from .core.engine import ParserEngine
from .core.matrices import ParserMatrices, build_matrices, feasible_start_widths
from .core.numbering import CLOSE, OP_GROUP, OPEN
from .core.segments import SegmentTable, compute_segments
from .core.slpf import SLPF

_HOST_MESH_AXES = ("pod", "data")
# every backend name a config may carry; only the registered ones
# (core/backend.py) run in this package today
_CONFIG_BACKENDS = ("auto", "cuda", "packed", "sparse", "torch")
# settings refused by Parser until their subsystem is ported (ROADMAP.md)
_UNPORTED_BACKENDS = {
    "auto": "Queue 1 item 10 (static analysis)",
}


def _is_pow2(x: int) -> bool:
    return x >= 1 and (x & (x - 1)) == 0


# ------------------------------------------------------------------ config


@dataclasses.dataclass(frozen=True)
class SLOTargets:
    """Per-bucket latency objectives (the reference's; not served yet)."""

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
class ObsConfig:
    """Observability knobs (the reference's; tracing is not ported yet)."""

    enabled: bool = False
    span_log: Optional[str] = None
    profiler: bool = False
    hlo: bool = True
    max_spans: int = 4096

    def __post_init__(self):
        if self.max_spans < 1:
            raise ValueError(f"max_spans must be >= 1, got {self.max_spans}")
        if self.span_log is not None and not isinstance(self.span_log, str):
            raise ValueError("span_log must be a path string or None")


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

    def build_backend(self) -> ParserBackend:
        """Instantiate the configured phase backend, kernel toggle applied
        (``cuda`` is always kernels).  ``auto`` is not a backend: it waits
        for the static analyzer, and ``get_backend`` refuses it."""
        if self.backend == "sparse":
            return SparseBackend(kernel=self.kernel, depth=self.feasible_depth)
        if self.backend == "packed" and self.kernel:
            return PackedBackend(kernel=True)
        return get_backend(self.backend)

    def _unported(self) -> Optional[str]:
        """Why ``Parser`` cannot serve this config yet (None if it can)."""
        if self.backend in _UNPORTED_BACKENDS:
            return f"backend={self.backend!r}: ROADMAP {_UNPORTED_BACKENDS[self.backend]}"
        if self.mesh is not None:
            return "mesh: ROADMAP Queue 1 item 11 (mesh distribution)"
        if self.slo is not None:
            return "slo: ROADMAP Queue 1 item 8 (streaming and services)"
        if self.obs is not None and self.obs.enabled:
            return "obs tracing: ROADMAP Queue 1 item 7 (observability)"
        if self.analyze == "strict":
            return 'analyze="strict": ROADMAP Queue 1 item 10 (static analysis)'
        return None


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


# ------------------------------------------------------------------- facade


class Parser:
    """The port's parser: a ``ParserConfig`` (or pattern) on one device.

        p = repro_torch.Parser("(a|b|ab)+")                    # the card
        p = repro_torch.Parser(cfg, device="cpu")              # backend="torch"

    ``device=None`` means the card, and raises when there is none.
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
        why = config._unported()
        if why is not None:
            raise NotImplementedError(f"not ported yet: {why}")
        self.config = config
        if matrices is None:
            matrices = build_matrices(compute_segments(config.regex))
        self.matrices = matrices
        self.engine = ParserEngine(
            matrices,
            backend=config.build_backend(),
            min_chunk_len=config.min_chunk_len,
            device=device,
        )

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

    @property
    def table(self) -> SegmentTable:
        return self.engine.table

    @property
    def groups(self) -> List[int]:
        """Numbered group ids extractable via ``ParseResult.matches``."""
        return sorted(
            {s.num for s in self.table.numbered.symbols if s.kind == OPEN and s.op == OP_GROUP}
        )

    def _speculation(self, slpf: SLPF, bucket: Tuple[int, int]) -> Optional[Dict[str, Any]]:
        """Observed speculation width of one parse (sparse backend only):
        the feasible-start-set size of each chunk of this text's bucket,
        recomputed on the host; all-PAD padding chunks are left out."""
        if self.backend_name != "sparse":
            return None
        eng = self.engine
        chunks = eng._pad_to(slpf.classes, *bucket)
        widths = feasible_start_widths(
            eng.tables.N.cpu().numpy(), chunks, depth=self.config.feasible_depth
        )
        real = widths[widths >= 0]
        return {
            "width_mean": float(real.mean()) if real.size else 0.0,
            "width_max": int(real.max()) if real.size else 0,
            "n_chunks_real": int(real.size),
            "product_rows": int(eng.backend._width),
            "ell_pad": int(eng.tables.ell_pad),
            "depth": self.config.feasible_depth,
        }

    def _wrap(self, slpf: SLPF, latency_s: float) -> ParseResult:
        bucket = self.engine.bucket_shape(len(slpf.classes), self.config.n_chunks)
        return ParseResult(
            forest=slpf,
            backend=self.backend_name,
            bucket=bucket,
            latency_s=latency_s,
            n_chunks=self.config.n_chunks,
            speculation=self._speculation(slpf, bucket),
        )

    def parse(self, text) -> ParseResult:
        """Parse one text synchronously."""
        t0 = time.perf_counter()
        slpf = self.engine.parse(text, n_chunks=self.config.n_chunks)
        return self._wrap(slpf, time.perf_counter() - t0)

    def parse_batch(self, texts: Sequence) -> List[ParseResult]:
        """Parse many texts (bucket-batched); results in input order.
        ``latency_s`` is the whole batch's time."""
        t0 = time.perf_counter()
        slpfs = self.engine.parse_batch(list(texts), n_chunks=self.config.n_chunks)
        latency = time.perf_counter() - t0
        return [self._wrap(s, latency) for s in slpfs]

    def count_accepting(self, text) -> int:
        return self.parse(text).count_trees()

    def close(self) -> None:
        """Release the parser.  The reference flushes its observability sinks
        here; the port has none until obs is ported (ROADMAP Queue 1 item 7),
        so there is nothing to flush yet."""

    def __enter__(self) -> "Parser":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
