"""The parse engine: padded tables, bucketed chunk grids, three phases.

The reference's layers (``repro/core/engine.py``), in PyTorch:

  tables    ``EngineTables`` — N (A+1, ℓp, ℓp) f32 with the PAD class the
            identity, I/F (ℓp,) f32, on one device.  ``from_arrays`` takes
            already-padded arrays, such as the reference's own tables, so
            both packages can run identical tables.
  core      ``make_parse_core`` — reach → join (+ the text-start column) →
            build&merge, one call over a (c, k) or (B, c, k) chunk grid.
  phases    ``PhasePrograms`` — the same phases as separate callables whose
            boundaries (products, entries, packed columns) are tensors; the
            seam the streaming layer (``core/stream.py``) caches across
            calls, and the traced route (``parse_traced``) times.
  engine    ``ParserEngine`` — texts → classes → chunk grids bucketed to
            power-of-two chunk lengths, grouped into power-of-two batches,
            one core call per bucket, SLPF assembly on the host.  Built
            with ``mesh=`` (``launch/mesh.py``), its ``parse`` /
            ``parse_batch`` run through the mesh layer, ``dist``
            (``core/distributed.py``).

Texts pad with the PAD class, a semantic no-op, so bucket padding never
changes a result.  PyTorch runs eagerly: there is no trace to count, and
``compile_count`` counts the distinct shapes run — each (B, c, k) batch of
the fused core and each input shape of a phase callable — which is the
number of programs the reference compiles for the same traffic.  Each new
one also counts into the ``compiled_programs_total`` metric of the engine's
``obs`` handle (``obs/``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..kernels.checks import check_class_ids
from ..obs import ObsHandle
from .backend import ParserBackend, get_backend, next_pow2, pack_columns_u32
from .matrices import ParserMatrices, build_matrices
from .segments import SegmentTable
from .slpf import SLPF


# ---------------------------------------------------------------- tables


@dataclass
class EngineTables:
    """Device-resident parser tables for one RE."""

    N: torch.Tensor            # (A+1, ℓp, ℓp) f32 — PAD class (index A) = identity
    I: torch.Tensor            # (ℓp,) f32
    F: torch.Tensor            # (ℓp,) f32
    byte_to_class: torch.Tensor  # (256,) int32
    ell: int                   # true segment count
    ell_pad: int               # padded to a multiple of the lane pad
    pad_class: int

    @classmethod
    def from_arrays(
        cls,
        N: np.ndarray,
        I: np.ndarray,
        F: np.ndarray,
        byte_to_class: np.ndarray,
        ell: int,
        pad_class: int,
        device: Union[str, torch.device],
    ) -> "EngineTables":
        """Tables from padded numpy arrays (e.g. ``np.asarray`` of the
        reference engine's tables), placed on ``device``."""
        N = np.asarray(N, dtype=np.float32)
        return cls(
            N=torch.tensor(N, device=device),
            I=torch.tensor(np.asarray(I, dtype=np.float32), device=device),
            F=torch.tensor(np.asarray(F, dtype=np.float32), device=device),
            byte_to_class=torch.tensor(
                np.asarray(byte_to_class, dtype=np.int32), device=device
            ),
            ell=int(ell),
            ell_pad=int(N.shape[-1]),
            pad_class=int(pad_class),
        )

    @classmethod
    def from_matrices(
        cls, m: ParserMatrices, lane_pad: int = 32, device="cuda"
    ) -> "EngineTables":
        ell = m.n_segments
        lp = max(lane_pad, ((ell + lane_pad - 1) // lane_pad) * lane_pad)
        N = np.zeros((m.N.shape[0], lp, lp), dtype=np.float32)
        N[:, :ell, :ell] = m.N.astype(np.float32)
        N[-1] = np.eye(lp, dtype=np.float32)  # PAD = identity over the padded space
        I = np.zeros(lp, dtype=np.float32)
        I[:ell] = m.I
        F = np.zeros(lp, dtype=np.float32)
        F[:ell] = m.F
        return cls.from_arrays(N, I, F, m.byte_to_class, ell, m.pad_class, device)


# ------------------------------------------------------------- parse core


def join_with_col0(backend: ParserBackend, P, I, F):
    """Join over stacked products (…, c, ·), plus the packed text-start
    column C₀ = I ∧ P₀ᵀ Ĵ₀.  Returns (Jf, Jb, packed C₀ (…, W))."""
    Jf, Jb = backend.join(P, I, F)
    col0 = backend.start_column(P, I, Jb[..., 0, :])
    return Jf, Jb, pack_columns_u32(col0)


def make_parse_core(backend: ParserBackend):
    """``core(N, I, F, chunks) -> (packed C₀ (…, W), packed cols (…, c, k, W))``
    over a (c, k) chunk grid or a (B, c, k) batch of them."""

    def parse_core(N, I, F, chunks):
        P = backend.reach(N, chunks)
        Jf, Jb, col0p = join_with_col0(backend, P, I, F)
        return col0p, backend.build_merge_packed(N, chunks, Jf, Jb)

    return parse_core


class PhasePrograms:
    """The three phases as separate callables with tensor boundaries:

      reach        (N, chunks (…, k))           → products (…, ·)
      compose      (later, earlier)             → later ⊗ earlier
      join         (P (…, c, ·), I, F)          → (Jf, Jb, packed C₀)
      build_merge  (N, chunks, Jf, Jb)          → (…, k, W) packed columns

    Products are backend-owned; entries are f32 and columns int32 words.
    No phase writes into its inputs, so callers may cache products and share
    them (the streaming snapshots do).  ``on_shape(key)`` is told the phase
    and input shapes of every call — where the reference traces one program
    per input shape.
    """

    def __init__(self, backend: ParserBackend, on_shape: Optional[Callable] = None):
        note = on_shape or (lambda key: None)

        def reach(N, chunks):
            note(("reach", tuple(chunks.shape)))
            return backend.reach(N, chunks)

        def compose(later, earlier):
            note(("compose", tuple(later.shape), tuple(earlier.shape)))
            return backend.compose(later, earlier)

        def join(P, I, F):
            note(("join", tuple(P.shape)))
            return join_with_col0(backend, P, I, F)

        def build_merge(N, chunks, Jf, Jb):
            note(("build_merge", tuple(chunks.shape)))
            return backend.build_merge_packed(N, chunks, Jf, Jb)

        self.backend = backend
        self.reach: Callable = reach
        self.compose: Callable = compose
        self.join: Callable = join
        self.build_merge: Callable = build_merge


def resolve_device(device) -> torch.device:
    """``None`` means the card; a CUDA device must exist — no CPU fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is available; "
            'pass device="cpu" (with backend="torch") to run on the CPU'
        )
    return dev


def unpack_columns(packed: np.ndarray, n: int) -> np.ndarray:
    """(rows, W) uint32 little-endian-bit words → (rows, n) bool.

    Equal to ``matrices.unpack_bits(packed, n)``, through byte-wise
    ``np.unpackbits`` (the host side of a multi-megabyte parse)."""
    as_bytes = np.ascontiguousarray(packed, dtype="<u4").view(np.uint8)
    bits = np.unpackbits(as_bytes, axis=-1, bitorder="little")
    return bits[:, :n].astype(bool)


# ---------------------------------------------------------------- engine


class ParserEngine:
    """Single-device engine: backend-pluggable, shape-bucketed, batched.

    ``obs`` is the observability handle every layer over this engine
    records into (streams, both services, the facade); the default is a
    disabled tracer with a live metrics registry.  ``mesh`` (a
    ``launch.mesh.ParseMesh``) and ``mesh_rules`` (a
    ``parallel.sharding.MeshRules``) make it a mesh engine: every rank of
    the mesh builds the same engine and makes the same calls."""

    def __init__(
        self,
        matrices_or_table: Union[ParserMatrices, SegmentTable],
        *,
        backend: Union[str, ParserBackend] = "cuda",
        min_chunk_len: int = 8,
        device=None,
        mesh=None,
        mesh_rules=None,
        obs: Optional[ObsHandle] = None,
    ):
        if isinstance(matrices_or_table, SegmentTable):
            matrices = build_matrices(matrices_or_table)
        else:
            matrices = matrices_or_table
        self.matrices = matrices
        self.table = matrices.table
        self.backend = get_backend(backend)
        self.device = resolve_device(device)
        if self.backend.needs_cuda and self.device.type != "cuda":
            raise ValueError(
                f"backend {self.backend.name!r} runs only on the card, got "
                f"device {str(self.device)!r} (use backend='torch' on the CPU)"
            )
        self.tables = EngineTables.from_matrices(
            matrices, lane_pad=self.backend.min_lane_pad, device=self.device
        )
        # table-dependent backends (the sparse width S) bind their product
        # shapes here, before any phase runs
        self.backend.bind_tables(self.tables)
        self.min_chunk_len = max(1, min_chunk_len)
        self.mesh = mesh
        self.mesh_rules = mesh_rules
        self._dist = None
        self.obs = obs if obs is not None else ObsHandle()
        self._seen_batch_shapes: set = set()
        self._seen_phase_shapes: set = set()
        self.phases = PhasePrograms(self.backend, on_shape=self._note_phase_shape)
        self._core = make_parse_core(self.backend)

    @property
    def compile_count(self) -> int:
        """Distinct shapes run so far: (B, c, k) batches of the fused core
        (one per bucket and batch-slot count) plus phase-program input
        shapes — the reference's compiled-program count."""
        return len(self._seen_batch_shapes) + len(self._seen_phase_shapes)

    def _bump_compiles(self) -> None:
        self.obs.metrics.counter("compiled_programs_total").inc()

    def _note_phase_shape(self, key) -> None:
        if key not in self._seen_phase_shapes:
            self._seen_phase_shapes.add(key)
            self._bump_compiles()

    @property
    def dist(self):
        """The mesh layer (``core/distributed.py``) of an engine built with
        ``mesh=``; None on a single-device engine.  Built lazily."""
        if self.mesh is None:
            return None
        if self._dist is None:
            from .distributed import DistributedEngine

            self._dist = DistributedEngine(self, self.mesh, rules=self.mesh_rules)
        return self._dist

    def classes_of_text(self, text) -> np.ndarray:
        if isinstance(text, (bytes, str)):
            return self.matrices.classes_of_text(text)
        return np.asarray(text, dtype=np.int32)

    def bucket_shape(self, n: int, n_chunks: int) -> Tuple[int, int]:
        """Static (c, k) chunk grid for a text of length ``n``: c = n_chunks,
        k the next power of two ≥ max(min_chunk_len, ⌈n / c⌉)."""
        c = max(1, n_chunks)
        k = next_pow2(max(self.min_chunk_len, -(-n // c)))
        return c, k

    def pad_chunks(self, classes: np.ndarray, n_chunks: int) -> np.ndarray:
        """Pad with the identity PAD class to ``n_chunks`` equal chunks of
        ⌈n / n_chunks⌉ (unbucketed)."""
        n = len(classes)
        c = max(1, n_chunks)
        k = max(1, -(-n // c))
        return self._pad_to(classes, c, k)

    def _pad_to(self, classes: np.ndarray, c: int, k: int) -> np.ndarray:
        padded = np.full(c * k, self.tables.pad_class, dtype=np.int32)
        padded[: len(classes)] = classes
        return padded.reshape(c, k)

    def chunks_tensor(self, chunks: np.ndarray) -> torch.Tensor:
        """A host chunk grid as an int32 tensor on the engine's device, its
        class ids range-checked here on the host (the kernels do not)."""
        chunks = np.ascontiguousarray(chunks, dtype=np.int32)
        check_class_ids(chunks, self.tables.N.shape[0])
        return torch.from_numpy(chunks).to(self.device)

    def run(self, chunks: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The fused core on a (c, k) or (B, c, k) grid already on the device:
        returns (packed C₀ (…, W), packed columns (…, c, k, W)) int32."""
        t = self.tables
        return self._core(t.N, t.I, t.F, chunks)

    # --------------------------------------------------------------- parse

    def parse(self, text, n_chunks: int = 8) -> SLPF:
        """Parse one text (a batch of one; empty texts take the same path).

        On a mesh engine this is the long-text route: the chunk dim shards
        over every chunk axis ('pod' × 'data')."""
        if self.mesh is not None:
            return self.dist.parse(text, n_chunks=n_chunks)
        return self.parse_batch([text], n_chunks=n_chunks)[0]

    def parse_batch(self, texts: Sequence, n_chunks: int = 8) -> List[SLPF]:
        """Parse many texts: grouped by (c, k) bucket, each group padded to
        a power-of-two number of batch rows (extra rows all PAD), one core
        call per group.  On a mesh engine the groups take the distributed
        batched route: batch slots over 'data', chunks over 'pod'."""
        if self.mesh is not None:
            return self.dist.parse_batch(texts, n_chunks=n_chunks)
        classes_list = [self.classes_of_text(t) for t in texts]
        groups: Dict[Tuple[int, int], List[int]] = {}
        for i, cls in enumerate(classes_list):
            groups.setdefault(self.bucket_shape(len(cls), n_chunks), []).append(i)

        m = self.obs.metrics
        results: List[Optional[SLPF]] = [None] * len(texts)
        for (c, k), idxs in sorted(groups.items()):
            B = next_pow2(len(idxs))
            # program-cache accounting: a (B, c, k) shape seen before reuses
            # its program; a new one is the reference's re-jit event
            if (B, c, k) in self._seen_batch_shapes:
                m.counter("bucket_cache_hits_total").inc()
            else:
                self._seen_batch_shapes.add((B, c, k))
                m.counter("bucket_cache_misses_total").inc()
                self._bump_compiles()
            batch = np.full((B, c, k), self.tables.pad_class, dtype=np.int32)
            for row, i in enumerate(idxs):
                batch[row] = self._pad_to(classes_list[i], c, k)
            col0s, colss = self.run(self.chunks_tensor(batch))
            col0s = col0s.cpu().numpy()
            colss = colss.cpu().numpy()
            for row, i in enumerate(idxs):
                results[i] = self._assemble(col0s[row], colss[row], classes_list[i])
        return results  # type: ignore[return-value]

    def _assemble(self, col0, cols, classes) -> SLPF:
        """Packed C₀ (W,) and columns (c, k, W) → the SLPF of ``classes``."""
        n = len(classes)
        W = cols.shape[-1]
        packed = np.concatenate(
            [np.asarray(col0)[None], np.asarray(cols).reshape(-1, W)[:n]], axis=0
        ).view(np.uint32)
        columns = unpack_columns(packed, self.tables.ell)
        return SLPF(table=self.table, columns=columns, classes=classes)

    # -------------------------------------------------------- observability

    def parse_traced(self, text, n_chunks: int = 8) -> SLPF:
        """Parse one text with per-phase spans (the observability route).

        Runs the phase programs — the same bodies the fused core composes,
        so the same bits — with each phase in its own span:
        ``phase.reach``, ``phase.join``, ``phase.build_merge`` and
        ``phase.host_build``.  Each device span synchronizes the engine's
        device before it closes, so it times the phase and not its launches.
        A mesh engine runs its distributed program in one
        ``phase.device_parse`` span instead: its phases are separated by
        collectives, not by host seams.
        """
        obs = self.obs
        classes = self.classes_of_text(text)
        if self.mesh is not None:
            with obs.span("phase.device_parse", n_chars=len(classes)):
                slpf = self.dist.parse(classes, n_chunks=n_chunks)
                self._sync()
            return slpf
        c, k = self.bucket_shape(len(classes), n_chunks)
        chunks = self.chunks_tensor(self._pad_to(classes, c, k))
        t = self.tables
        with obs.span("phase.reach", bucket=[c, k], n_chars=len(classes)):
            P = self.phases.reach(t.N, chunks)
            self._sync()
        with obs.span("phase.join", n_products=c):
            Jf, Jb, col0p = self.phases.join(P, t.I, t.F)
            self._sync()
        with obs.span("phase.build_merge", bucket=[c, k]):
            cols = self.phases.build_merge(t.N, chunks, Jf, Jb)
            self._sync()
        with obs.span("phase.host_build", n_chars=len(classes)):
            slpf = self._assemble(col0p.cpu().numpy(), cols.cpu().numpy(), classes)
        return slpf

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def count_accepting(self, text, n_chunks: int = 8) -> int:
        return self.parse(text, n_chunks).count_trees()


def _resolve_engine(
    matrices_or_engine,
    backend: Union[str, ParserBackend, None],
    mesh=None,
    mesh_rules=None,
    device=None,
) -> ParserEngine:
    """Shared constructor contract of everything layered on the engine
    (``ParseService``, ``StreamingParser``, ``StreamService``): accept
    matrices / a segment table and build an engine (backend ``cuda`` on the
    card unless told otherwise, on ``mesh`` when given), or accept a
    prebuilt ``ParserEngine`` — in which case ``backend=`` / ``device=`` /
    ``mesh=`` must not also be passed."""
    if isinstance(matrices_or_engine, ParserEngine):
        if backend is not None or device is not None or mesh is not None:
            raise ValueError(
                "pass backend=/device=/mesh= only when building the engine here; "
                "a prebuilt ParserEngine already owns its backend, device and mesh"
            )
        return matrices_or_engine
    return ParserEngine(
        matrices_or_engine,
        backend=backend if backend is not None else "cuda",
        device=device,
        mesh=mesh,
        mesh_rules=mesh_rules,
    )
