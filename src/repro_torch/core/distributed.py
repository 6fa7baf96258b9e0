"""Mesh distribution of the parse: batch × chunk sharding over ranks.

The port of ``repro/core/distributed.py`` on ``torch.distributed``.  Every
route is the engine's own three-phase program on the backend's own phase
bodies (so on the ``cuda`` backend K1 / K4 / K5 reach, K3 in the join, K2
build&merge); only the placement differs, so the results are bit-identical
to ``ParserEngine.parse`` / ``parse_batch`` (OR-AND on {0,1} is exact).

The reference is one controller driving a ``shard_map`` over a device mesh.
Here each rank is a process running the same Python (``launch/mesh.py``
``ParseMesh``), which changes three things:

  * every rank must take the same dispatch sequence: a rank that skips a
    collective leaves the others waiting.  Decisions made from local state
    (the services' admission against observed latency) take rank 0's value
    (``agree``);
  * the packed columns come back sharded, where the reference's controller
    reads its sharded output as one array: one more gather of the int32
    columns gives every rank the same ``SLPF``;
  * the collectives are ``torch.distributed``'s, over the mesh's process
    groups (``transport``: NCCL or gloo, on the engine's device).

The product-stack all-gather contract
-------------------------------------

All structure between ranks flows through ONE tensor: the stacked chunk
products, chunks on one axis, each in the backend's product
representation ((ℓp, ℓp) f32 for ``torch`` / ``cuda``, (ℓp, W) int32 words
for ``packed``, (S, 1+W) feasible-start rows for ``sparse``).

  1. reach runs shard-local: each rank folds only its own chunk rows;
  2. the product stack is all-gathered once over the chunk mesh axes, in
     ``linear_index`` order (one group spanning all of them), giving every
     rank the whole stack;
  3. the join (``engine.join_with_col0``) runs replicated on it, giving
     every chunk's entries and the packed text-start column;
  4. each rank slices its own chunks' entries and runs build&merge
     shard-local;
  5. one gather of the packed columns (with the text-start column) over the
     batch and chunk axes stands for the reference controller's read of its
     sharded output: every rank assembles the same ``SLPF``.

``allgather_payload_bytes_total`` counts step 2's stack, as the reference
counts it; step 5 is not in it.  The streaming prefix cache's flattened leaf
frontier is the same payload: ``join_products`` gathers it and joins.

Routes
------

  parse          one text; the chunk dim takes every mesh axis the 'chunk'
                 rule names (('pod', 'data')).
  parse_batch    many texts; batch slots over 'data', the chunk dim keeps
                 'pod' (``MeshRules``' duplicate-axis dropping once 'batch'
                 is restricted to 'data'); step 2 runs over 'pod' only.
  join_products  the streaming route: a product stack → replicated (Jf, Jb,
                 packed C₀).

``ParserEngine(mesh=...)`` builds this layer lazily and routes ``parse`` /
``parse_batch`` through it, so ``ParseService``, ``StreamService`` and
``StreamingParser`` are mesh-aware without code of their own.  Chunk counts
round up to a multiple of the chunk ranks and batch slots to a power of two
and then to a multiple of the batch ranks (all-PAD rows and chunks are
identity, so the padding is free).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..launch.mesh import mesh_axes_size
from ..parallel.sharding import MeshRules, spec_axes
from .backend import next_pow2
from .engine import _resolve_engine, join_with_col0
from .scan import linear_index
from .slpf import SLPF


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def agreed(engine, value: float) -> float:
    """``value`` as rank 0 has it, on a mesh engine; ``value`` elsewhere
    (a single-device engine, a fleet engine)."""
    layer = getattr(engine, "dist", None)
    return value if layer is None else layer.agree(value)


class DistributedEngine:
    """Mesh-aware front-end over one ``ParserEngine``'s backend and buckets.

    Usually reached as ``ParserEngine(mesh=...).dist``; also built
    standalone from matrices / a segment table / a prebuilt engine.  Specs
    resolve through ``MeshRules``: the logical 'chunk' axis and the 'data'
    batch axis, filtered to the axes the mesh has.
    """

    def __init__(self, matrices_or_engine, mesh, *, backend=None, rules=None, device=None):
        self.engine = _resolve_engine(matrices_or_engine, backend, device=device)
        self.mesh = mesh
        self.rules = rules if rules is not None else MeshRules()
        # single-text route: the chunk dim takes every axis the 'chunk' rule names
        self.chunk_axes = self.rules.resolve_axes("chunk", mesh)
        # batched route: batch is pure DP over 'data'; the chunk dim keeps the rest
        bspec = self.rules.with_overrides(batch="data").resolve(("batch", "chunk"), mesh)
        self.batch_axes = spec_axes(bspec, 0)
        self.batch_chunk_axes = spec_axes(bspec, 1)
        self.gathers = 0           # all_gather calls made by this rank
        self._nbytes: Optional[int] = None

    # ------------------------------------------------------------- geometry

    @property
    def chunk_devices(self) -> int:
        """Ranks the single-text route splits the chunk dim across."""
        return mesh_axes_size(self.mesh, self.chunk_axes)

    @property
    def batch_devices(self) -> int:
        """Ranks the batched route splits the batch dim across."""
        return mesh_axes_size(self.mesh, self.batch_axes)

    @property
    def batch_chunk_devices(self) -> int:
        """Ranks the batched route splits the chunk dim across."""
        return mesh_axes_size(self.mesh, self.batch_chunk_axes)

    @property
    def transport(self) -> str:
        """What the gathers run on: ``"<group backend>:<device type>"``
        (``"gloo:cuda"``, ``"nccl:cuda"``, ``"gloo:cpu"``), or ``"local"``
        on the 1-rank mesh, which exchanges nothing."""
        if self.mesh.backend is None:
            return "local"
        return f"{self.mesh.backend}:{self.engine.device.type}"

    def _product_nbytes(self) -> int:
        """Bytes of ONE chunk product in the backend's representation, the
        unit of the all-gather payload accounting."""
        if self._nbytes is None:
            t = self.engine.tables
            eye = self.engine.backend.identity_product(t.ell_pad, device="cpu")
            self._nbytes = eye.numel() * eye.element_size()
        return self._nbytes

    def _count_allgather(self, n_products: int, gather_axes) -> None:
        """Record one dispatch's product-stack payload: the gathered
        stack's bytes (none where there are no gather axes)."""
        if not gather_axes:
            return
        self.engine.obs.metrics.counter("allgather_payload_bytes_total").inc(
            n_products * self._product_nbytes()
        )

    # ---------------------------------------------------------- collectives

    def _gather_list(self, x: torch.Tensor, axes: Sequence[str]) -> List[torch.Tensor]:
        """``x`` of every rank of ``mesh.group(axes)``, in ``linear_index``
        order over ``axes``."""
        group = self.mesh.group(axes)
        members = self.mesh.members(axes)
        if group is None or len(members) == 1:
            return [x]
        send = x.contiguous()
        out = [torch.empty_like(send) for _ in members]
        dist.all_gather(out, send, group=group)
        self.gathers += 1
        ordered: List[torch.Tensor] = [send] * len(members)
        for member, part in zip(members, out):
            ordered[linear_index(self.mesh, axes, rank=member)] = part
        return ordered

    def _gather(self, x: torch.Tensor, axes: Sequence[str], dim: int) -> torch.Tensor:
        """all_gather over ``axes`` concatenated along ``dim`` in
        ``linear_index`` order, on ``x``'s device; ``x`` itself when no
        rank shares the axes."""
        parts = self._gather_list(x, axes)
        return x if len(parts) == 1 else torch.cat(parts, dim=dim)

    def agree(self, value: float) -> float:
        """Rank 0's ``value`` on every rank (a broadcast; none on one rank).

        A decision taken from local state before a collective — admission
        against a bucket's observed latency — must be the same on every
        rank, or the ranks that skip the collective leave the others waiting.
        """
        if self.mesh.size == 1:
            return value
        t = torch.tensor([value], dtype=torch.float64, device=self.engine.device)
        dist.broadcast(t, src=0)
        return float(t.item())

    # -------------------------------------------------------------- program

    def _run(self, batch: np.ndarray, b_axes, c_axes) -> Tuple[np.ndarray, np.ndarray]:
        """One dispatch of a (B, c, k) host grid, batch rows over ``b_axes``
        and chunks over ``c_axes``: (packed C₀ (B, W), packed columns
        (B, c, k, W)) int32 host arrays, the same on every rank."""
        eng = self.engine
        t = eng.tables
        backend = eng.backend
        B, c, k = batch.shape
        bsz, csz = mesh_axes_size(self.mesh, b_axes), mesh_axes_size(self.mesh, c_axes)
        Bl, f = B // bsz, c // csz
        b, r = linear_index(self.mesh, b_axes), linear_index(self.mesh, c_axes)
        eng._note_phase_shape(("mesh", (B, c, k), tuple(b_axes), tuple(c_axes)))
        # every rank range-checks the whole grid, so all raise or none does
        grid = eng.chunks_tensor(batch)[b * Bl:(b + 1) * Bl, r * f:(r + 1) * f]
        P_local = backend.reach(t.N, grid)                 # (Bl, f, …) shard-local
        P_all = self._gather(P_local, c_axes, dim=1)       # (Bl, c, …) every rank
        Jf, Jb, col0p = join_with_col0(backend, P_all, t.I, t.F)
        # the entry slices are strided; the phases hand the kernels
        # contiguous copies (backend._flat)
        M = backend.build_merge_packed(
            t.N, grid, Jf[:, r * f:(r + 1) * f], Jb[:, r * f:(r + 1) * f]
        )                                                  # (Bl, f, k, W)
        W = col0p.shape[-1]
        payload = torch.cat([col0p.reshape(-1), M.reshape(-1)])
        col0s = np.empty((B, W), dtype=np.int32)
        colss = np.empty((B, c, k, W), dtype=np.int32)
        for j, part in enumerate(self._gather_list(payload, tuple(b_axes) + tuple(c_axes))):
            bj, rj = divmod(j, csz)
            part = part.cpu().numpy()
            col0s[bj * Bl:(bj + 1) * Bl] = part[:Bl * W].reshape(Bl, W)
            colss[bj * Bl:(bj + 1) * Bl, rj * f:(rj + 1) * f] = part[Bl * W:].reshape(Bl, f, k, W)
        return col0s, colss

    # ------------------------------------------------- streaming join route

    def join_products(self, P: torch.Tensor):
        """Sharded-stack join, the streaming contract.

        ``P`` (c, …) is a stacked chunk-product prefix (the streaming
        cache's sealed products + tail), the same on every rank.  Each rank
        takes its rows over the chunk axes, the stack is all-gathered once,
        and the join runs replicated.  Returns (Jf, Jb, packed C₀).  The
        stack pads with identity products to a multiple of the chunk ranks:
        identities leave the entries at real indices unchanged.
        """
        eng = self.engine
        t = eng.tables
        c = int(P.shape[0])
        csz = self.chunk_devices
        c_pad = _round_up(max(c, 1), csz)
        if c_pad != c:
            eye = eng.backend.identity_product(t.ell_pad, device=P.device)
            P = torch.cat([P, eye.expand((c_pad - c,) + eye.shape)], dim=0)
        self._count_allgather(c_pad, self.chunk_axes)
        eng._note_phase_shape(("mesh_join", tuple(P.shape)))
        f = c_pad // csz
        r = linear_index(self.mesh, self.chunk_axes)
        P_all = self._gather(P[r * f:(r + 1) * f], self.chunk_axes, dim=0)
        return join_with_col0(eng.backend, P_all, t.I, t.F)

    # ---------------------------------------------------------------- parse

    def parse(self, text, n_chunks: Optional[int] = None) -> SLPF:
        """One text, the chunk dim sharded over every chunk axis.

        ``n_chunks`` rounds up to a multiple of the chunk ranks (default:
        at least 8 chunk rows in all)."""
        eng = self.engine
        csz = self.chunk_devices
        c_req = n_chunks if n_chunks is not None else max(8, csz)
        c_req = _round_up(max(1, c_req), csz)
        classes = eng.classes_of_text(text)
        c, k = eng.bucket_shape(len(classes), c_req)
        self._count_allgather(c, self.chunk_axes)
        col0s, colss = self._run(eng._pad_to(classes, c, k)[None], (), self.chunk_axes)
        return eng._assemble(col0s[0], colss[0], classes)

    def parse_batch(self, texts: Sequence, n_chunks: int = 8) -> List[SLPF]:
        """Many texts: batch slots over 'data' × chunks over 'pod'.

        The engine's grouping and bucketing; batch slots round up to a power
        of two and then to a multiple of the batch ranks, chunk counts to a
        multiple of the chunk ranks."""
        eng = self.engine
        csz = self.batch_chunk_devices
        dsz = self.batch_devices
        c_req = _round_up(max(1, n_chunks), csz)
        classes_list = [eng.classes_of_text(t) for t in texts]
        groups: dict = {}
        for i, cls in enumerate(classes_list):
            groups.setdefault(eng.bucket_shape(len(cls), c_req), []).append(i)

        results: List[Optional[SLPF]] = [None] * len(texts)
        for (c, k), idxs in sorted(groups.items()):
            B = _round_up(next_pow2(len(idxs)), dsz)
            batch = np.full((B, c, k), eng.tables.pad_class, dtype=np.int32)
            for row, i in enumerate(idxs):
                batch[row] = eng._pad_to(classes_list[i], c, k)
            self._count_allgather(B * c, self.batch_chunk_axes)
            col0s, colss = self._run(batch, self.batch_axes, self.batch_chunk_axes)
            for row, i in enumerate(idxs):
                results[i] = eng._assemble(col0s[row], colss[row], classes_list[i])
        return results  # type: ignore[return-value]
