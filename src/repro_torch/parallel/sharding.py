"""Logical-axis sharding rules over a mesh: the parser's part.

Every tensor dim the parser distributes is named by a *logical* axis;
``MeshRules`` maps it to physical mesh axes.  The parse mesh is
``('pod', 'data')`` (``launch/mesh.py``): the logical 'chunk' axis takes
both, 'batch' takes both too, and the batched route restricts 'batch' to
'data' so that the chunk dim keeps 'pod' (``core/distributed.py``).

The default table is the reference's whole table (``repro/parallel/
sharding.py``), model axes included, so that a rule named in a config
resolves the same in both packages:

  batch   → ('pod', 'data')     data parallel over pods × data
  fsdp    → 'data'              parameter sharding
  heads / kv_heads / mlp / vocab / experts / expert_mlp / cache_seq → 'model'
  seq, embed, d_state, stack → None (replicated)
  chunk   → ('pod', 'data')     the parser's chunk axis

A logical axis resolving to a mesh axis already used by another dim of the
same tensor is dropped (replicated): a spec's axes are disjoint.

``PartitionSpec`` is the port's own small immutable value: one entry per
tensor dim (None, one axis name, or a tuple of them), trailing Nones
trimmed, as ``resolve`` builds it; ``NamedSharding`` pairs one with its mesh.

The model half (``logical_sharding``, ``constrain``, ``adapt_rules_for``)
resolves the LM stack's logical axes as the reference does, and places
tensors on a mesh of several ranks as DTensors (``torch.distributed.tensor``,
the counterpart of GSPMD's sharded arrays): ``placements`` turns a spec into
one DTensor placement per mesh axis, and ``place`` (``constrain``) lays a
tensor out by it — a DTensor by ``redistribute`` (FSDP's gather at use is a
redistribute that drops 'data', its backward the reduce-scatter; a
replicated weight's gradient, partial over the data ranks, is all-reduced
the same way), a plain tensor that every rank holds whole by cutting out the
rank's shard.  On a mesh of one rank nothing becomes a DTensor and
``constrain`` is the identity (the reference replicates there too).
``write_slot`` and ``assign`` are the in-place cache writes of decoding,
done on each rank's own shard.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

Axis = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """Per-dim mesh axes of one tensor: ``PartitionSpec('pod', None,
    ('pod', 'data'))``.  A tuple, so equal specs compare and hash equal."""

    def __new__(cls, *entries: Axis) -> "PartitionSpec":
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


@dataclass(frozen=True)
class MeshRules:
    """Logical-axis → mesh-axis mapping."""

    rules: Dict[str, Axis] = field(
        default_factory=lambda: {
            "batch": ("pod", "data"),
            "fsdp": "data",
            "heads": "model",
            "kv_heads": "model",
            "mlp": "model",
            "vocab": "model",
            "experts": "model",
            "expert_mlp": "model",
            "d_state": None,
            "embed": None,
            "seq": None,
            "cache_seq": "model",
            "chunk": ("pod", "data"),
            "stack": None,
        }
    )

    def resolve(self, logical: Sequence[Axis], mesh=None) -> PartitionSpec:
        """Map per-dim logical names to a ``PartitionSpec``, dropping mesh
        axes that are absent from ``mesh`` or already used by an earlier
        dim."""
        used: set = set()
        out = []
        avail = set(mesh.axis_names) if mesh is not None else None
        for name in logical:
            ax = self.rules.get(name, None) if isinstance(name, str) else name
            if ax is None:
                out.append(None)
                continue
            axes = (ax,) if isinstance(ax, str) else tuple(ax)
            axes = tuple(a for a in axes if a not in used and (avail is None or a in avail))
            used.update(axes)
            out.append(axes if len(axes) > 1 else (axes[0] if axes else None))
        while out and out[-1] is None:
            out.pop()
        return PartitionSpec(*out)

    def resolve_axes(self, name: str, mesh=None) -> Tuple[str, ...]:
        """Flat mesh axes ONE logical axis maps to on ``mesh`` (() =
        replicated): the axes a collective runs over, in ``linear_index``
        order."""
        return spec_axes(self.resolve((name,), mesh), 0)

    def with_overrides(self, **kw: Axis) -> "MeshRules":
        d = dict(self.rules)
        d.update(kw)
        return MeshRules(rules=d)


def spec_axes(spec: PartitionSpec, dim: int) -> Tuple[str, ...]:
    """Flat mesh axes assigned to one dim of a spec; () for a replicated
    dim, including dims past the spec's trimmed trailing Nones."""
    entries = tuple(spec)
    if dim >= len(entries) or entries[dim] is None:
        return ()
    e = entries[dim]
    return (e,) if isinstance(e, str) else tuple(e)


def divisible(n: int, mesh, axis: Optional[Axis]) -> bool:
    """Is dimension ``n`` divisible by the product of the given mesh axes
    (axes absent from ``mesh`` count 1)?"""
    if axis is None:
        return True
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    size = 1
    for a in axes:
        if a in mesh.axis_names:
            size *= mesh.shape[a]
    return n % size == 0


@dataclass(frozen=True)
class NamedSharding:
    """A ``PartitionSpec`` on a mesh (the reference's ``jax.sharding`` value)."""

    mesh: object
    spec: PartitionSpec


def logical_sharding(mesh, rules: MeshRules, logical: Sequence[Axis]) -> NamedSharding:
    return NamedSharding(mesh, rules.resolve(logical, mesh))


def placements(spec: PartitionSpec, mesh) -> list:
    """The DTensor placement of each axis of ``mesh`` (mesh order) for
    ``spec``: ``Shard(d)`` where the axis appears at tensor dim d, else
    ``Replicate()``.  A multi-axis entry such as ('pod', 'data') shards its
    dim on each of its axes; DTensor splits the dim over them in mesh order,
    the row-major order of the reference's entry, so the entry's axes must
    come in mesh order.  An axis of size 1 splits nothing: ``Replicate()``
    (the same layout, and one DTensor reshapes freely)."""
    from torch.distributed.tensor import Replicate, Shard

    order = list(mesh.axis_names)
    where: Dict[str, int] = {}
    for d in range(len(spec)):
        axes = spec_axes(spec, d)
        if [order.index(a) for a in axes] != sorted(order.index(a) for a in axes):
            raise ValueError(f"spec entry {axes} is not in the mesh's axis order {order}")
        where.update({a: d for a in axes})
    return [Shard(where[a]) if a in where and mesh.shape[a] > 1 else Replicate()
            for a in order]


def place(t: torch.Tensor, mesh, spec: PartitionSpec):
    """``t`` as a DTensor on ``mesh`` laid out by ``spec``.  A DTensor is
    redistributed (the collectives its placements need); a plain tensor,
    which every rank holds whole and alike, is cut to this rank's shard with
    no collective, the shard copied so that ``t`` can be freed.  Both are
    differentiable."""
    from torch.distributed.tensor import DTensor, Replicate

    want = placements(spec, mesh)
    if isinstance(t, DTensor):
        return t.redistribute(t.device_mesh, want)
    dm = mesh.device_mesh_for(t.device.type)
    out = DTensor.from_local(t, dm, [Replicate()] * dm.ndim, run_check=False)
    out = out.redistribute(dm, want)
    if any(p.is_shard() for p in want):
        out = DTensor.from_local(out.to_local().clone(), dm, want, run_check=False,
                                 shape=out.shape, stride=out.stride())
    return out


def constrain(x, mesh, rules: MeshRules, logical: Sequence[Axis]):
    """Place ``x`` by its logical axes (``place``): the identity on a mesh of
    one rank."""
    from ..launch.mesh import mesh_chips

    if mesh_chips(mesh) == 1:
        return x
    return place(x, mesh, logical_sharding(mesh, rules, logical).spec)


def local_range(shape: Sequence[int], device_mesh, places, dim: int) -> Tuple[int, int]:
    """[lo, hi) of tensor dim ``dim`` that this rank holds under ``places``
    (DTensor's split: each mesh axis that shards the dim, in mesh order,
    cuts the part left into ``ceil(n / size)``-long chunks)."""
    lo, n = 0, shape[dim]
    for i, p in enumerate(places):
        if p.is_shard(dim):
            size, coord = device_mesh.size(i), device_mesh.get_local_rank(i)
            chunk = -(-n // size)
            start = min(coord * chunk, n)
            lo, n = lo + start, min(chunk, n - start)
    return lo, lo + n


def whole_dim(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` with dim ``dim`` whole on every rank: a DTensor's mesh axes that
    split it gathered (the rest of its layout kept); a plain tensor as it
    is."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(t, DTensor):
        return t
    dim %= t.ndim
    return t.redistribute(t.device_mesh,
                          [Replicate() if p.is_shard(dim) else p for p in t.placements])


def write_slot(t: torch.Tensor, dim: int, index: int, value) -> None:
    """``t.select(dim, index)[...] = value`` in place.  On a DTensor the ranks
    whose shard holds the slot write it into their local tensor; a DTensor
    ``value`` (laid out like the slot) is first replicated on the mesh axes
    that split ``dim``, a plain one is the whole slot."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(t, DTensor):
        t.select(dim, index).copy_(value)
        return
    if isinstance(value, DTensor):
        slot_places = [Replicate() if p.is_shard(dim) else
                       (type(p)(p.dim - 1) if p.is_shard() and p.dim > dim else p)
                       for p in t.placements]
        value = value.redistribute(t.device_mesh, slot_places).to_local()
    lo, hi = local_range(t.shape, t.device_mesh, t.placements, dim)
    if lo <= index < hi:
        with torch.no_grad():
            t.to_local().select(dim, index - lo).copy_(value)


def assign(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst[...] = src`` in place; on DTensors ``src`` is first laid out as
    ``dst``, and each rank copies its own shard."""
    from torch.distributed.tensor import DTensor

    if isinstance(dst, DTensor):
        src = src.redistribute(dst.device_mesh, dst.placements).to_local()
        with torch.no_grad():
            dst.to_local().copy_(src)
        return
    dst.copy_(src)


def adapt_rules_for(cfg, mesh, rules: MeshRules) -> MeshRules:
    """Drop shardings that do not divide this model's dimensions (GQA kv heads,
    expert counts, vocab remainders) — replication is the exact fallback.

    Head counts are checked AFTER zero-padding (HeadPlan): query heads pad to
    the TP multiple, so 'heads' stays sharded for e.g. 14→16 or 40→48."""
    from ..models.layers import HeadPlan
    from ..models.mamba import ssm_dims

    overrides: Dict[str, Axis] = {}
    tp = mesh.shape.get("model", 1)
    plan = HeadPlan.plan(cfg.n_heads, cfg.n_kv_heads, tp)
    if not divisible(plan.pad_kv, mesh, rules.rules.get("kv_heads")):
        overrides["kv_heads"] = None
    if not divisible(plan.pad_q, mesh, rules.rules.get("heads")):
        overrides["heads"] = None
    if cfg.moe is not None:
        if not divisible(cfg.moe.n_experts, mesh, rules.rules.get("experts")):
            # expert dim replicated; shard each expert's hidden dim instead
            overrides["experts"] = None
        else:
            # expert-parallel: the expert hidden dim must then stay unsharded
            overrides["expert_mlp"] = None
    if not divisible(cfg.vocab_size, mesh, rules.rules.get("vocab")):
        overrides["vocab"] = None
    # the 'mlp' rule shards FFN hidden dims AND the SSM projection dims; it
    # must survive for attention-free archs (d_ff == 0) — test what it shards.
    mlp_dims = [cfg.d_ff] if cfg.d_ff else []
    if cfg.ssm is not None:
        dims = ssm_dims(cfg.d_model, cfg.ssm)
        in_dim = 2 * dims["d_inner"] + 2 * cfg.ssm.n_groups * cfg.ssm.d_state + dims["n_heads"]
        mlp_dims += [dims["d_inner"], dims["conv_dim"], in_dim]
    if any(not divisible(d, mesh, rules.rules.get("mlp")) for d in mlp_dims):
        overrides["mlp"] = None
    return rules.with_overrides(**overrides) if overrides else rules
