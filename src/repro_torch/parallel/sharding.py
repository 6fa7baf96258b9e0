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
trimmed, as ``resolve`` builds it.  Placing model tensors by these rules
(``logical_sharding``, ``constrain``, ``adapt_rules_for``) belongs to the
LM stack's distribution and is not here.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple, Union

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
