"""Mesh construction over the ranks of a ``torch.distributed`` group.

The reference builds a ``jax.sharding.Mesh`` over the devices one
controller sees (``repro/launch/mesh.py``).  ``torch.distributed`` runs one
process a rank, each with the same Python, so the port's mesh is a value
every rank builds alike over the ranks of the initialized default process
group (``torch.distributed.device_mesh.init_device_mesh``): its axis names,
its shape, this rank's coordinate, and the process group of any tuple of
its axes.

With no process group initialized, every mesh function gives the 1-rank mesh:
each axis of size 1, no rendezvous, no environment variables, every
collective the identity — the reference's mesh over one device, whose
programs still run.

The collectives take tensors where they lie: NCCL (one rank a card) and
gloo (CPU processes, or ranks that share one card — NCCL refuses two ranks
on one device) both take tensors on the card; gloo copies them through the
host itself.

``make_production_mesh`` (the reference's 256 / 512-chip TPU shapes) waits
for the LM stack's ``launch/`` tools.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist


class ParseMesh:
    """A named mesh of ranks, as this rank sees it.

    ``axis_names`` (mesh order), ``shape`` (name → size), ``coordinate``
    (name → this rank's index), ``rank`` and ``size``; ``group(axes)`` is
    the process group of the ranks that share this rank's coordinate on
    every axis outside ``axes``, and ``members(axes)`` their global ranks in
    group-rank order.  ``device_mesh`` is the ``DeviceMesh`` behind it (None
    on the 1-rank mesh).  Building a mesh is collective: every rank must
    build the same meshes in the same order.
    """

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        shape = tuple(int(s) for s in shape)
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        if len(shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {shape} does not match axes {self.axis_names}")
        n = int(np.prod(shape))
        self.shape: Dict[str, int] = dict(zip(self.axis_names, shape))
        if dist.is_available() and dist.is_initialized():
            world = dist.get_world_size()
            if n != world:
                raise ValueError(
                    f"a mesh of {n} ranks over a process group of {world}: every rank "
                    "of the default group must hold one coordinate"
                )
            from torch.distributed.device_mesh import init_device_mesh

            self.backend: Optional[str] = str(dist.get_backend())
            device_type = "cuda" if "nccl" in self.backend else "cpu"
            self.device_mesh = init_device_mesh(
                device_type, shape, mesh_dim_names=self.axis_names
            )
            self.rank = dist.get_rank()
            self._ranks = self.device_mesh.mesh.cpu().numpy().reshape(shape)
        else:
            if n != 1:
                raise ValueError(
                    f"a mesh of {n} ranks needs an initialized process group "
                    "(torch.distributed.init_process_group)"
                )
            self.backend = None
            self.device_mesh = None
            self.rank = 0
            self._ranks = np.zeros(shape, dtype=np.int64)
        self.size = n
        self.coordinate: Dict[str, int] = self.coordinate_of(self.rank)

    def coordinate_of(self, rank: int) -> Dict[str, int]:
        """Mesh coordinate (name → index) of a global rank."""
        where = np.argwhere(self._ranks == rank)
        if len(where) != 1:
            raise ValueError(f"rank {rank} is not on this mesh")
        return dict(zip(self.axis_names, (int(i) for i in where[0])))

    def group(self, axes: Sequence[str]):
        """The process group spanning ``axes`` through this rank (None on
        the 1-rank mesh, where nothing is exchanged): one axis's group, or
        the whole group for several axes that span every rank (the parse
        mesh's ('pod', 'data'))."""
        axes = tuple(axes)
        unknown = [a for a in axes if a not in self.shape]
        if unknown or len(set(axes)) != len(axes):
            raise ValueError(f"axes {axes} are not distinct axes of {self.axis_names}")
        if self.device_mesh is None or not axes:
            return None
        if len(axes) == 1:
            return self.device_mesh.get_group(axes[0])
        if int(np.prod([self.shape[a] for a in axes])) != self.size:
            raise ValueError(
                f"a group of the axes {axes} would leave out ranks of {self.shape}: "
                "several axes make a group only where they span every rank"
            )
        return dist.group.WORLD

    def members(self, axes: Sequence[str]) -> List[int]:
        """Global ranks of ``group(axes)`` in group-rank order."""
        group = self.group(axes)
        if group is None:
            return [self.rank]
        return [int(r) for r in dist.get_process_group_ranks(group)]

    def __repr__(self) -> str:
        return f"ParseMesh({self.shape}, rank={self.rank}, backend={self.backend})"


def make_host_mesh(shape: Tuple[int, ...] = (1,), axes: Tuple[str, ...] = ("data",)) -> ParseMesh:
    """Small mesh over every rank (tests, smoke runs); a shape larger than
    the ranks there are falls back to ``(ranks,)`` over ``('data',)``."""
    n = int(np.prod(shape))
    avail = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if n > avail:
        shape, axes = (avail,), ("data",)
    return ParseMesh(shape, axes)


def make_parse_mesh(*, max_pods: int = 2) -> ParseMesh:
    """The ``('pod', 'data')`` mesh over every rank: chunks over 'pod',
    batch slots over 'data'.

    ``max_pods`` pods when the rank count divides evenly, else one pod; a
    single rank (no process group) is the (1, 1) mesh."""
    n = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    pods = max_pods if n >= max_pods and n % max_pods == 0 else 1
    return ParseMesh((pods, n // pods), ("pod", "data"))


def mesh_axes_size(mesh, axes) -> int:
    """Product of the named mesh axes' sizes (1 for the empty tuple)."""
    size = 1
    for a in axes:
        size *= mesh.shape[a]
    return size


def mesh_chips(mesh) -> int:
    """Ranks on the mesh (one card or CPU process each)."""
    return int(np.prod(list(mesh.shape.values())))
