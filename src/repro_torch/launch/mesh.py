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
host itself.  DTensors (the LM stack's training and serve steps on a mesh)
need a ``DeviceMesh`` of their tensors' device type: ``device_mesh_for``
builds it.  Gloo's functional collectives, which DTensor calls, crash on
tensors on the card (PyTorch 2.11, an H100: a segmentation fault in
``wait_tensor``), so a gloo mesh for tensors on the card runs them through
the host instead (``host_staged_collectives``, which counts the calls and
the bytes each rank sends in ``STAGED_TRAFFIC``).

``make_production_mesh`` gives the reference's production shapes, (16, 16)
('data', 'model') and (2, 16, 16) ('pod', 'data', 'model'), in one process:
it initializes PyTorch's fake process group of 256 or 512 ranks (this
process is rank 0; every collective returns at once and moves nothing), the
counterpart of the reference's 512 placeholder XLA host devices.  A mesh
over the fake group is the dry-run's (``launch/dryrun.py``): its
``DeviceMesh`` is of the card's type, as the production mesh's would be,
and it places tensors with no storage (the meta device), whose programs are
traced and never run.
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
            if self.backend == "fake":
                # the card's type without needing a card: no device is set
                from torch.distributed.device_mesh import DeviceMesh

                self.device_mesh = DeviceMesh(
                    "cuda", np.arange(n).reshape(shape), mesh_dim_names=self.axis_names
                )
            else:
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
        self._device_meshes: Dict[str, object] = {}

    def device_mesh_for(self, device_type: str):
        """The ``DeviceMesh`` of this mesh for tensors on ``device_type``
        ("cpu" or "cuda"): the mesh's own where the types agree, else one
        built once, over the same ranks and axis names (collective: every
        rank asks for it in the same order).  A gloo mesh for tensors on the
        card installs ``host_staged_collectives`` first.  A mesh over the
        fake process group places meta tensors (and the card's) on its own
        ``DeviceMesh``, and tensors of any other type on one of theirs."""
        if self.device_mesh is None:
            raise ValueError("the 1-rank mesh places no DTensor")
        if self.device_mesh.device_type == device_type or (
            self.backend == "fake" and device_type == "meta"
        ):
            return self.device_mesh
        if device_type not in self._device_meshes:
            fake = self.backend == "fake"
            if not fake and (device_type != "cuda" or "gloo" not in self.backend):
                raise ValueError(f"a {self.backend} mesh carries no {device_type} tensors")
            from torch.distributed.device_mesh import DeviceMesh

            if not fake:
                host_staged_collectives()
            self._device_meshes[device_type] = DeviceMesh(
                device_type, self.device_mesh.mesh, mesh_dim_names=self.axis_names
            )
        return self._device_meshes[device_type]

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
        if int(np.prod([self.shape[a] for a in axes])) == self.size:
            return dist.group.WORLD
        if self.backend != "fake":
            raise ValueError(
                f"a group of the axes {axes} would leave out ranks of {self.shape}: "
                "several axes make a group only where they span every rank"
            )
        # the production mesh's chunk axes ('pod', 'data') beside 'model':
        # their flattened sub-mesh's group
        return self.device_mesh[axes]._flatten().get_group()

    def members(self, axes: Sequence[str]) -> List[int]:
        """Global ranks of ``group(axes)`` in group-rank order."""
        group = self.group(axes)
        if group is None:
            return [self.rank]
        return [int(r) for r in dist.get_process_group_ranks(group)]

    def __repr__(self) -> str:
        return f"ParseMesh({self.shape}, rank={self.rank}, backend={self.backend})"


_STAGED: list = []
STAGED_TRAFFIC: Dict[str, Dict[str, int]] = {}   # op → calls, bytes this rank sent
_REDUCE_OPS = {"sum": "SUM", "avg": "SUM", "max": "MAX", "min": "MIN", "product": "PRODUCT"}


def host_staged_collectives(key: str = "CUDA") -> None:
    """Run the functional collectives (``torch.ops._c10d_functional``, what
    DTensor calls) on tensors on the card through the host, over gloo: each
    copies its input to the host, runs gloo's collective there and copies
    the result back; ``wait_tensor`` has nothing left to wait for.
    Installed once per process, for the dispatch key ``key`` only (the
    tests install it for "CPU" to run it there), so it is for processes
    whose every group is gloo (ranks sharing one card): an NCCL group's
    functional collectives would go through the host too."""
    if _STAGED:
        return
    import torch
    from torch.distributed.distributed_c10d import _resolve_process_group

    def host(t):
        return t.detach().to("cpu", copy=True).contiguous()

    def reduce(t, op, group):
        dist.all_reduce(t, getattr(dist.ReduceOp, _REDUCE_OPS[op.lower()]), group=group)
        if op.lower() == "avg":
            t /= dist.get_world_size(group)
        return t

    def all_gather_into_tensor(inp, group_size, group_name):
        h = host(inp)
        out = torch.empty((group_size * h.shape[0], *h.shape[1:]), dtype=h.dtype)
        dist.all_gather_into_tensor(out, h, group=_resolve_process_group(group_name))
        return out.to(inp.device)

    def reduce_scatter_tensor(inp, reduce_op, group_size, group_name):
        group = _resolve_process_group(group_name)
        h = host(inp)
        out = torch.empty((h.shape[0] // group_size, *h.shape[1:]), dtype=h.dtype)
        dist.reduce_scatter_tensor(out, h, getattr(dist.ReduceOp, _REDUCE_OPS[reduce_op.lower()]),
                                   group=group)
        if reduce_op.lower() == "avg":
            out /= group_size
        return out.to(inp.device)

    def all_reduce(inp, reduce_op, group_name):
        return reduce(host(inp), reduce_op, _resolve_process_group(group_name)).to(inp.device)

    def all_to_all_single(inp, output_split_sizes, input_split_sizes, group_name):
        group = _resolve_process_group(group_name)
        h = host(inp)
        n_out = sum(output_split_sizes) if output_split_sizes else h.shape[0]
        out = torch.empty((n_out, *h.shape[1:]), dtype=h.dtype)
        dist.all_to_all_single(out, h, list(output_split_sizes) or None,
                               list(input_split_sizes) or None, group=group)
        return out.to(inp.device)

    def counted(name, fn):
        def run(inp, *args):
            seen = STAGED_TRAFFIC.setdefault(name, {"calls": 0, "bytes": 0})
            seen["calls"] += 1
            seen["bytes"] += inp.numel() * inp.element_size()
            return fn(inp, *args)
        return run

    lib = torch.library.Library("_c10d_functional", "IMPL")
    for name, fn in (("all_gather_into_tensor", all_gather_into_tensor),
                     ("reduce_scatter_tensor", reduce_scatter_tensor),
                     ("all_reduce", all_reduce), ("all_to_all_single", all_to_all_single)):
        lib.impl(name, counted(name, fn), key)
    lib.impl("wait_tensor", lambda t: t, key)
    _STAGED.append(lib)


PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False) -> ParseMesh:
    """The reference's production mesh: (16, 16) ('data', 'model'), or
    (2, 16, 16) ('pod', 'data', 'model') with ``multi_pod``, over the fake
    process group of 256 or 512 ranks, which this initializes (rank 0)
    when no group is, or in place of a fake group of the other size.  A
    real group raises: it runs programs, and the production mesh is only
    traced."""
    shape, axes = PRODUCTION[bool(multi_pod)]
    n = int(np.prod(shape))
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise ValueError(
                f"the production mesh needs the fake process group of {n} ranks, but a "
                f"{dist.get_backend()} group of {dist.get_world_size()} is initialized"
            )
        if dist.get_world_size() != n:
            dist.destroy_process_group()
    if not dist.is_initialized():
        from torch.testing._internal.distributed.fake_pg import FakeStore

        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    return ParseMesh(shape, axes)


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
